"""The two MikuDance UNets.

Port of ``mikudance_tpu/models/unet.py``, in the reference checkpoint's key
grammar (``down_blocks.{i}.resnets.{j}``, ``.attentions.{j}``,
``.motion_modules.{j}``, ``man_blocks.{i}``, ``mid_block``, ``up_blocks``):

- ``GuidanceUNet``: the reference/guidance encoder ("MIX", reference
  ``unet_2d_mix.py``): a 2-D SD1.5-geometry UNet whose conv_in takes the
  20-channel condition stack, with a MAN block after every down block, and
  whose only output is the per-transformer-block attention banks (its
  ``conv_out`` is disabled in the reference, `unet_2d_mix.py:1371-1375`).
- ``DenoisingUNet``: the 3-D denoising UNet (reference ``unet_3d_mix.py``):
  SD1.5 with frames folded into the batch and an AnimateDiff motion module
  after every attention/resnet layer, reading the banks as precomputed K/V.

Banks are keyed by structural position (``down_i_j`` / ``mid`` / ``up_i_j``),
which is how the reference pairs writer and reader blocks for two UNets of
the same topology (`mutual_mix_attention.py:299-301`).

Layout: NHWC images; video tensors (B, T, H, W, C).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from ..core.configs import DenoisingUNetConfig, GuidanceUNetConfig, UNetConfig
from .layers import GroupNorm, SpatialTransformer, TimestepEmbed, get_timestep_embedding
from .man import MANBlock
from .motion_module import MotionModule
from .resnet import Downsample, ResnetBlock, Upsample, conv3x3, conv_nhwc

KV = Tuple[torch.Tensor, torch.Tensor]


def bank_keys(cfg: UNetConfig) -> list:
    """Structural keys of all spatial transformer blocks, in network order."""
    keys = []
    n = cfg.num_blocks
    for i in range(n - 1):  # cross-attn down blocks (last down block is plain)
        for j in range(cfg.layers_per_block):
            keys.append(f"down_{i}_{j}")
    keys.append("mid")
    for i in range(1, n):  # up block 0 is plain
        for j in range(cfg.layers_per_block + 1):
            keys.append(f"up_{i}_{j}")
    return keys


def _up_block_channels(cfg: UNetConfig, i: int):
    """(prev_output, output, skip_input) channels of up block i (diffusers logic)."""
    rev = list(reversed(cfg.block_out_channels))
    return rev[max(i - 1, 0)], rev[i], rev[min(i + 1, len(rev) - 1)]


class _Block(nn.Module):
    """A down/up block container; attribute names are the checkpoint's."""


class _UNetBody(nn.Module):
    """The SD1.5 wiring both UNets share: conv_in, time embedding, down /
    mid / up blocks with skips. Optional parts: motion modules (denoiser),
    MAN blocks (guidance), the output head (denoiser)."""

    def __init__(self, u: UNetConfig, in_channels: int, motion=None,
                 man_hidden: Optional[int] = None, motion_channels: int = 2,
                 out_head: bool = True):
        super().__init__()
        ch, n, L = u.block_out_channels, u.num_blocks, u.layers_per_block
        self.u = u
        temb = u.time_embed_dim
        groups, eps, heads = u.norm_num_groups, u.norm_eps, u.attention_heads
        self.with_motion = motion is not None and motion.enabled
        self.motion_mid = self.with_motion and motion.mid_block

        def mm(dim):
            return MotionModule(dim, motion.num_attention_heads, motion.num_transformer_blocks,
                                motion.attention_layers_per_block,
                                motion.temporal_position_encoding_max_len,
                                motion.temporal_position_encoding, groups)

        def st(dim):
            return SpatialTransformer(dim, heads, u.cross_attention_dim, groups)

        self.conv_in = conv3x3(in_channels, ch[0])
        self.time_embedding = TimestepEmbed(ch[0], temb)

        skips, cur = [ch[0]], ch[0]
        self.down_blocks = nn.ModuleList()
        for i in range(n):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            if i < n - 1:
                blk.attentions = nn.ModuleList()
            if self.with_motion:
                blk.motion_modules = nn.ModuleList()
            for _ in range(L):
                blk.resnets.append(ResnetBlock(cur, ch[i], temb, groups, eps))
                cur = ch[i]
                if i < n - 1:
                    blk.attentions.append(st(ch[i]))
                if self.with_motion:
                    blk.motion_modules.append(mm(ch[i]))
                skips.append(cur)
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Downsample(ch[i])])
                skips.append(cur)
            self.down_blocks.append(blk)
        if man_hidden is not None:
            self.man_blocks = nn.ModuleList(
                [MANBlock(ch[i], motion_channels, man_hidden) for i in range(n)])

        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock(ch[-1], ch[-1], temb, groups, eps) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([st(ch[-1])])
        if self.motion_mid:
            self.mid_block.motion_modules = nn.ModuleList([mm(ch[-1])])

        self.up_blocks = nn.ModuleList()
        for i in range(n):
            _, out_ch, _ = _up_block_channels(u, i)
            blk = _Block()
            blk.resnets = nn.ModuleList()
            if i > 0:
                blk.attentions = nn.ModuleList()
            if self.with_motion:
                blk.motion_modules = nn.ModuleList()
            for _ in range(L + 1):
                blk.resnets.append(ResnetBlock(cur + skips.pop(), out_ch, temb, groups, eps))
                cur = out_ch
                if i > 0:
                    blk.attentions.append(st(out_ch))
                if self.with_motion:
                    blk.motion_modules.append(mm(out_ch))
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Upsample(out_ch)])
            self.up_blocks.append(blk)

        if out_head:
            self.conv_norm_out = GroupNorm(groups, ch[0], eps, silu=True)
            self.conv_out = conv3x3(ch[0], u.out_channels)

    def attention(self, key: str) -> SpatialTransformer:
        """Structural bank key -> the spatial transformer holding it."""
        if key == "mid":
            return self.mid_block.attentions[0]
        kind, i, j = key.split("_")
        blocks = self.down_blocks if kind == "down" else self.up_blocks
        return blocks[int(i)].attentions[int(j)]

    def run(self, x: torch.Tensor, timesteps: torch.Tensor, context, frames: int = 1,
            write: bool = False, motion_map: Optional[torch.Tensor] = None,
            banks_kv: Optional[Dict[str, KV]] = None,
            ctx_kv: Optional[Dict[str, KV]] = None):
        """x: (B*frames, H, W, C_in) NHWC. Returns (h, banks)."""
        u = self.u
        dtype = self.conv_in.weight.dtype
        banks: Dict[str, torch.Tensor] = {}
        t_emb = get_timestep_embedding(timesteps, u.block_out_channels[0],
                                       u.flip_sin_to_cos, u.freq_shift).to(dtype)
        temb = self.time_embedding(t_emb).repeat_interleave(frames, dim=0)
        ctx = None if context is None else context.to(dtype).repeat_interleave(frames, dim=0)

        def motion(mod, h):
            BT, hh, ww, c = h.shape
            return mod(h.reshape(BT // frames, frames, hh, ww, c)).reshape(BT, hh, ww, c)

        def attn(key, h):
            kv = None
            if ctx_kv is not None:
                k, v = ctx_kv[key]
                kv = (k.repeat_interleave(frames, dim=0), v.repeat_interleave(frames, dim=0))
            ref = None if banks_kv is None else banks_kv[key]
            h, bank = self.attention(key)(h, ctx, write=write, ref_kv=ref, ctx_kv=kv)
            if write:
                banks[key] = bank
            return h

        h = conv_nhwc(self.conv_in, x.to(dtype))
        skips = [h]
        for i, blk in enumerate(self.down_blocks):
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if hasattr(blk, "attentions"):
                    h = attn(f"down_{i}_{j}", h)
                if self.with_motion:
                    h = motion(blk.motion_modules[j], h)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)
            if hasattr(self, "man_blocks") and motion_map is not None:
                # MAN modulates only the main path, after the whole down block
                # (unet_2d_mix.py:1288); skip tensors are untouched.
                h = self.man_blocks[i](h, motion_map)

        h = self.mid_block.resnets[0](h, temb)
        h = attn("mid", h)
        if self.motion_mid:
            h = motion(self.mid_block.motion_modules[0], h)
        h = self.mid_block.resnets[1](h, temb)

        for i, blk in enumerate(self.up_blocks):
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=-1), temb)
                if hasattr(blk, "attentions"):
                    h = attn(f"up_{i}_{j}", h)
                if self.with_motion:
                    h = motion(blk.motion_modules[j], h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return h, banks


class GuidanceUNet(_UNetBody):
    """Writes the reference-attention banks; t=0 in the reference."""

    def __init__(self, cfg: GuidanceUNetConfig = GuidanceUNetConfig()):
        super().__init__(cfg.unet, cfg.cond_channels,
                         man_hidden=cfg.man_hidden if cfg.use_man else None,
                         motion_channels=cfg.motion_channels, out_head=False)
        self.cfg = cfg

    def forward(self, cond: torch.Tensor, motion_map: Optional[torch.Tensor],
                timesteps: torch.Tensor, context: torch.Tensor) -> Dict[str, torch.Tensor]:
        """cond: (B, H, W, 20); motion_map: (B, H, W, 2) or None;
        context: (B, S, 768). Returns {bank key: (B, S_l, C_l)}."""
        _, banks = self.run(cond, timesteps, context, write=True,
                            motion_map=motion_map if self.cfg.use_man else None)
        return banks


class DenoisingUNet(_UNetBody):
    def __init__(self, cfg: DenoisingUNetConfig = DenoisingUNetConfig()):
        super().__init__(cfg.unet, cfg.unet.in_channels, motion=cfg.motion)
        self.cfg = cfg

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                banks_kv: Optional[Dict[str, KV]] = None,
                ctx_kv: Optional[Dict[str, KV]] = None) -> torch.Tensor:
        """sample: (B, T, H, W, 4); timesteps: (B,); context: (B, S, 768),
        unused where ``ctx_kv`` (each (B, S, C_l)) is given; banks_kv: each
        (B*T, S_l, C_l). Returns (B, T, H, W, 4)."""
        B, T = sample.shape[:2]
        h, _ = self.run(sample.reshape((B * T,) + sample.shape[2:]), timesteps, context,
                        frames=T, banks_kv=banks_kv, ctx_kv=ctx_kv)
        h = conv_nhwc(self.conv_out, self.conv_norm_out(h))
        return h.reshape((B, T) + h.shape[1:])


def precompute_reference_kv(den: DenoisingUNet, banks: Dict[str, torch.Tensor],
                            dtype=torch.bfloat16) -> Dict[str, KV]:
    """Banks projected through each reader block's own attn1 K/V weights.

    The reference injection is additive on the K/V input — ``kv = norm_h +
    ref`` (`mutual_mix_attention.py:169-180`); by linearity ``W(norm_h +
    ref) = W(norm_h) + W(ref)``, and ``W(ref)`` depends only on the t=0
    condition stack, so it is computed once per clip here."""
    out = {}
    for key, bank in banks.items():
        attn = den.attention(key).block.attn1
        b = bank.to(dtype)
        out[key] = (b @ attn.to_k.weight.to(dtype).T, b @ attn.to_v.weight.to(dtype).T)
    return out


def precompute_context_kv(den: DenoisingUNet, context: torch.Tensor, keys: Iterable[str],
                          dtype=torch.bfloat16) -> Dict[str, KV]:
    """Cross-attention K/V of the CLIP context, per reader block: the context
    never changes across denoise steps, so each attn2's K/V are computed
    once. ``context``: (B, S, 768); the per-frame repeat happens in the UNet."""
    out = {}
    c = context.to(dtype)
    for key in keys:
        attn = den.attention(key).block.attn2
        out[key] = (c @ attn.to_k.weight.to(dtype).T, c @ attn.to_v.weight.to(dtype).T)
    return out
