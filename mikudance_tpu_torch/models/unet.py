"""The two MikuDance UNets.

Port of ``mikudance_tpu/models/unet.py``, in the reference checkpoint's key
grammar (``down_blocks.{i}.resnets.{j}``, ``.attentions.{j}``,
``.motion_modules.{j}``, ``man_blocks.{i}``, ``mid_block``, ``up_blocks``):

- ``GuidanceUNet``: the reference/guidance encoder ("MIX", reference
  ``unet_2d_mix.py``): a 2-D UNet (SD1.5's or SDXL's geometry, from its
  ``UNetConfig``) whose conv_in takes the
  20-channel condition stack, with a MAN block after every down block, and
  whose only output is the per-transformer-block attention banks (its
  ``conv_out`` is disabled in the reference, `unet_2d_mix.py:1371-1375`).
- ``DenoisingUNet``: the 3-D denoising UNet (reference ``unet_3d_mix.py``):
  SD1.5 with frames folded into the batch and an AnimateDiff motion module
  after every attention/resnet layer, reading the banks as precomputed K/V
  (``banks_kv``) or raw (``banks``).

Banks are keyed by structural position (``down_i_j`` / ``mid`` / ``up_i_j``,
and ``.b`` after it for block b of a transformer that stacks several, as
SDXL's do), one bank a transformer block, which is how the reference pairs
writer and reader blocks for two UNets of the same topology
(`mutual_mix_attention.py:299-301`).

Layout: NHWC images; video tensors (B, T, H, W, C).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from ..core.configs import (SD15_UNET, DenoisingUNetConfig, GuidanceUNetConfig, UNetConfig,
                            unet_config)
from ..core.mesh import Axis
from ..utils.profiling import span
from .layers import (GroupNorm, SpatialTransformer, TimestepEmbed, TransformerBlock,
                     get_timestep_embedding, remat_call)
from .man import MANBlock
from .motion_module import MotionModule
from .resnet import Downsample, ResnetBlock, Upsample, conv3x3, conv_nhwc

KV = Tuple[torch.Tensor, torch.Tensor]


def transformer_keys(cfg: UNetConfig) -> list:
    """Structural keys of all spatial transformers, in network order: the
    down blocks of the levels with attention (SD1.5: every level but the
    last), the mid block, the up blocks (up block i is level n - 1 - i)."""
    cfg = unet_config(cfg)
    keys = []
    n = cfg.num_blocks
    for i in range(n):
        if cfg.has_attention(i):
            keys += [f"down_{i}_{j}" for j in range(cfg.layers_per_block)]
    keys.append("mid")
    for i in range(n):
        if cfg.has_attention(n - 1 - i):
            keys += [f"up_{i}_{j}" for j in range(cfg.layers_per_block + 1)]
    return keys


def key_level(cfg: UNetConfig, key: str) -> int:
    """The level (0 = full latent size) of a transformer key."""
    cfg = unet_config(cfg)
    if key == "mid":
        return cfg.num_blocks - 1
    kind, i, _ = key.split("_")
    return int(i) if kind == "down" else cfg.num_blocks - 1 - int(i)


def block_keys(cfg: UNetConfig, key: str) -> list:
    """Bank keys of the blocks of transformer ``key``: the key itself for a
    one-block transformer (SD1.5), else ``key.b`` for block b."""
    cfg = unet_config(cfg)
    depth = cfg.depth(key_level(cfg, key))
    return [key] if depth == 1 else [f"{key}.{b}" for b in range(depth)]


def bank_keys(cfg: UNetConfig) -> list:
    """Structural keys of all transformer blocks, in network order: one bank
    a block (SD1.5: 16, SDXL: 70)."""
    return [bk for key in transformer_keys(cfg) for bk in block_keys(cfg, key)]


def bank_elements(cfg: UNetConfig, h: int, w: int) -> int:
    """Elements of one (window, position)'s banks at an (h, w) latent: every
    transformer block's (S_l, C_l), a level's map halved (rounded up) per level."""
    cfg = unet_config(cfg)
    ch = cfg.block_out_channels
    total = 0
    for key in transformer_keys(cfg):
        lv = key_level(cfg, key)
        side = ((h + (1 << lv) - 1) >> lv) * ((w + (1 << lv) - 1) >> lv)
        total += len(block_keys(cfg, key)) * side * ch[lv]
    return total


def bank_position_budget(positions: int, cfg: UNetConfig, h: int, w: int) -> int:
    """A budget of ``positions`` SD1.5 positions (``PipelineConfig.cached_bank_positions``)
    in positions of ``cfg``'s banks at an (h, w) latent: the bytes of that many
    SD1.5 positions' banks over the bytes of one of ``cfg``'s, never more
    than ``positions`` (SD1.5 itself, and smaller UNets, keep the count as
    given; SDXL's 70 blocks, 2.3 times the bytes, get 84 of 192)."""
    return max(1, min(positions, positions * bank_elements(SD15_UNET, h, w)
                      // bank_elements(cfg, h, w)))


def _up_block_channels(cfg: UNetConfig, i: int):
    """(prev_output, output, skip_input) channels of up block i (diffusers logic)."""
    rev = list(reversed(cfg.block_out_channels))
    return rev[max(i - 1, 0)], rev[i], rev[min(i + 1, len(rev) - 1)]


class _Block(nn.Module):
    """A down/up block container; attribute names are the checkpoint's."""


class _UNetBody(nn.Module):
    """The wiring both UNets share: conv_in, time embedding (plus SDXL's
    added conditioning), down / mid / up blocks with skips, spatial
    transformers at the configuration's levels. Optional parts: motion
    modules (denoiser) at the levels ``motion.resolutions`` names, MAN blocks
    (guidance), the output head (denoiser). ``remat`` (training) recomputes
    every resnet block, spatial transformer and motion module in the backward
    instead of keeping its activations."""

    def __init__(self, u: UNetConfig, in_channels: int, motion=None,
                 man_hidden: Optional[int] = None, motion_channels: int = 2,
                 out_head: bool = True, remat: bool = False):
        super().__init__()
        self.remat = remat
        u = unet_config(u)
        ch, n, L = u.block_out_channels, u.num_blocks, u.layers_per_block
        self.u = u
        temb = u.time_embed_dim
        groups, eps = u.norm_num_groups, u.norm_eps
        self.with_motion = motion is not None and motion.enabled
        self.motion_mid = self.with_motion and motion.mid_block
        motion_levels = [self.with_motion and (1 << i) in motion.resolutions for i in range(n)]

        def mm(dim):
            return MotionModule(dim, motion.num_attention_heads, motion.num_transformer_blocks,
                                motion.attention_layers_per_block,
                                motion.temporal_position_encoding_max_len,
                                motion.temporal_position_encoding, groups, remat)

        def st(dim, level, depth):
            return SpatialTransformer(dim, u.heads(level), u.cross_attention_dim, groups, remat,
                                      depth, u.use_linear_projection)

        self.conv_in = conv3x3(in_channels, ch[0])
        self.time_embedding = TimestepEmbed(ch[0], temb)
        if u.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbed(u.projection_class_embeddings_input_dim, temb)
        elif u.addition_embed_type is not None:
            raise ValueError(f"unknown addition_embed_type {u.addition_embed_type!r}")

        skips, cur = [ch[0]], ch[0]
        self.down_blocks = nn.ModuleList()
        for i in range(n):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            if u.has_attention(i):
                blk.attentions = nn.ModuleList()
            if motion_levels[i]:
                blk.motion_modules = nn.ModuleList()
            for _ in range(L):
                blk.resnets.append(ResnetBlock(cur, ch[i], temb, groups, eps))
                cur = ch[i]
                if u.has_attention(i):
                    blk.attentions.append(st(ch[i], i, u.depth(i)))
                if motion_levels[i]:
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
        self.mid_block.attentions = nn.ModuleList([st(ch[-1], n - 1, u.depth(n - 1))])
        if self.motion_mid:
            self.mid_block.motion_modules = nn.ModuleList([mm(ch[-1])])

        self.up_blocks = nn.ModuleList()
        for i in range(n):
            _, out_ch, _ = _up_block_channels(u, i)
            level = n - 1 - i
            blk = _Block()
            blk.resnets = nn.ModuleList()
            if u.has_attention(level):
                blk.attentions = nn.ModuleList()
            if motion_levels[level]:
                blk.motion_modules = nn.ModuleList()
            for _ in range(L + 1):
                blk.resnets.append(ResnetBlock(cur + skips.pop(), out_ch, temb, groups, eps))
                cur = out_ch
                if u.has_attention(level):
                    blk.attentions.append(st(out_ch, level, u.depth(level)))
                if motion_levels[level]:
                    blk.motion_modules.append(mm(out_ch))
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Upsample(out_ch)])
            self.up_blocks.append(blk)

        if out_head:
            self.conv_norm_out = GroupNorm(groups, ch[0], eps, silu=True)
            self.conv_out = conv3x3(ch[0], u.out_channels)
        # bank key -> (transformer key, block index)
        self._blocks = {bk: (key, b) for key in transformer_keys(u)
                        for b, bk in enumerate(block_keys(u, key))}

    def attention(self, key: str) -> SpatialTransformer:
        """Structural transformer key -> the spatial transformer holding it."""
        if key == "mid":
            return self.mid_block.attentions[0]
        kind, i, j = key.split("_")
        blocks = self.down_blocks if kind == "down" else self.up_blocks
        return blocks[int(i)].attentions[int(j)]

    def transformer_block(self, bank_key: str) -> TransformerBlock:
        """Bank key -> the transformer block that writes or reads it."""
        key, b = self._blocks[bank_key]
        return self.attention(key).transformer_blocks[b]

    def added_embedding(self, time_ids: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
        """SDXL's "text_time" conditioning (diffusers ``UNet2DConditionModel``):
        the sinusoids of the time ids (B, 6) after the pooled vector (B, 1280),
        through ``add_embedding``: (B, time embedding), which every step adds
        to the timestep's embedding. Step-invariant: computed once a clip."""
        u = self.u
        B = pooled.shape[0]
        t = get_timestep_embedding(time_ids.reshape(-1), u.addition_time_embed_dim,
                                   u.flip_sin_to_cos, u.freq_shift).reshape(B, -1)
        x = torch.cat([pooled.float(), t], dim=-1).to(self.conv_in.weight.dtype)
        return self.add_embedding(x)

    def run(self, x: torch.Tensor, timesteps: torch.Tensor, context, frames: int = 1,
            write: bool = False, motion_map: Optional[torch.Tensor] = None,
            banks_kv: Optional[Dict[str, KV]] = None,
            ctx_kv: Optional[Dict[str, KV]] = None,
            ref_banks: Optional[Dict[str, torch.Tensor]] = None,
            frame_axis: Optional[Axis] = None, add_emb: Optional[torch.Tensor] = None):
        """x: (B*frames, H, W, C_in) NHWC. Returns (h, banks). ``frame_axis``:
        the mesh axis that shards the frames, threaded to every motion
        module (all else here is frame-local). ``add_emb``: (B or 1, time
        embedding), ``added_embedding``'s, where the configuration has one."""
        u = self.u
        dtype = self.conv_in.weight.dtype
        banks: Dict[str, torch.Tensor] = {}
        t_emb = get_timestep_embedding(timesteps, u.block_out_channels[0],
                                       u.flip_sin_to_cos, u.freq_shift).to(dtype)
        temb = self.time_embedding(t_emb)
        if (add_emb is None) != (u.addition_embed_type is None):
            raise ValueError("the added conditioning is given where the configuration has "
                             "none, or missing where it has one")
        if add_emb is not None:
            temb = temb + add_emb.to(dtype)
        temb = temb.repeat_interleave(frames, dim=0)
        ctx = None if context is None else context.to(dtype).repeat_interleave(frames, dim=0)

        def motion(mod, h):
            BT, hh, ww, c = h.shape
            h5 = h.reshape(BT // frames, frames, hh, ww, c)
            return remat_call(self.remat, mod, h5, frame_axis).reshape(BT, hh, ww, c)

        def attn(key, h):
            bks = block_keys(u, key)
            kv = None
            if ctx_kv is not None:
                kv = [(ctx_kv[bk][0].repeat_interleave(frames, dim=0),
                       ctx_kv[bk][1].repeat_interleave(frames, dim=0)) for bk in bks]
            ref_kv = None if banks_kv is None else [banks_kv[bk] for bk in bks]
            ref = None if ref_banks is None else [ref_banks[bk] for bk in bks]
            with span(f"spatial_stack_l{key_level(u, key)}"):
                h, written = remat_call(self.remat, self.attention(key).stack, h, ctx,
                                        write=write, ref_kv=ref_kv, ctx_kv=kv, ref=ref)
            if write:
                banks.update(zip(bks, written))
            return h

        h = conv_nhwc(self.conv_in, x.to(dtype))
        skips = [h]
        for i, blk in enumerate(self.down_blocks):
            for j, res in enumerate(blk.resnets):
                h = remat_call(self.remat, res, h, temb)
                if hasattr(blk, "attentions"):
                    h = attn(f"down_{i}_{j}", h)
                if hasattr(blk, "motion_modules"):
                    h = motion(blk.motion_modules[j], h)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)
            if hasattr(self, "man_blocks") and motion_map is not None:
                # MAN modulates only the main path, after the whole down block
                # (unet_2d_mix.py:1288); skip tensors are untouched.
                h = self.man_blocks[i](h, motion_map)

        h = remat_call(self.remat, self.mid_block.resnets[0], h, temb)
        h = attn("mid", h)
        if self.motion_mid:
            h = motion(self.mid_block.motion_modules[0], h)
        h = remat_call(self.remat, self.mid_block.resnets[1], h, temb)

        for i, blk in enumerate(self.up_blocks):
            for j, res in enumerate(blk.resnets):
                h = remat_call(self.remat, res, torch.cat([h, skips.pop()], dim=-1), temb)
                if hasattr(blk, "attentions"):
                    h = attn(f"up_{i}_{j}", h)
                if hasattr(blk, "motion_modules"):
                    h = motion(blk.motion_modules[j], h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return h, banks


class GuidanceUNet(_UNetBody):
    """Writes the reference-attention banks; t=0 in the reference."""

    def __init__(self, cfg: GuidanceUNetConfig = GuidanceUNetConfig(), remat: bool = False):
        super().__init__(cfg.unet, cfg.cond_channels,
                         man_hidden=cfg.man_hidden if cfg.use_man else None,
                         motion_channels=cfg.motion_channels, out_head=False, remat=remat)
        self.cfg = cfg

    def forward(self, cond: torch.Tensor, motion_map: Optional[torch.Tensor],
                timesteps: torch.Tensor, context: torch.Tensor,
                add_emb: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """cond: (B, H, W, 20); motion_map: (B, H, W, 2) or None;
        context: (B, S, cross_attention_dim); ``add_emb`` (B, time
        embedding): the added conditioning where the configuration has one.
        Returns {bank key: (B, S_l, C_l)}."""
        _, banks = self.run(cond, timesteps, context, write=True,
                            motion_map=motion_map if self.cfg.use_man else None,
                            add_emb=add_emb)
        return banks


class DenoisingUNet(_UNetBody):
    def __init__(self, cfg: DenoisingUNetConfig = DenoisingUNetConfig(), remat: bool = False):
        super().__init__(cfg.unet, cfg.unet.in_channels, motion=cfg.motion, remat=remat)
        self.cfg = cfg

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                banks_kv: Optional[Dict[str, KV]] = None,
                ctx_kv: Optional[Dict[str, KV]] = None,
                banks: Optional[Dict[str, torch.Tensor]] = None,
                frame_axis: Optional[Axis] = None,
                add_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample: (B, T, H, W, 4); timesteps: (B,); context: (B, S, 768),
        unused where ``ctx_kv`` (each (B, S, C_l)) is given; the banks either
        projected (``banks_kv``, pairs of (B*T, S_l, C_l)) or raw (``banks``,
        each (B*T, S_l, C_l)); with neither, plain self-attention. Returns
        (B, T, H, W, 4). Inside a mesh whose ``frame_axis`` shards the frames,
        T is the rank's share and the motion modules reshard (the JAX
        package's ``frame_axis`` / ``frame_shards``); the weights are the same.
        ``add_emb`` (B, time embedding): the added conditioning
        (``added_embedding``) where the configuration has one."""
        B, T = sample.shape[:2]
        h, _ = self.run(sample.reshape((B * T,) + sample.shape[2:]), timesteps, context,
                        frames=T, banks_kv=banks_kv, ctx_kv=ctx_kv, ref_banks=banks,
                        frame_axis=frame_axis, add_emb=add_emb)
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
        attn = den.transformer_block(key).attn1
        b = bank.to(dtype)
        out[key] = (b @ attn.to_k.weight.to(dtype).T, b @ attn.to_v.weight.to(dtype).T)
    return out


def precompute_context_kv(den: DenoisingUNet, context: torch.Tensor, keys: Iterable[str],
                          dtype=torch.bfloat16) -> Dict[str, KV]:
    """Cross-attention K/V of the CLIP context, per reader block: the context
    never changes across denoise steps, so each attn2's K/V are computed
    once. ``context``: (B, S, cross_attention_dim); the per-frame repeat
    happens in the UNet."""
    out = {}
    c = context.to(dtype)
    for key in keys:
        attn = den.transformer_block(key).attn2
        out[key] = (c @ attn.to_k.weight.to(dtype).T, c @ attn.to_v.weight.to(dtype).T)
    return out
