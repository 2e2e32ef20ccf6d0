"""The SD-width fidelity gate's reference: the reference's inference
algorithm in plain PyTorch, with no kernel of the port and no JAX.

- The twins: PyTorch modules with the released checkpoints' key grammar
  that compute the reference's modules (diffusers ``ResnetBlock2D`` /
  ``Transformer2DModel`` / ``BasicTransformerBlock``, the AnimateDiff motion
  module, the MAN module, the two UNets' wiring: ``TAttention`` ...
  ``TUNet``; the KL autoencoder: ``TVAEResnet`` ... ``TAutoencoderKL``),
  copied from the JAX package's tests (``tests/test_torch_parity.py``,
  ``tests/test_vae_parity.py``); the autoencoder takes its widths as
  arguments, and the time embedding is made on its input's device.
- ``torch_oracle``: ``pipeline_mikudance.py`` step by step (copied from
  ``tests/test_e2e_psnr.py``): per-stream VAE encodes, the 20-channel
  condition stack, guidance banks per window, per-window CFG with
  counter-averaged fusion, deterministic DDIM (v-prediction) in its own
  numpy algebra, frame-wise decode. The windows are schedule data, taken from
  the port's ``pipelines/context.uniform_windows``, as the timesteps are
  taken from the pipeline's schedule.
- ``run_pipeline_vs_oracle``: the port's ``VideoPipeline`` on the twins'
  weights, loaded strictly through ``core/loaders.py`` as a released file is
  (no converter: the port's parameters carry the reference's names), against
  the oracle on the same inputs.

Everything runs on an explicit ``device``; the oracle in fp32. Used by
``scripts/psnr_sd_width.py``, ``scripts/verify_parity.py`` and
``chip_smoke.py``'s request J.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import loaders
from ..core.configs import (ContextConfig, MotionModuleConfig, PipelineConfig, UNetConfig,
                            VAEConfig)
from ..diffusion.ddim import inference_step_pairs
from ..pipelines.context import uniform_windows
from ..pipelines.video import SD_LATENT_SCALE, ModelBundle, VideoPipeline, schedule_for

# The tiny twins' UNet and autoencoder (``tests/test_e2e_psnr.py:57-67``,
# ``tests/test_vae_parity.py:25-28``) and the JAX test's geometry.
TINY = UNetConfig(block_out_channels=(32, 64, 96, 96), attention_heads=4)
CH = (16, 32, 32, 32)
GROUPS = 8
LAYERS = 2
LATENT = 4
TINY_VAE = VAEConfig(block_out_channels=CH, layers_per_block=LAYERS, norm_num_groups=GROUPS)
# The SD VAE's widths (sd-vae-ft-mse), for the weights mode of verify_parity.
SD_VAE = dict(ch=(128, 256, 512, 512), groups=32, layers=2)
T, H, W = 5, 128, 128
STEPS, SCALE, S_CTX = 3, 3.5, 5


# ---------------------------------------------------------------------------
# the UNet twins (reference semantics, released-checkpoint key names)
# ---------------------------------------------------------------------------


class TAttention(torch.nn.Module):
    """diffusers Attention: to_q/k/v (no bias) + to_out.0 (bias), fp32 softmax."""

    def __init__(self, dim, heads, kv_dim=None):
        super().__init__()
        self.heads = heads
        self.to_q = torch.nn.Linear(dim, dim, bias=False)
        self.to_k = torch.nn.Linear(kv_dim or dim, dim, bias=False)
        self.to_v = torch.nn.Linear(kv_dim or dim, dim, bias=False)
        self.to_out = torch.nn.ModuleList([torch.nn.Linear(dim, dim)])

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        B, S, C = q.shape
        h, d = self.heads, C // self.heads
        q = q.view(B, -1, h, d).transpose(1, 2)
        k = k.view(B, -1, h, d).transpose(1, 2)
        v = v.view(B, -1, h, d).transpose(1, 2)
        attn = torch.softmax(q @ k.transpose(-1, -2) * d**-0.5, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(B, S, C)
        return self.to_out[0](out)


class TGEGLU(torch.nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = torch.nn.Linear(dim, inner * 2)

    def forward(self, x):
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * torch.nn.functional.gelu(g)


class TFeedForward(torch.nn.Module):
    """diffusers FeedForward(geglu): net.0 = GEGLU, net.1 = Dropout, net.2 = Linear."""

    def __init__(self, dim, mult=4):
        super().__init__()
        inner = dim * mult
        self.net = torch.nn.ModuleList(
            [TGEGLU(dim, inner), torch.nn.Dropout(0.0), torch.nn.Linear(inner, dim)]
        )

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class TBasicTransformerBlock(torch.nn.Module):
    """(Temporal)BasicTransformerBlock with the bank write/read contract of
    `mutual_mix_attention.py:140,169-201` made explicit: write returns norm_h,
    read uses K/V = norm_h + ref."""

    def __init__(self, dim, heads, ctx_dim):
        super().__init__()
        self.norm1 = torch.nn.LayerNorm(dim)
        self.attn1 = TAttention(dim, heads)
        self.norm2 = torch.nn.LayerNorm(dim)
        self.attn2 = TAttention(dim, heads, kv_dim=ctx_dim)
        self.norm3 = torch.nn.LayerNorm(dim)
        self.ff = TFeedForward(dim)

    def forward(self, x, ctx, ref=None, write=False):
        nh = self.norm1(x)
        bank = nh if write else None
        x = x + self.attn1(nh, None if ref is None else nh + ref)
        x = x + self.attn2(self.norm2(x), ctx)
        x = x + self.ff(self.norm3(x))
        return x, bank


class TTransformer2D(torch.nn.Module):
    """Transformer2DModel, SD1.5 config (1x1-conv projections, 1 block)."""

    def __init__(self, ch, dim, heads, ctx_dim, groups=32):
        super().__init__()
        self.norm = torch.nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = torch.nn.Conv2d(ch, dim, 1)
        self.transformer_blocks = torch.nn.ModuleList(
            [TBasicTransformerBlock(dim, heads, ctx_dim)]
        )
        self.proj_out = torch.nn.Conv2d(dim, ch, 1)

    def forward(self, x, ctx, ref=None, write=False):
        B, C, H, W = x.shape
        res = x
        h = self.proj_in(self.norm(x))
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, -1)
        h, bank = self.transformer_blocks[0](h, ctx, ref=ref, write=write)
        h = h.reshape(B, H, W, -1).permute(0, 3, 1, 2)
        return self.proj_out(h) + res, bank


class TResnetBlock(torch.nn.Module):
    def __init__(self, in_ch, out_ch, temb_ch=None, groups=32, eps=1e-5):
        super().__init__()
        self.norm1 = torch.nn.GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = torch.nn.Conv2d(in_ch, out_ch, 3, padding=1)
        if temb_ch:
            self.time_emb_proj = torch.nn.Linear(temb_ch, out_ch)
        self.norm2 = torch.nn.GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = torch.nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = torch.nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x, temb=None):
        h = self.conv1(torch.nn.functional.silu(self.norm1(x)))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(torch.nn.functional.silu(temb))[:, :, None, None]
        h = self.conv2(torch.nn.functional.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class TPositionalEncoding(torch.nn.Module):
    def __init__(self, dim, max_len=32):
        super().__init__()
        position = torch.arange(max_len, dtype=torch.float64)[:, None]
        div = torch.exp(
            torch.arange(0, dim, 2, dtype=torch.float64) * (-math.log(10000.0) / dim)
        )
        pe = torch.zeros(1, max_len, dim, dtype=torch.float64)
        pe[0, :, 0::2] = torch.sin(position * div)
        pe[0, :, 1::2] = torch.cos(position * div)
        self.register_buffer("pe", pe.float(), persistent=False)

    def forward(self, x):
        return x + self.pe[:, : x.size(1)]


class TVersatileAttention(TAttention):
    """Temporal_Self attention: PE applied to the query path only — the K/V
    tensor is aliased *before* the positional encoder runs
    (`motion_module.py:404-417`)."""

    def __init__(self, dim, heads, max_len):
        super().__init__(dim, heads)
        self.pos_encoder = TPositionalEncoding(dim, max_len)

    def forward(self, x, video_length):
        bf, d, c = x.shape
        b = bf // video_length
        t = (
            x.reshape(b, video_length, d, c)
            .permute(0, 2, 1, 3)
            .reshape(b * d, video_length, c)
        )
        kv = t
        t = self.pos_encoder(t)
        out = super().forward(t, kv)
        return (
            out.reshape(b, d, video_length, c)
            .permute(0, 2, 1, 3)
            .reshape(bf, d, c)
        )


class TTemporalTransformerBlock(torch.nn.Module):
    def __init__(self, dim, heads, max_len, n_attn=2):
        super().__init__()
        self.attention_blocks = torch.nn.ModuleList(
            [TVersatileAttention(dim, heads, max_len) for _ in range(n_attn)]
        )
        self.norms = torch.nn.ModuleList(
            [torch.nn.LayerNorm(dim) for _ in range(n_attn)]
        )
        self.ff = TFeedForward(dim)
        self.ff_norm = torch.nn.LayerNorm(dim)

    def forward(self, x, video_length):
        for attn, norm in zip(self.attention_blocks, self.norms):
            x = attn(norm(x), video_length) + x
        return self.ff(self.ff_norm(x)) + x


class TTemporalTransformer3D(torch.nn.Module):
    def __init__(self, ch, heads, max_len, n_blocks=1, groups=32):
        super().__init__()
        self.norm = torch.nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = torch.nn.Linear(ch, ch)
        self.transformer_blocks = torch.nn.ModuleList(
            [TTemporalTransformerBlock(ch, heads, max_len) for _ in range(n_blocks)]
        )
        self.proj_out = torch.nn.Linear(ch, ch)

    def forward(self, x):
        # x: (b, c, f, h, w)
        b, c, f, hh, ww = x.shape
        h = x.permute(0, 2, 1, 3, 4).reshape(b * f, c, hh, ww)
        res = h
        h = self.norm(h)
        h = h.permute(0, 2, 3, 1).reshape(b * f, hh * ww, c)
        h = self.proj_in(h)
        for blk in self.transformer_blocks:
            h = blk(h, video_length=f)
        h = self.proj_out(h)
        h = h.reshape(b * f, hh, ww, c).permute(0, 3, 1, 2)
        out = h + res
        return out.reshape(b, f, c, hh, ww).permute(0, 2, 1, 3, 4)


class TVanillaTemporalModule(torch.nn.Module):
    def __init__(self, ch, heads, max_len, n_blocks=1):
        super().__init__()
        self.temporal_transformer = TTemporalTransformer3D(ch, heads, max_len, n_blocks)

    def forward(self, x):
        return self.temporal_transformer(x)


class TMANModule(torch.nn.Module):
    def __init__(self, ch, m_dim=2, nhidden=128):
        super().__init__()
        self.norm = torch.nn.InstanceNorm2d(ch, affine=False)
        self.mlp_shared = torch.nn.Sequential(
            torch.nn.Conv2d(m_dim, nhidden, 3, padding=1), torch.nn.ReLU()
        )
        self.mlp_gamma = torch.nn.Conv2d(nhidden, ch, 3, padding=1)
        self.mlp_beta = torch.nn.Conv2d(nhidden, ch, 3, padding=1)

    def forward(self, x, motion_map):
        normalized = self.norm(x)
        m = torch.nn.functional.interpolate(motion_map, size=x.shape[2:], mode="nearest")
        actv = self.mlp_shared(m)
        return normalized * (1 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


def timestep_embedding_torch(t, dim):
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                 device=t.device) / half
    emb = torch.exp(exponent)[None, :] * t.float()[:, None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)  # flip_sin_to_cos


class TTimeEmbedding(torch.nn.Module):
    def __init__(self, in_dim, dim):
        super().__init__()
        self.linear_1 = torch.nn.Linear(in_dim, dim)
        self.linear_2 = torch.nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(torch.nn.functional.silu(self.linear_1(x)))


class _Blank(torch.nn.Module):
    pass


class TUNet(torch.nn.Module):
    """SD1.5-wiring UNet twin (4 levels, 2 layers, cross-attn on levels 0-2),
    optional motion modules (denoising 3D variant, frames folded) and MAN
    blocks (guidance MIX variant). Checkpoint keys match diffusers/reference."""

    def __init__(self, ch, layers, heads, ctx_dim, in_ch, out_ch=4,
                 groups=32, eps=1e-5, motion=False, man=False, max_len=32):
        super().__init__()
        n = len(ch)
        self.n, self.layers, self.motion, self.man = n, layers, motion, man
        temb_dim = ch[0] * 4
        self.conv_in = torch.nn.Conv2d(in_ch, ch[0], 3, padding=1)
        self.time_embedding = TTimeEmbedding(ch[0], temb_dim)

        skips = [ch[0]]
        cur = ch[0]
        self.down_blocks = torch.nn.ModuleList()
        for i in range(n):
            blk = _Blank()
            blk.resnets = torch.nn.ModuleList()
            has_attn = i < n - 1
            if has_attn:
                blk.attentions = torch.nn.ModuleList()
            if motion:
                blk.motion_modules = torch.nn.ModuleList()
            for j in range(layers):
                blk.resnets.append(TResnetBlock(cur, ch[i], temb_dim, groups, eps))
                cur = ch[i]
                if has_attn:
                    blk.attentions.append(
                        TTransformer2D(ch[i], ch[i], heads, ctx_dim, groups))
                if motion:
                    blk.motion_modules.append(
                        TVanillaTemporalModule(ch[i], heads, max_len))
                skips.append(ch[i])
            if i < n - 1:
                ds = _Blank()
                ds.conv = torch.nn.Conv2d(ch[i], ch[i], 3, stride=2, padding=1)
                blk.downsamplers = torch.nn.ModuleList([ds])
                skips.append(ch[i])
            self.down_blocks.append(blk)

        if man:
            self.man_blocks = torch.nn.ModuleList(
                [TMANModule(ch[i]) for i in range(n)])

        mid = _Blank()
        mid.resnets = torch.nn.ModuleList(
            [TResnetBlock(ch[-1], ch[-1], temb_dim, groups, eps) for _ in range(2)])
        mid.attentions = torch.nn.ModuleList(
            [TTransformer2D(ch[-1], ch[-1], heads, ctx_dim, groups)])
        if motion:
            mid.motion_modules = torch.nn.ModuleList(
                [TVanillaTemporalModule(ch[-1], heads, max_len)])
        self.mid_block = mid

        rev = list(reversed(ch))
        self.up_blocks = torch.nn.ModuleList()
        for i in range(n):
            out_c = rev[i]
            blk = _Blank()
            blk.resnets = torch.nn.ModuleList()
            has_attn = i > 0
            if has_attn:
                blk.attentions = torch.nn.ModuleList()
            if motion:
                blk.motion_modules = torch.nn.ModuleList()
            for j in range(layers + 1):
                skip = skips.pop()
                blk.resnets.append(TResnetBlock(cur + skip, out_c, temb_dim, groups, eps))
                cur = out_c
                if has_attn:
                    blk.attentions.append(
                        TTransformer2D(out_c, out_c, heads, ctx_dim, groups))
                if motion:
                    blk.motion_modules.append(
                        TVanillaTemporalModule(out_c, heads, max_len))
            if i < n - 1:
                us = _Blank()
                us.conv = torch.nn.Conv2d(out_c, out_c, 3, padding=1)
                blk.upsamplers = torch.nn.ModuleList([us])
            self.up_blocks.append(blk)

        self.conv_norm_out = torch.nn.GroupNorm(groups, ch[0], eps=eps)
        self.conv_out = torch.nn.Conv2d(ch[0], out_ch, 3, padding=1)

    def forward(self, x, t, ctx, banks=None, motion_map=None, T=1, write=False):
        """x: (B*T, C_in, H, W); banks keyed like models.unet.bank_keys."""
        out_banks = {}
        B = x.shape[0] // T
        temb = self.time_embedding(timestep_embedding_torch(t, self.conv_in.out_channels))
        temb_f = temb.repeat_interleave(T, 0)
        ctx_f = ctx.repeat_interleave(T, 0)

        def mm(mod, h):
            bt, c, hh, ww = h.shape
            v = h.reshape(B, T, c, hh, ww).permute(0, 2, 1, 3, 4)
            v = mod(v)
            return v.permute(0, 2, 1, 3, 4).reshape(bt, c, hh, ww)

        def ref(key):
            return None if banks is None else banks.get(key)

        h = self.conv_in(x)
        skips = [h]
        for i, blk in enumerate(self.down_blocks):
            has_attn = i < self.n - 1
            for j in range(self.layers):
                h = blk.resnets[j](h, temb_f)
                if has_attn:
                    h, bank = blk.attentions[j](
                        h, ctx_f, ref=ref(f"down_{i}_{j}"), write=write)
                    out_banks[f"down_{i}_{j}"] = bank
                if self.motion:
                    h = mm(blk.motion_modules[j], h)
                skips.append(h)
            if has_attn:
                h = blk.downsamplers[0].conv(h)
                skips.append(h)
            if self.man and motion_map is not None:
                h = self.man_blocks[i](h, motion_map)

        h = self.mid_block.resnets[0](h, temb_f)
        h, bank = self.mid_block.attentions[0](h, ctx_f, ref=ref("mid"), write=write)
        out_banks["mid"] = bank
        if self.motion:
            h = mm(self.mid_block.motion_modules[0], h)
        h = self.mid_block.resnets[1](h, temb_f)

        for i, blk in enumerate(self.up_blocks):
            has_attn = i > 0
            for j in range(self.layers + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = blk.resnets[j](h, temb_f)
                if has_attn:
                    h, bank = blk.attentions[j](
                        h, ctx_f, ref=ref(f"up_{i}_{j}"), write=write)
                    out_banks[f"up_{i}_{j}"] = bank
                if self.motion:
                    h = mm(blk.motion_modules[j], h)
            if i < self.n - 1:
                h = torch.nn.functional.interpolate(h, scale_factor=2, mode="nearest")
                h = blk.upsamplers[0].conv(h)

        h = self.conv_out(torch.nn.functional.silu(self.conv_norm_out(h)))
        return h, out_banks


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

TINY = UNetConfig(block_out_channels=(32, 64, 96, 96), attention_heads=4)


# ---------------------------------------------------------------------------
# the KL autoencoder twin (diffusers AutoencoderKL's structure and keys)
# ---------------------------------------------------------------------------


class TVAEResnet(nn.Module):
    def __init__(self, cin, cout, groups=GROUPS):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class TVAEAttention(nn.Module):
    """diffusers' single-head mid-block attention (to_out is a ModuleList so
    the key is to_out.0.*)."""

    def __init__(self, c, groups=GROUPS):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).reshape(B, C, H * W).transpose(1, 2)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        h = F.scaled_dot_product_attention(
            q.unsqueeze(1), k.unsqueeze(1), v.unsqueeze(1)
        ).squeeze(1)
        h = self.to_out[0](h)
        return x + h.transpose(1, 2).reshape(B, C, H, W)


class TVAEDown(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))  # torch VAE's asymmetric pad


class TVAEUp(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _VAESeq(nn.Module):
    """Named sub-blocks matching diffusers down/up block key layout."""

    def __init__(self, resnets, sampler=None, down=True):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        name = "downsamplers" if down else "upsamplers"
        if sampler is not None:
            setattr(self, name, nn.ModuleList([sampler]))
        self._name = name

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        s = getattr(self, self._name, None)
        if s is not None:
            x = s[0](x)
        return x


class TVAEMid(nn.Module):
    def __init__(self, c, groups=GROUPS):
        super().__init__()
        self.resnets = nn.ModuleList([TVAEResnet(c, c, groups), TVAEResnet(c, c, groups)])
        self.attentions = nn.ModuleList([TVAEAttention(c, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class TVAEEncoder(nn.Module):
    def __init__(self, ch=CH, groups=GROUPS, layers=LAYERS):
        super().__init__()
        self.conv_in = nn.Conv2d(3, ch[0], 3, padding=1)
        blocks = []
        cin = ch[0]
        for i, c in enumerate(ch):
            resnets = [TVAEResnet(cin if j == 0 else c, c, groups) for j in range(layers)]
            blocks.append(
                _VAESeq(resnets, TVAEDown(c) if i < len(ch) - 1 else None, down=True)
            )
            cin = c
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = TVAEMid(ch[-1], groups)
        self.conv_norm_out = nn.GroupNorm(groups, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * LATENT, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for b in self.down_blocks:
            h = b(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class TVAEDecoder(nn.Module):
    def __init__(self, ch=CH, groups=GROUPS, layers=LAYERS):
        super().__init__()
        rev = list(reversed(ch))
        self.conv_in = nn.Conv2d(LATENT, rev[0], 3, padding=1)
        self.mid_block = TVAEMid(rev[0], groups)
        blocks = []
        cin = rev[0]
        for i, c in enumerate(rev):
            resnets = [TVAEResnet(cin if j == 0 else c, c, groups) for j in range(layers + 1)]
            blocks.append(
                _VAESeq(resnets, TVAEUp(c) if i < len(rev) - 1 else None, down=False)
            )
            cin = c
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(groups, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], 3, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for b in self.up_blocks:
            h = b(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class TAutoencoderKL(nn.Module):
    """The tiny autoencoder by default; ``SD_VAE`` gives sd-vae-ft-mse's widths."""

    def __init__(self, ch=CH, groups=GROUPS, layers=LAYERS):
        super().__init__()
        self.encoder = TVAEEncoder(ch, groups, layers)
        self.decoder = TVAEDecoder(ch, groups, layers)
        self.quant_conv = nn.Conv2d(2 * LATENT, 2 * LATENT, 1)
        self.post_quant_conv = nn.Conv2d(LATENT, LATENT, 1)


def make_twins(ch, heads: int, device, vae=None, seed: int = 3):
    """The gate's twins on ``device`` under ``seed``: the autoencoder (tiny,
    or ``vae``'s widths), the guidance UNet (MAN, 20 input channels) and the
    denoiser (motion modules), widths ``ch`` and ``heads`` heads, the
    denoiser's temporal ``proj_out`` drawn from N(0, 0.05) (it starts at zero,
    which would hide the motion modules)."""
    dev = torch.device(device)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []), dev:
        torch.manual_seed(seed)
        tvae = TAutoencoderKL(**(vae or {})).eval()
        tguide = TUNet(ch, 2, heads, 768, in_ch=20, man=True).eval()
        tden = TUNet(ch, 2, heads, 768, in_ch=4, motion=True).eval()
        for name, p in tden.named_parameters():
            if "proj_out" in name and "temporal_transformer" in name:
                torch.nn.init.normal_(p, std=0.05)
    return tvae, tguide, tden


# ---------------------------------------------------------------------------
# the oracle: the reference's inference algorithm
# ---------------------------------------------------------------------------


def _nchw(x, device) -> torch.Tensor:
    return torch.from_numpy(np.transpose(np.asarray(x, np.float32), (0, 3, 1, 2))).to(device)


def torch_encode_mean(tvae, imgs_nchw):
    moments = tvae.quant_conv(tvae.encoder(imgs_nchw))
    return moments[:, :4] * SD_LATENT_SCALE


def torch_oracle(tvae, tguide, tden, inputs, alphas_cumprod, step_pairs, windows, device,
                 T=T, h=H // 8, w=W // 8, scale=SCALE):
    """The reference inference algorithm, verbatim, in torch/numpy on
    ``device``. ``step_pairs`` (the (timesteps, prev_timesteps) arrays) and
    ``windows`` are schedule data shared with the pipeline; the per-step
    update algebra below is an independent numpy implementation. Returns the
    final latents (T, 4, h, w) and the uint8 video (T, H, W, 3), as numpy."""
    ref_img, skel, pose, face, hand, motion, clip_ctx, noise = inputs

    # per-stream VAE encodes (latent means, scaled)
    ref_l = torch_encode_mean(tvae, _nchw(ref_img[None], device))  # (1, 4, h, w)
    skel_l = torch_encode_mean(tvae, _nchw(skel[None], device))
    pose_l = torch_encode_mean(tvae, _nchw(pose, device))  # (T, 4, h, w)
    face_l = torch_encode_mean(tvae, _nchw(face, device))
    hand_l = torch_encode_mean(tvae, _nchw(hand, device))
    cond20 = torch.cat(
        [ref_l.expand(T, -1, -1, -1), skel_l.expand(T, -1, -1, -1),
         pose_l, face_l, hand_l], dim=1,
    )  # (T, 20, h, w)
    motion_t = _nchw(motion, device)  # (T, 2, h, w)
    ctx_c = torch.from_numpy(clip_ctx).to(device)  # (1, S, 768)
    ctx_u = torch.zeros_like(ctx_c)

    # guidance banks per window, t=0, cond embed at every position
    # (guidance_clip_mode="cond"; the reference recomputes these per step,
    # bit-identically: once is enough for the oracle too)
    banks_per_window = []
    for win in windows:
        wf = len(win)
        _, banks = tguide(
            cond20[win], torch.zeros(wf, device=device), ctx_c.expand(wf, -1, -1),
            motion_map=motion_t[win], write=True,
        )
        banks_per_window.append(banks)

    # denoising loop: per-window CFG, counter-averaged fusion, DDIM
    ts, prev_ts = step_pairs
    latents = torch.from_numpy(noise.transpose(0, 3, 1, 2).copy()).to(device)  # (T, 4, h, w)
    for t, t_prev in zip(ts, prev_ts):
        sum_u = torch.zeros_like(latents)
        sum_c = torch.zeros_like(latents)
        counter = torch.zeros(T, 1, 1, 1, device=device)
        for win, banks in zip(windows, banks_per_window):
            wf = len(win)
            lat_w = latents[win].reshape(1 * wf, 4, h, w)
            t_b = torch.full((1,), float(t), device=device)
            # uncond: zero CLIP embed + no banks (== zero banks: the bank read
            # is additive, mutual_mix_attention.py:169-180)
            pred_u, _ = tden(lat_w, t_b, ctx_u, banks=None, T=wf)
            pred_c, _ = tden(lat_w, t_b, ctx_c, banks=banks, T=wf)
            for j, fidx in enumerate(win):
                sum_u[fidx] += pred_u[j]
                sum_c[fidx] += pred_c[j]
                counter[fidx] += 1
        mean_u, mean_c = sum_u / counter, sum_c / counter
        noise_pred = mean_u + scale * (mean_c - mean_u)
        latents = ddim_step_np(noise_pred, t, t_prev, latents, alphas_cumprod)

    # frame-wise decode
    frames = []
    for i in range(T):
        z = latents[i : i + 1] / SD_LATENT_SCALE
        img = tvae.decoder(tvae.post_quant_conv(z))
        frames.append(img)
    video = torch.cat(frames, dim=0).clamp(-1, 1)
    video = ((video / 2 + 0.5).clamp(0, 1) * 255.0).round()
    return (latents.cpu().numpy(),
            video.permute(0, 2, 3, 1).cpu().numpy().astype(np.uint8))


def ddim_step_np(out, t, t_prev, x, ac):
    """Deterministic DDIM, v-prediction (independent numpy algebra)."""
    a_t = float(ac[t])
    a_prev = float(ac[t_prev]) if t_prev >= 0 else 1.0
    sqrt_a, sqrt_b = a_t**0.5, (1.0 - a_t) ** 0.5
    pred_x0 = sqrt_a * x - sqrt_b * out
    pred_eps = sqrt_a * out + sqrt_b * x
    return (a_prev**0.5) * pred_x0 + ((1.0 - a_prev) ** 0.5) * pred_eps


def gate_inputs(T, H, W, s_ctx, seed):
    """The inputs of ``tests/test_e2e_psnr.py``, from ``default_rng(seed)``."""
    h_, w_ = H // 8, W // 8
    rng = np.random.default_rng(seed)
    ref_img = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
    skel = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    pose = rng.uniform(0, 1, (T, H, W, 3)).astype(np.float32)
    face = rng.uniform(0, 1, (T, H, W, 3)).astype(np.float32)
    hand = rng.uniform(0, 1, (T, H, W, 3)).astype(np.float32)
    motion = rng.normal(0, 0.3, (T, h_, w_, 2)).astype(np.float32)
    clip_ctx = rng.normal(0, 1, (1, s_ctx, 768)).astype(np.float32)
    noise = rng.normal(0, 1, (T, h_, w_, 4)).astype(np.float32)
    return ref_img, skel, pose, face, hand, motion, clip_ctx, noise


def port_pipeline(tvae, tguide, tden, *, unet_cfg, vae_cfg, motion_heads, H, W, steps, scale,
                  ctx_frames, overlap, unet_dtype, device) -> VideoPipeline:
    """The port's ``VideoPipeline`` on the twins' weights: each twin's
    ``state_dict`` loads strictly into the port's module through
    ``core/loaders.py``, as a released file does; the UNets in
    ``unet_dtype``, the autoencoder in fp32."""
    guide = loaders.load_guidance(tguide.state_dict(), use_man=True, dtype=unet_dtype,
                                  device=device, unet_config=unet_cfg)
    den = loaders.load_denoising(
        tden.state_dict(), dtype=unet_dtype, device=device, unet_config=unet_cfg,
        motion_config=MotionModuleConfig(num_attention_heads=motion_heads))
    enc, dec = loaders.load_vae(tvae.state_dict(), device=device, config=vae_cfg)
    return VideoPipeline(
        ModelBundle(guide, den, enc, dec),
        PipelineConfig(width=W, height=H, num_inference_steps=steps, guidance_scale=scale,
                       context=ContextConfig(frames=ctx_frames, overlap=overlap),
                       guidance_clip_mode="cond"),
        device=device)


def run_oracle(tvae, tguide, tden, *, T=T, H=H, W=W, steps=STEPS, scale=SCALE, s_ctx=S_CTX,
               ctx_frames=3, overlap=1, seed=11, device=None):
    """The oracle on ``gate_inputs``, with the pipeline's schedule data (the
    schedule of a default ``PipelineConfig``, as ``port_pipeline`` builds):
    (latents (T, 4, h, w), uint8 video (T, H, W, 3)), numpy."""
    schedule = schedule_for(PipelineConfig())
    ac = np.asarray(schedule.alphas_cumprod, np.float64)
    step_pairs = inference_step_pairs(schedule, steps)
    windows = uniform_windows(0, T, ctx_frames, 1, overlap)
    with torch.no_grad():
        return torch_oracle(tvae, tguide, tden, gate_inputs(T, H, W, s_ctx, seed), ac,
                            step_pairs, windows, device, T=T, h=H // 8, w=W // 8, scale=scale)


def run_port(pipe: VideoPipeline, *, T=T, H=H, W=W, s_ctx=S_CTX, seed=11):
    """The pipeline on ``gate_inputs``, once with ``decode=False`` and once
    decoded: (uint8 video (T, H, W, 3), latents (T, h, w, 4)), numpy."""
    inputs = gate_inputs(T, H, W, s_ctx, seed)
    got_lat = pipe(*inputs, decode=False).float().cpu().numpy()
    got_video = pipe(*inputs, to_host=True)
    return got_video, got_lat


def run_pipeline_vs_oracle(tvae, tguide, tden, *, unet_cfg=TINY, vae_cfg=TINY_VAE,
                           motion_heads=4, T=T, H=H, W=W, steps=STEPS, scale=SCALE,
                           s_ctx=S_CTX, ctx_frames=3, overlap=1, seed=11,
                           unet_dtype=torch.float32, device=None):
    """The port's ``VideoPipeline`` (``port_pipeline``) and the oracle on the
    same inputs; returns (got_video, want_video, got_lat, want_lat), the
    port's latents (T, h, w, 4), the oracle's (T, 4, h, w). ``device`` None:
    the card (raises where there is none)."""
    from ..core.params import resolve_device

    dev = resolve_device(device)
    pipe = port_pipeline(tvae, tguide, tden, unet_cfg=unet_cfg, vae_cfg=vae_cfg,
                         motion_heads=motion_heads, H=H, W=W, steps=steps, scale=scale,
                         ctx_frames=ctx_frames, overlap=overlap, unet_dtype=unet_dtype,
                         device=dev)
    got_video, got_lat = run_port(pipe, T=T, H=H, W=W, s_ctx=s_ctx, seed=seed)
    want_lat, want_video = run_oracle(tvae, tguide, tden, T=T, H=H, W=W, steps=steps,
                                      scale=scale, s_ctx=s_ctx, ctx_frames=ctx_frames,
                                      overlap=overlap, seed=seed, device=dev)
    return got_video, want_video, got_lat, want_lat


def psnr(a: np.ndarray, b: np.ndarray, peak: float) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)
