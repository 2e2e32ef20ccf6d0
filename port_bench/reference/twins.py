"""The plain reference networks: PyTorch modules with the released
checkpoints' key grammar, in fp32, with no kernel of the program.

A frozen copy of the twins the port keeps for its fidelity gate (the
diffusers ``ResnetBlock2D`` / ``Transformer2DModel`` /
``BasicTransformerBlock``, the AnimateDiff motion module, the MAN module, the
two UNets' wiring, the KL autoencoder), with four changes:

- attention runs through ``attend``, in blocks of query rows, so that a
  768^2 frame's 9216-token softmax fits the card;
- ``TUNet.remat`` recomputes each block in the backward (the training
  reference at 20 frames of 576^2);
- ``GroupNorm`` computes its statistics in plain arithmetic;
- ``fp8_products`` rounds the operands of every product (linear, conv,
  attention) through float8 e4m3 with a per-tensor scale, forward only: the
  control that a comparison has to reject.

``TCLIPVision`` is the CLIP ViT-L/14 image tower with projection (Hugging
Face ``CLIPVisionModelWithProjection``'s keys), whose whole projected token
sequence is the image prompt.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

# elements of one block of attention scores (fp32: 1 GiB)
SCORE_BLOCK = 1 << 28
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x's value through float8 e4m3 with one scale for the tensor (its
    largest magnitude to the format's largest), back in x's type; the
    gradient passes through unrounded."""
    xd = x.detach()
    scale = xd.abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = ((xd / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale).to(x.dtype)
    return x + (q - xd) if x.requires_grad else q


def attend(q, k, v, scale: float, quant=None):
    """softmax(q k^T * scale) v over (B, heads, S, d) in fp32, in blocks of at
    most SCORE_BLOCK scores (of whole sequences where they fit, else of query
    rows). ``quant``: a rounding of both products' operands (the control)."""
    if quant is not None:
        q, k, v = quant(q), quant(k), quant(v)
    B, H, S, _ = q.shape
    L = k.shape[2]
    qf, kf, vf = (t.reshape((B * H,) + t.shape[2:]) for t in (q, k, v))
    rows = min(S, max(1, SCORE_BLOCK // L))
    nb = max(1, SCORE_BLOCK // (rows * L))
    parts = []
    for i in range(0, B * H, nb):
        blocks = []
        for r in range(0, S, rows):
            p = torch.softmax(qf[i:i + nb, r:r + rows] @ kf[i:i + nb].transpose(-1, -2) * scale,
                              dim=-1)
            if quant is not None:
                p = quant(p)
            blocks.append(p @ vf[i:i + nb])
        parts.append(torch.cat(blocks, dim=1))
    return torch.cat(parts).reshape(B, H, S, v.shape[-1])


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` (its parameters and keys) computed in plain
    arithmetic: the mean and the biased variance over each group, then the
    affine. (PyTorch's CPU kernel has been seen to crash in the backward
    where the input needs a gradient and the affine does not.)"""

    def forward(self, x):
        B, C = x.shape[:2]
        g = x.reshape(B, self.num_groups, -1)
        mean = g.mean(-1, keepdim=True)
        var = (g - mean).square().mean(-1, keepdim=True)
        y = ((g - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, C) + (1,) * (x.dim() - 2)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)


class _FP8(nn.Module):
    """A parametrization: the weight as a product sees it, rounded through
    fp8 at every use (the parameter itself keeps its fp32 value)."""

    def forward(self, w):
        return fp8_round(w)


def fp8_products(model: nn.Module) -> nn.Module:
    """The control: every linear and conv layer computes with its weight and
    its input rounded through fp8 at each call, and attention with its
    operands rounded (``quant``); the parameters stay fp32, as masters do.
    Returns the model."""
    from torch.nn.utils import parametrize

    for m in list(model.modules()):
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            parametrize.register_parametrization(m, "weight", _FP8())
            m.register_forward_pre_hook(lambda _m, args: (fp8_round(args[0]),) + args[1:])
        if hasattr(m, "quant"):
            m.quant = fp8_round
    return model


# ---------------------------------------------------------------------------
# the UNet twins (reference semantics, released-checkpoint key names)
# ---------------------------------------------------------------------------


class TAttention(torch.nn.Module):
    """diffusers Attention: to_q/k/v (no bias) + to_out.0 (bias), fp32 softmax."""

    def __init__(self, dim, heads, kv_dim=None):
        super().__init__()
        self.heads = heads
        self.quant = None  # the control's rounding of the products' operands
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
        out = attend(q, k, v, d**-0.5, self.quant).transpose(1, 2).reshape(B, S, C)
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
        self.norm = GroupNorm(groups, ch, eps=1e-6)
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
        self.norm1 = GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = torch.nn.Conv2d(in_ch, out_ch, 3, padding=1)
        if temb_ch:
            self.time_emb_proj = torch.nn.Linear(temb_ch, out_ch)
        self.norm2 = GroupNorm(groups, out_ch, eps=eps)
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
        # made on the host and moved: where the module is built (the meta
        # device too) gets the same table
        cpu = torch.device("cpu")
        position = torch.arange(max_len, dtype=torch.float64, device=cpu)[:, None]
        div = torch.exp(
            torch.arange(0, dim, 2, dtype=torch.float64, device=cpu) * (-math.log(10000.0) / dim)
        )
        pe = torch.zeros(1, max_len, dim, dtype=torch.float64, device=cpu)
        pe[0, :, 0::2] = torch.sin(position * div)
        pe[0, :, 1::2] = torch.cos(position * div)
        self.register_buffer("pe", pe.float().to(torch.get_default_device()), persistent=False)

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
        self.norm = GroupNorm(groups, ch, eps=1e-6)
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
        self.remat = False  # recompute each block in the backward (training)
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

        self.conv_norm_out = GroupNorm(groups, ch[0], eps=eps)
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

        def run(mod, *args, **kw):
            if self.remat and torch.is_grad_enabled():
                return checkpoint(mod, *args, use_reentrant=False, **kw)
            return mod(*args, **kw)

        h = self.conv_in(x)
        skips = [h]
        for i, blk in enumerate(self.down_blocks):
            has_attn = i < self.n - 1
            for j in range(self.layers):
                h = run(blk.resnets[j], h, temb_f)
                if has_attn:
                    h, bank = run(blk.attentions[j], h, ctx_f, ref=ref(f"down_{i}_{j}"),
                                  write=write)
                    out_banks[f"down_{i}_{j}"] = bank
                if self.motion:
                    h = run(mm, blk.motion_modules[j], h)
                skips.append(h)
            if has_attn:
                h = blk.downsamplers[0].conv(h)
                skips.append(h)
            if self.man and motion_map is not None:
                h = run(self.man_blocks[i], h, motion_map)

        h = run(self.mid_block.resnets[0], h, temb_f)
        h, bank = run(self.mid_block.attentions[0], h, ctx_f, ref=ref("mid"), write=write)
        out_banks["mid"] = bank
        if self.motion:
            h = run(mm, self.mid_block.motion_modules[0], h)
        h = run(self.mid_block.resnets[1], h, temb_f)

        for i, blk in enumerate(self.up_blocks):
            has_attn = i > 0
            for j in range(self.layers + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = run(blk.resnets[j], h, temb_f)
                if has_attn:
                    h, bank = run(blk.attentions[j], h, ctx_f, ref=ref(f"up_{i}_{j}"),
                                  write=write)
                    out_banks[f"up_{i}_{j}"] = bank
                if self.motion:
                    h = run(mm, blk.motion_modules[j], h)
            if i < self.n - 1:
                h = torch.nn.functional.interpolate(h, scale_factor=2, mode="nearest")
                h = blk.upsamplers[0].conv(h)

        h = self.conv_out(torch.nn.functional.silu(self.conv_norm_out(h)))
        return h, out_banks


# ---------------------------------------------------------------------------
# the KL autoencoder twin (diffusers AutoencoderKL's structure and keys)
# ---------------------------------------------------------------------------


class TVAEResnet(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(groups, cout, eps=1e-6)
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

    def __init__(self, c, groups):
        super().__init__()
        self.quant = None  # the control's rounding of the products' operands
        self.group_norm = GroupNorm(groups, c, eps=1e-6)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).reshape(B, C, H * W).transpose(1, 2)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        h = attend(q.unsqueeze(1), k.unsqueeze(1), v.unsqueeze(1), C**-0.5,
                   self.quant).squeeze(1)
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
    def __init__(self, c, groups):
        super().__init__()
        self.resnets = nn.ModuleList([TVAEResnet(c, c, groups), TVAEResnet(c, c, groups)])
        self.attentions = nn.ModuleList([TVAEAttention(c, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class TVAEEncoder(nn.Module):
    def __init__(self, ch, groups, layers):
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
        self.conv_norm_out = GroupNorm(groups, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * 4, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for b in self.down_blocks:
            h = b(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class TVAEDecoder(nn.Module):
    def __init__(self, ch, groups, layers):
        super().__init__()
        rev = list(reversed(ch))
        self.conv_in = nn.Conv2d(4, rev[0], 3, padding=1)
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
        self.conv_norm_out = GroupNorm(groups, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], 3, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for b in self.up_blocks:
            h = b(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class TAutoencoderKL(nn.Module):
    """The KL autoencoder at the widths it is given (sd-vae-ft-mse: (128, 256,
    512, 512), 32 groups, 2 layers)."""

    def __init__(self, ch, groups, layers):
        super().__init__()
        self.encoder = TVAEEncoder(ch, groups, layers)
        self.decoder = TVAEDecoder(ch, groups, layers)
        self.quant_conv = nn.Conv2d(2 * 4, 2 * 4, 1)
        self.post_quant_conv = nn.Conv2d(4, 4, 1)


# ---------------------------------------------------------------------------
# the CLIP image tower (Hugging Face CLIPVisionModelWithProjection's keys)
# ---------------------------------------------------------------------------


class TCLIPLayer(nn.Module):
    def __init__(self, dim, heads, inner, eps):
        super().__init__()
        self.heads = heads
        self.quant = None
        self.layer_norm1 = nn.LayerNorm(dim, eps=eps)
        self.self_attn = _Blank()
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, n, nn.Linear(dim, dim))
        self.layer_norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = _Blank()
        self.mlp.fc1 = nn.Linear(dim, inner)
        self.mlp.fc2 = nn.Linear(inner, dim)

    def forward(self, x):
        a = self.self_attn
        h = self.layer_norm1(x)
        B, S, C = h.shape
        d = C // self.heads

        def split(t):
            return t.view(B, S, self.heads, d).transpose(1, 2)

        o = attend(split(a.q_proj(h)), split(a.k_proj(h)), split(a.v_proj(h)), d**-0.5,
                   self.quant)
        x = x + a.out_proj(o.transpose(1, 2).reshape(B, S, C))
        h = self.mlp.fc1(self.layer_norm2(x))
        return x + self.mlp.fc2(h * torch.sigmoid(1.702 * h))  # quick GELU


class TCLIPVision(nn.Module):
    """pixel values (B, size, size, 3), CLIP-normalized -> the projected
    token sequence (B, 1 + patches, projection): embeddings, pre-LayerNorm,
    the encoder layers, post-LayerNorm over every token, projection."""

    def __init__(self, image_size=224, patch=14, dim=1024, inner=4096, layers=24, heads=16,
                 projection=768, eps=1e-5):
        super().__init__()
        vm = self.vision_model = _Blank()
        vm.embeddings = _Blank()
        vm.embeddings.class_embedding = nn.Parameter(torch.zeros(dim))
        vm.embeddings.patch_embedding = nn.Conv2d(3, dim, patch, stride=patch, bias=False)
        vm.embeddings.position_embedding = nn.Embedding((image_size // patch) ** 2 + 1, dim)
        vm.pre_layrnorm = nn.LayerNorm(dim, eps=eps)
        vm.encoder = _Blank()
        vm.encoder.layers = nn.ModuleList([TCLIPLayer(dim, heads, inner, eps)
                                           for _ in range(layers)])
        vm.post_layernorm = nn.LayerNorm(dim, eps=eps)
        self.visual_projection = nn.Linear(dim, projection, bias=False)

    def forward(self, pixels):
        vm, e = self.vision_model, self.vision_model.embeddings
        x = e.patch_embedding(pixels.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)
        cls = e.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + e.position_embedding.weight[None]
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x))
