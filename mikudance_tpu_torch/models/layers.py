"""Shared layers: time embeddings, norms, attention, transformer blocks.

Port of ``mikudance_tpu/models/layers.py``. Parameter names follow the
reference checkpoint's key grammar (diffusers ``Attention``,
``FeedForward``, ``BasicTransformerBlock``, ``Transformer2DModel``), so a
module's ``state_dict`` is what ``core.convert`` reads.

The reference-attention "bank" mechanism is functional: write-mode blocks
*return* their normed hidden states; read-mode blocks take the banks either
already projected through their own attn1 K/V weights (``ref_kv``), added to
the self-attention K/V projections, or raw (``ref``), added to the K/V input
— the reference's injection ``W(norm_h + ref)``
(`mutual_mix_attention.py:169-180`), of which the first is the linear
expansion. The CFG-uncond half gets zero bank K/V or no bank at all, which
is plain self-attention.

All token tensors are (B, S, C); all image tensors are NHWC.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import attention as run_attention
from ..kernels.geglu import fused_geglu
from ..kernels.group_norm import fused_group_norm
from ..kernels.layer_norm import fused_layer_norm
from ..kernels.linear import fused_linear

KV = Tuple[torch.Tensor, torch.Tensor]

# Run the read-mode TransformerBlock interior as one row-major chain of the
# norm, linear and attention kernels (TransformerBlock._chain): the JAX
# package's switch of the same name (``models/layers.py:182``), off by
# default, read at call time.
PALLAS_CHAIN = False


def remat_call(enabled: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``; with ``enabled`` and gradients on, under
    ``torch.utils.checkpoint`` (non-reentrant): the call's activations are
    dropped after the forward and recomputed in the backward (the JAX
    package's ``nn.remat``)."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)


def get_timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding, matching diffusers ``Timesteps``.

    timesteps: (B,) float or int; returns (B, dim) float32.
    """
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


class TimestepEmbed(nn.Module):
    """linear -> silu -> linear (diffusers ``TimestepEmbedding``)."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class GroupNorm(nn.Module):
    """GroupNorm(+SiLU) over the last (channel) axis with statistics pooled
    over everything between the first and the last axis; ``weight``/``bias``
    as torch's. Kernel K5 on a CUDA tensor (``kernels/group_norm.py``)."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-5,
                 silu: bool = False):
        super().__init__()
        self.groups, self.eps, self.silu = groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_group_norm(x, self.weight, self.bias, self.groups, self.eps, self.silu)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 statistics, cast back to x's
    dtype: kernel K6 on a CUDA tensor, on the CPU the JAX package's one-pass
    variance E[x^2] - E[x]^2 (``kernels/layer_norm.py``)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm(x, self.weight, self.bias, self.eps)


class Attention(nn.Module):
    """diffusers-style Attention: to_q/to_k/to_v (no bias), to_out.0 (bias).

    ``kv_dim`` differs from ``dim`` for cross-attention (CLIP context: 768).
    Two hooks take step-invariant work out of the denoise loop:

    - ``extra_kv=(k_add, v_add)``: reference-bank K/V, already projected,
      added to the self-attention K/V projections.
    - ``kv=(k, v)``: precomputed K/V replacing the projections entirely
      (the hoisted cross-attention context K/V).
    """

    def __init__(self, dim: int, heads: int, kv_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(kv_dim or dim, dim, bias=False)
        self.to_v = nn.Linear(kv_dim or dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def project_kv(self, ctx: torch.Tensor) -> KV:
        """The K/V projections alone — what ``precompute_*_kv`` hoist."""
        return self.to_k(ctx), self.to_v(ctx)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                extra_kv: Optional[KV] = None, kv: Optional[KV] = None) -> torch.Tensor:
        q = self.to_q(x)
        if kv is not None:
            k, v = kv[0].to(q.dtype), kv[1].to(q.dtype)
        else:
            k, v = self.project_kv(x if context is None else context)
            if extra_kv is not None:
                k = k + extra_kv[0].to(k.dtype)
                v = v + extra_kv[1].to(v.dtype)
        return self.to_out[0](run_attention(q, k, v, self.heads))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_geglu(self.proj(x))  # exact erf GELU (layers.py:413)


class GEGLUFeedForward(nn.Module):
    """dim -> 4*dim GEGLU -> dim (diffusers ``FeedForward``: net.0 = GEGLU,
    net.1 = dropout (identity at inference), net.2 = Linear)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for m in self.net:
            x = m(x)
        return x


class TransformerBlock(nn.Module):
    """Basic transformer block: self-attn (+ bank K/V) / cross / FF.

    - ``write=True`` (guidance UNet): also returns norm_h, the bank entry
      (`mutual_mix_attention.py:140`).
    - ``ref_kv`` given (denoising UNet): the bank K/V are added to the
      self-attention K/V projections (zeros for the uncond half).
    - ``ref`` given (denoising UNet, raw bank of one window group): K/V are
      projected from ``norm_h + ref``.
    - neither: plain self-attention (the uncond pass of the streamed tiers).

    With ``PALLAS_CHAIN`` set, a read-mode call on 3-D tokens with hoisted
    context K/V and no raw bank takes ``_chain``, unless ``remat`` is on.
    ``remat`` (training) recomputes the 4x-wide GEGLU in the backward, nested
    inside the per-block rematerialisation of the UNets.
    """

    def __init__(self, dim: int, heads: int, cross_dim: int = 768, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, kv_dim=cross_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor],
                write: bool = False, ref_kv: Optional[KV] = None,
                ctx_kv: Optional[KV] = None, ref: Optional[torch.Tensor] = None):
        if PALLAS_CHAIN and not write and not self.remat and x.ndim == 3 and ref is None \
                and ctx_kv is not None:
            return self._chain(x, ref_kv, ctx_kv), None
        norm_h = self.norm1(x)
        if ref_kv is None and ref is not None:
            x = x + self.attn1(norm_h, context=norm_h + ref.to(norm_h.dtype))
        else:
            x = x + self.attn1(norm_h, extra_kv=ref_kv)
        x = x + self.attn2(self.norm2(x), context, kv=ctx_kv)
        x = x + remat_call(self.remat, self.ff, self.norm3(x))
        return x, (norm_h if write else None)

    def _chain(self, x: torch.Tensor, ref_kv: Optional[KV], ctx_kv: KV) -> torch.Tensor:
        """The block interior on flattened (B*S, C) rows, every product through
        ``fused_linear`` with the addition that follows it as the residual:
        LN -> q, k + bank K, v + bank V -> attention -> to_out + x -> LN ->
        cross q -> attention -> to_out + x -> LN -> GEGLU pair + x. The same
        function as ``forward``'s standard path, in the JAX ``_chain``'s order
        of operations (``models/layers.py:493-524``)."""
        B, S, C = x.shape
        dt = x.dtype
        heads = self.attn1.heads

        def rows(t: torch.Tensor) -> torch.Tensor:
            return t.to(dt).reshape(B * S, C).contiguous()

        x2 = rows(x)
        hn = fused_layer_norm(x2, self.norm1.weight, self.norm1.bias, self.norm1.eps)
        rk, rv = (None, None) if ref_kv is None else (rows(ref_kv[0]), rows(ref_kv[1]))
        q = fused_linear(hn, self.attn1.to_q.weight, None)
        k = fused_linear(hn, self.attn1.to_k.weight, None, rk)
        v = fused_linear(hn, self.attn1.to_v.weight, None, rv)
        a1 = run_attention(q.view(B, S, C), k.view(B, S, C), v.view(B, S, C), heads)
        out1 = self.attn1.to_out[0]
        x2 = fused_linear(a1.reshape(B * S, C), out1.weight, out1.bias, x2)

        n2 = fused_layer_norm(x2, self.norm2.weight, self.norm2.bias, self.norm2.eps)
        q2 = fused_linear(n2, self.attn2.to_q.weight, None)
        a2 = run_attention(q2.view(B, S, C), ctx_kv[0].to(dt), ctx_kv[1].to(dt), heads)
        out2 = self.attn2.to_out[0]
        x2 = fused_linear(a2.reshape(B * S, C), out2.weight, out2.bias, x2)

        n3 = fused_layer_norm(x2, self.norm3.weight, self.norm3.bias, self.norm3.eps)
        proj, ff_out = self.ff.net[0].proj, self.ff.net[2]
        hf = fused_geglu(fused_linear(n3, proj.weight, proj.bias))
        x2 = fused_linear(hf, ff_out.weight, ff_out.bias, x2)
        return x2.view(B, S, C)


def linear_1x1(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 1x1 conv applied as a Dense over the channel axis of channels-last x
    (the reference's Transformer2DModel projections; weights stay (O, I, 1, 1))."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


class SpatialTransformer(nn.Module):
    """GroupNorm -> proj_in -> ``depth`` TransformerBlocks -> proj_out (+res).

    ``Transformer2DModel``: SD1.5's config (1x1-conv projections, one block,
    ``transformer_blocks.0``) or SDXL's (``linear`` projections, up to ten
    blocks, ``transformer_blocks.0..9``). Every block writes and reads a bank
    of its own."""

    def __init__(self, dim: int, heads: int, cross_dim: int = 768, norm_groups: int = 32,
                 remat: bool = False, depth: int = 1, linear: bool = False):
        super().__init__()
        self.linear = linear
        self.norm = GroupNorm(norm_groups, dim, 1e-6)
        self.proj_in = nn.Linear(dim, dim) if linear else nn.Conv2d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(dim, heads, cross_dim, remat) for _ in range(depth)])
        self.proj_out = nn.Linear(dim, dim) if linear else nn.Conv2d(dim, dim, 1)

    @property
    def block(self) -> TransformerBlock:
        return self.transformer_blocks[0]

    def _project(self, x: torch.Tensor, proj: nn.Module) -> torch.Tensor:
        return proj(x) if self.linear else linear_1x1(x, proj)

    def stack(self, x: torch.Tensor, context: Optional[torch.Tensor], write: bool = False,
              ref_kv: Optional[List[Optional[KV]]] = None,
              ctx_kv: Optional[List[Optional[KV]]] = None,
              ref: Optional[List[Optional[torch.Tensor]]] = None):
        """x: (B, H, W, C). ``ref_kv``, ``ctx_kv`` and ``ref`` hold one entry a
        block (or are None). Returns (h, [bank of each block] or None)."""
        B, H, W, C = x.shape
        h = self._project(self.norm(x), self.proj_in).reshape(B, H * W, C)
        banks = [] if write else None
        for b, blk in enumerate(self.transformer_blocks):
            h, bank = blk(h, context, write=write,
                          ref_kv=None if ref_kv is None else ref_kv[b],
                          ctx_kv=None if ctx_kv is None else ctx_kv[b],
                          ref=None if ref is None else ref[b])
            if write:
                banks.append(bank)
        h = self._project(h, self.proj_out).reshape(B, H, W, C)
        return h + x, banks

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor],
                write: bool = False, ref_kv: Optional[KV] = None,
                ctx_kv: Optional[KV] = None, ref: Optional[torch.Tensor] = None):
        """One-block form: the block's own ``ref_kv`` / ``ctx_kv`` / ``ref``;
        returns (h, its bank or None). Deeper stacks go through ``stack``."""
        if len(self.transformer_blocks) != 1:
            raise ValueError("a stack of several blocks takes per-block banks: use stack()")
        h, banks = self.stack(x, context, write, None if ref_kv is None else [ref_kv],
                              None if ctx_kv is None else [ctx_kv],
                              None if ref is None else [ref])
        return h, (banks[0] if write else None)
