"""Attention dispatch and the flash kernels.

Kernels, each beside its plain PyTorch version:

- K1 ``flash_attention_fullc`` (``csrc/flash_anchor_wg.cu``, the warpgroup
  kernel of K10-K12 under its own entry point): packed-heads self-attention
  with the self-score anchor rounded to bf16 and the +-100 clamp in place of
  the running maximum (the UNet levels with S >= 1024 under the default
  switches), replacing ``_flash_kernel_fullc_nt``.
- K2 ``cross_attention`` (``csrc/flash_cross.cu``): S >= 1024 queries
  against <= 512 keys (the CLIP context, held in shared memory), replacing
  ``_cross_kernel_fullc``.
- K4 ``flash_attention_wide`` (``csrc/flash_wide.cu``): the VAE mid-block's
  one head of width 512 (the route of every head width that is a multiple of
  128) where one head's K and V exceed ``RESIDENT_KV_BYTES``, replacing
  ``_flash_kernel``.
- K9 ``flash_attention_resident`` (``csrc/flash_wide.cu``, K4's kernel under
  its own entry point): the same heads below that size (S <= 3072 at width
  512: every picture under 512^2), replacing ``_flash_kernel_resident``.
- K10 / K11 ``flash_attention_fullc_anchored`` and K12
  ``flash_attention_fullc_t``, one warpgroup-MMA kernel with TMA-fed K and V
  (``csrc/flash_anchor_wg.cu``) under three entry points and counters (K1's
  is a fourth):
  packed-heads self-attention with the self-score anchor and the +-100
  clamp. K10 replaces ``_flash_kernel_fullc_resident`` (a batch element's K
  and V under ``FULLC_RESIDENT_BYTES``: the 2304-token level) and K11
  ``_flash_kernel_fullc_stream`` (above it: the 9216-token level), both with
  the anchor in fp32; they take K1's place while ``TRANSPOSED_FULLC`` and
  ``NEUTRAL_FULLC`` are off (the row-major configuration). K12 replaces
  ``_flash_kernel_fullc_t``, K1's function (the anchor rounded to bf16, which
  the TPU kernel folds into Q K^T): K1's place above the resident limit while
  only ``NEUTRAL_FULLC`` is off (the transposed configuration: the 5184-token
  level of 576^2 training).

The plain version of K2, K4 and K9 is ``dot_product_attention`` (the JAX
package's ``models/layers.py:60`` math: fp32 scores and softmax, weights cast
to v's dtype), processed in chunks of the batch x head dimension so the
score tensor stays bounded. That of K10 and K11 is ``anchored_attention``;
that of K1 and K12 is ``anchored_attention_t``, ``anchored_attention`` with the
anchor rounded to bf16 before it is subtracted (the JAX package calls its
two kernels bit-identical, ``flash_attention.py:778-783``). The anchored
functions equal the softmax only while the clamp does not bite.

Operands: q, k and v are each bf16 or fp32, and the output has q's dtype,
as the TPU kernels write ``o_ref.dtype`` from their fp32 accumulators. Every
TPU body rounds its operands to bf16 inside, so an fp32 request runs through
the same kernels by the same routes (both packages count K/V bytes at 2 an
element): K and V go to the kernels cast to bf16, which is where the bodies
round them; q goes as fp32 to the anchored kernel (K1, K10-K12: q' and the
self-score anchor come from the unrounded q), as bf16(q * log2(e) / sqrt(hd))
to K2 (its body's q', scaled in fp32 and rounded once here, the kernel's own
scale then 1), cast to bf16 for K4 and K9 (whose body rounds q first); an
fp32 output is stored from the accumulator, never rounded to bf16. The
rounded plain versions on the card are ``anchored_attention`` /
``anchored_attention_t`` (fp32 q as above), ``cross_attention_rounded`` (K2)
and ``wide_attention_rounded`` (K4, K9).

Every wrapper is differentiable (``_autograd.differentiable``): the backward
of all of them is the chunked dense recompute of the exact softmax
(``_autograd.flash_backward``), as the JAX package's ``_flash_bwd``.

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. ``attention`` routes
shapes as the JAX dispatcher does on its TPU (``flash_attention.py:945-963``,
with its block rule ``pick_blocks`` / ``_use_flash`` and
``flash_attention_padded``'s choice between its two kernels, :690).
"""

from __future__ import annotations

import functools
import math

import torch

from ._autograd import differentiable, flash_vjp
from ._build import CudaKernel
from .temporal_attention import (MAX_FRAMES, rounded_q, small_sequence_attention,
                                 temporal_attention)

_TPU = "mikudance_tpu/kernels/flash_attention.py"
K1 = CudaKernel("K1 flash_attention_fullc", "md_flash_fullc",
                "mikudance_tpu_torch/csrc/flash_anchor_wg.cu", f"{_TPU}:485")
K2 = CudaKernel("K2 cross_attention", "md_flash_cross",
                "mikudance_tpu_torch/csrc/flash_cross.cu", f"{_TPU}:598")
K4 = CudaKernel("K4 flash_attention_wide", "md_flash_wide",
                "mikudance_tpu_torch/csrc/flash_wide.cu", f"{_TPU}:44")
K9 = CudaKernel("K9 flash_attention_resident", "md_flash_resident",
                "mikudance_tpu_torch/csrc/flash_wide.cu", f"{_TPU}:85")
K10 = CudaKernel("K10 flash_anchor_resident", "md_flash_anchor_resident",
                 "mikudance_tpu_torch/csrc/flash_anchor_wg.cu", f"{_TPU}:158")
K11 = CudaKernel("K11 flash_anchor_stream", "md_flash_anchor_stream",
                 "mikudance_tpu_torch/csrc/flash_anchor_wg.cu", f"{_TPU}:209")
K12 = CudaKernel("K12 flash_attention_fullc_t", "md_flash_fullc_t",
                 "mikudance_tpu_torch/csrc/flash_anchor_wg.cu", f"{_TPU}:357")

# The JAX package's routing switches for packed heads (head widths that are
# no multiple of 128), with its defaults (``flash_attention.py:592,595``);
# read at call time. Both on: K1. Both off: K10 / K11 (the row-major
# configuration). Only TRANSPOSED_FULLC on (the transposed configuration): K12
# above the resident limit, K10 under it.
TRANSPOSED_FULLC = True
NEUTRAL_FULLC = True
# A batch element's bf16 K and V with all heads packed, lane-padded as on the
# TPU, up to which the JAX package keeps them on chip (K10) and above which it
# streams key blocks (K11).
FULLC_RESIDENT_BYTES = 7 * 1024 * 1024
LANES = 128
EXP_CLAMP = 100.0  # two-sided log2-domain clamp around the anchor
LOG2E = 1.4426950408889634

# Upper bound on the fp32 score bytes one chunk of the plain version holds.
PLAIN_SCORE_BYTES = 1 << 30
# Keys K2 holds in shared memory: the CLIP context's 257 and more.
MAX_CROSS_KEYS = 512
# Head widths the kernels take (the CUDA sources instantiate these): packed
# K1, K2 and K10-K12 at SD1.5's three UNet levels (320, 640 and 1280 channels
# in 8 heads; level 2 takes a flash route from 1024 tokens, 1024^2 up) and
# at SDXL's (heads of 64: 10 of them at 640 channels, 20 at 1280), wide
# K4 and K9 in the VAE mid-block. K1 also takes heads of 32: the tiny VAE of
# the SD-width fidelity gate (``scripts/psnr_sd_width.py``) has one head of 32
# in its mid-block, 9216 tokens at 768^2, which the JAX package sends to
# ``flash_attention_fullc_nt``.
PACKED_HEAD_DIMS = (40, 64, 80, 160)
FULLC_HEAD_DIMS = (32,) + PACKED_HEAD_DIMS
WIDE_HEAD_DIMS = (512,)
# What q, k and v may each be (the output takes q's dtype).
OPERAND_DTYPES = (torch.bfloat16, torch.float32)
# One head's bf16 K and V together, up to which the JAX package keeps them on
# chip (K9's route; above it, K4's).
RESIDENT_KV_BYTES = 6 * 1024 * 1024
# Batches from which sequences of <= MAX_FRAMES tokens go to K13.
SMALL_SEQUENCE_MIN_BATCH = 64
# The JAX package's (q_block, k_block) table for its TPU
# (``flash_attention.py:900``). The port's kernels use none of these sizes:
# with ``pick_blocks`` they only decide which shapes take a flash route.
TUNED_BLOCKS = {9216: (512, 1024), 2304: (384, 768)}


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int) -> torch.Tensor:
    """Multi-head attention on (B, S, C) tensors with an fp32 softmax."""
    B, Sq, C = q.shape
    Sk = k.shape[1]
    hd = C // heads
    scale = 1.0 / math.sqrt(hd)

    def split(x, s):
        return x.reshape(B, s, heads, hd).transpose(1, 2).reshape(B * heads, s, hd)

    qh, kh, vh = split(q, Sq), split(k, Sk), split(v, Sk)
    out = torch.empty(B * heads, Sq, hd, dtype=v.dtype, device=v.device)
    n = max(1, PLAIN_SCORE_BYTES // (Sq * Sk * 4))
    for i in range(0, B * heads, n):
        s = torch.matmul(qh[i:i + n].float(), kh[i:i + n].float().transpose(1, 2)) * scale
        w = torch.softmax(s, dim=-1).to(v.dtype)
        out[i:i + n] = torch.matmul(w, vh[i:i + n])
    return out.reshape(B, heads, Sq, hd).transpose(1, 2).reshape(B, Sq, C)


def _bf16f(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _rounded_attention(q, k, v, heads: int, step) -> torch.Tensor:
    """Per chunk of batch x heads (fp32 scores bounded as the plain version's),
    ``step(q, k, v)`` on one chunk's (n, S, hd) slices; the output in q's
    dtype."""
    B, Sq, C = q.shape
    Sk = k.shape[1]
    hd = C // heads

    def split(x, s):
        return x.reshape(B, s, heads, hd).transpose(1, 2).reshape(B * heads, s, hd)

    qh, kh, vh = split(q, Sq), split(k, Sk), split(v, Sk)
    out = torch.empty(B * heads, Sq, hd, dtype=q.dtype, device=q.device)
    n = max(1, PLAIN_SCORE_BYTES // (Sq * Sk * 4))
    for i in range(0, B * heads, n):
        out[i:i + n] = step(qh[i:i + n], kh[i:i + n], vh[i:i + n]).to(q.dtype)
    return out.reshape(B, heads, Sq, hd).transpose(1, 2).reshape(B, Sq, C)


def cross_attention_rounded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            heads: int) -> torch.Tensor:
    """What K2's TPU body (``_cross_kernel_fullc``) computes, per head: q' =
    bf16(q * log2(e) / sqrt(hd)) scaled in fp32, s = q' . bf16(k) in fp32, p =
    exp2(s - max s), o = bf16(p / sum p) . bf16(v) in fp32, in q's dtype. The
    kernel rounds p before the division by the sum (over the unrounded p)."""
    mult = 1.0 / math.sqrt(q.shape[-1] // heads) * LOG2E

    def step(qc, kc, vc):
        s = torch.matmul(_bf16f(qc.float() * mult), _bf16f(kc).transpose(1, 2))
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        return torch.matmul(_bf16f(p / p.sum(-1, keepdim=True)), _bf16f(vc))

    return _rounded_attention(q, k, v, heads, step)


def wide_attention_rounded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int) -> torch.Tensor:
    """What K4's and K9's TPU bodies (``_flash_kernel``,
    ``_flash_kernel_resident``) compute, per head: q, k and v rounded to bf16
    first, s = q . k * scale in fp32, p = exp(s - max s), l = sum p over the
    unrounded p, o = (bf16(p) . v) / l in fp32, in q's dtype. The bodies take
    the maximum online, a key block at a time, and round p against the running
    maximum; here against the row's (the same where one block holds every
    key)."""
    scale = 1.0 / math.sqrt(q.shape[-1] // heads)

    def step(qc, kc, vc):
        s = torch.matmul(_bf16f(qc), _bf16f(kc).transpose(1, 2)) * scale
        p = torch.exp(s - s.amax(-1, keepdim=True))
        return torch.matmul(_bf16f(p), _bf16f(vc)) / p.sum(-1, keepdim=True)

    return _rounded_attention(q, k, v, heads, step)


def _anchored_chunks(q, k, heads: int, round_anchor: bool = False):
    """Per chunk of batch x heads: (slice, log2-domain scores from the bf16
    rounded scaled q and bf16 k, the row anchors), all fp32; the anchors
    rounded to bf16 where asked."""
    B, S, C = q.shape
    hd = C // heads

    def split(x):
        return x.reshape(B, x.shape[1], heads, hd).transpose(1, 2).reshape(B * heads, -1, hd)

    qh, kh = split(q).float(), split(k).to(torch.bfloat16).float()
    n = max(1, PLAIN_SCORE_BYTES // (S * k.shape[1] * 4))
    for i in range(0, B * heads, n):
        qf = qh[i:i + n] * (LOG2E / math.sqrt(hd))
        off = (qf * qh[i:i + n]).sum(dim=-1, keepdim=True)
        if round_anchor:
            off = off.to(torch.bfloat16).float()
        s = torch.matmul(qf.to(torch.bfloat16).float(), kh[i:i + n].transpose(1, 2))
        yield slice(i, i + n), s, off


def anchored_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int, round_anchor: bool = False) -> torch.Tensor:
    """The plain version of K10 and K11: what the JAX package's
    ``_flash_kernel_fullc_resident`` / ``_flash_kernel_fullc_stream`` compute
    on (B, S, C) tensors. Per head, ``q' = q * log2(e) / sqrt(hd)`` in fp32,
    the row anchor ``off = sum(q' * q)``, scores from bf16(q') and bf16 k,
    ``p = bf16(exp2(clip(s - off, -100, 100)))`` and ``(p @ v) / sum(p)`` with
    both sums in fp32 over the rounded p. Equal to the softmax while no score
    leaves the clamp; not beyond. ``round_anchor`` rounds ``off`` to bf16 before
    the subtraction, which is K1's and K12's function (``anchored_attention_t``)."""
    B, S, C = q.shape
    hd = C // heads
    vh = v.reshape(B, v.shape[1], heads, hd).transpose(1, 2).reshape(B * heads, -1, hd)
    vh = vh.to(torch.bfloat16).float()
    out = torch.empty(B * heads, S, hd, dtype=q.dtype, device=q.device)
    for sl, s, off in _anchored_chunks(q, k, heads, round_anchor):
        p = torch.exp2((s - off).clamp_(-EXP_CLAMP, EXP_CLAMP)).to(torch.bfloat16).float()
        out[sl] = (torch.matmul(p, vh[sl]) / p.sum(dim=-1, keepdim=True)).to(q.dtype)
    return out.reshape(B, heads, S, hd).transpose(1, 2).reshape(B, S, C)


def anchored_attention_t(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """The plain version of K1 and K12: what the JAX package's
    ``_flash_kernel_fullc_nt`` and ``_flash_kernel_fullc_t`` compute.
    ``anchored_attention`` with the anchor rounded to bf16, as it is when it
    rides the Q K^T product as one more bf16 column. The rounding is a factor
    on a whole row of p that cancels in ``acc / l`` until the clamp bites;
    from there K1 / K12 and K10 / K11 clip different scores."""
    return anchored_attention(q, k, v, heads, round_anchor=True)


def anchor_excursion(q: torch.Tensor, k: torch.Tensor, heads: int) -> float:
    """The largest ``|s - off|`` of the anchored scores, in log2 units: past
    ``EXP_CLAMP`` the clamp bites and K10 / K11 leave the exact softmax."""
    return max((s - off).abs().max().item() for _, s, off in _anchored_chunks(q, k, heads))


def _largest_divisor(S: int, cap: int, mult: int):
    """Largest divisor of S that is <= cap and a multiple of ``mult``, or None."""
    top = min(cap, S)
    for b in range(top - top % mult, mult - 1, -mult):
        if S % b == 0:
            return b
    return None


def pick_blocks(S: int):
    """The JAX package's ``pick_blocks`` (``flash_attention.py:906``):
    (q_block, k_block) dividing S, from the table, then the 128-ladder, then
    any multiple of 16; None where nothing divides."""
    if S in TUNED_BLOCKS:
        return TUNED_BLOCKS[S]
    q_block = next((b for b in (512, 256, 128) if S % b == 0), None)
    k_block = next((b for b in (1024, 512, 256, 128) if S % b == 0), None)
    if q_block is None:
        q_block = _largest_divisor(S, 512, 16)
    if k_block is None:
        k_block = _largest_divisor(S, 1024, 16)
    return q_block, k_block


def _use_flash(S_q: int, S_kv: int) -> bool:
    """The JAX package's ``_use_flash`` (``flash_attention.py:922``): long
    self-attention whose blocks exist, with q_block >= 64."""
    if S_q != S_kv or S_q < 1024:
        return False
    qb, kb = pick_blocks(S_q)
    return qb is not None and kb is not None and qb >= 64


def _lane_padded_bytes(S: int, C: int) -> int:
    return S * ((C + LANES - 1) // LANES) * LANES * 2


def _can_fuse_ones(C: int, heads: int) -> bool:
    """Whether the JAX package appends a ones lane per head to V (it does
    while that does not grow V's lane-padded width); it enters the byte rule."""
    return -C % LANES >= heads


def fullc_resident(S_kv: int, C: int, heads: int) -> bool:
    """The JAX package's byte rule (``flash_attention.py:296``): whether a
    batch element's packed K and V stay under ``FULLC_RESIDENT_BYTES``."""
    Cv = C + heads if _can_fuse_ones(C, heads) else C
    return _lane_padded_bytes(S_kv, C) + _lane_padded_bytes(S_kv, Cv) <= FULLC_RESIDENT_BYTES


def _check_cuda(name: str, q, k, v, heads: int, head_dims) -> int:
    """Validate what the flash kernels take; returns the head width."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return _check_operands(name, q, k, v, heads, head_dims)


def _check_operands(name: str, q, k, v, heads: int, head_dims) -> int:
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: need q (B, S, C) and k, v (B, S_kv, C), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if any(t.dtype not in OPERAND_DTYPES or not t.is_contiguous() or t.device != q.device
           for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must be contiguous bf16 or fp32 on one device, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):  # the kernels' 16-byte row loads
        raise ValueError(f"{name}: q, k, v must start on a 16-byte boundary")
    B, _, C = q.shape
    if C % heads or C // heads not in head_dims:
        raise ValueError(f"{name}: head width {C / heads} not in {head_dims}")
    if B * heads > 65535:
        raise ValueError(f"{name}: batch x heads = {B * heads} exceeds the grid limit")
    return C // heads


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.bfloat16 else t.to(torch.bfloat16)


def _launch(kernel: CudaKernel, dtype: torch.dtype, q, k, v, *dims) -> torch.Tensor:
    """Launch on q as given (what the kernel reads) and k, v in bf16 (every
    TPU body rounds them at load: the cast gives the same bits); the output in
    ``dtype`` (the request's q's), the kernel told whether that is fp32. The
    cast copies live until the launch is queued on the stream."""
    kb, vb = _bf16(k), _bf16(v)
    o = torch.empty(q.shape, dtype=dtype, device=q.device)
    kernel.launch(q.data_ptr(), kb.data_ptr(), vb.data_ptr(), o.data_ptr(), *dims,
                  int(dtype == torch.float32), torch.cuda.current_stream(q.device).cuda_stream)
    return o


def _differentiable(fn):
    """``fn(q, k, v, heads)`` with the flash backward (``_autograd``)."""

    @functools.wraps(fn)
    def wrapper(q, k, v, heads: int) -> torch.Tensor:
        return differentiable(lambda a, b, c: fn(a, b, c, heads), flash_vjp(heads), q, k, v)

    return wrapper


@_differentiable
def flash_attention_fullc(q, k, v, heads: int) -> torch.Tensor:
    """K1: the counterpart of the JAX package's ``flash_attention_fullc_nt``
    (``flash_attention.py:546``): packed-heads self-attention with the anchor
    rounded to bf16 (``anchored_attention_t``), q/k/v (B, S, C); any S. K12's
    kernel under K1's entry point and counter, under TMA's 16-byte rule; also
    heads of 32 (``FULLC_HEAD_DIMS``)."""
    if q.device.type == "cpu":
        return anchored_attention_t(q, k, v, heads)
    hd = _check_cuda("flash_attention_fullc", q, k, v, heads, FULLC_HEAD_DIMS)
    if k.shape[1] != q.shape[1]:
        raise ValueError("flash_attention_fullc: self-attention needs S_kv == S")
    return _launch(K1, q.dtype, q, k, v, q.shape[0], q.shape[1], heads, hd)


def _check_anchored(name: str, q, k, v, heads: int) -> int:
    hd = _check_cuda(name, q, k, v, heads, PACKED_HEAD_DIMS)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"{name}: self-attention needs S_kv == S")
    return hd


@_differentiable
def flash_anchor_resident(q, k, v, heads: int) -> torch.Tensor:
    """K10: anchored packed-heads self-attention, warpgroup MMA with K and V
    brought by TMA (whose 16-byte rule on base and row stride
    ``_check_operands`` holds)."""
    if q.device.type == "cpu":
        return anchored_attention(q, k, v, heads)
    hd = _check_anchored("flash_anchor_resident", q, k, v, heads)
    return _launch(K10, q.dtype, q, k, v, q.shape[0], q.shape[1], heads, hd)


@_differentiable
def flash_anchor_stream(q, k, v, heads: int) -> torch.Tensor:
    """K11: K10's kernel under its own entry point and counter (the TPU's
    streamed branch; TMA streams key tiles of any S here)."""
    if q.device.type == "cpu":
        return anchored_attention(q, k, v, heads)
    hd = _check_anchored("flash_anchor_stream", q, k, v, heads)
    return _launch(K11, q.dtype, q, k, v, q.shape[0], q.shape[1], heads, hd)


@_differentiable
def flash_attention_fullc_anchored(q, k, v, heads: int) -> torch.Tensor:
    """K10 / K11: the counterpart of the JAX package's ``flash_attention_fullc``
    (``flash_attention.py:278``; the port's ``flash_attention_fullc`` is K1, the
    counterpart of ``flash_attention_fullc_nt``). Packed-heads self-attention
    with the self-score anchor, q/k/v (B, S, C); K10 while a batch element's
    K and V pass ``fullc_resident``, else K11."""
    if q.device.type == "cpu":
        return anchored_attention(q, k, v, heads)
    if fullc_resident(k.shape[1], q.shape[-1], heads):
        return flash_anchor_resident(q, k, v, heads)
    return flash_anchor_stream(q, k, v, heads)


@_differentiable
def flash_attention_fullc_t(q, k, v, heads: int) -> torch.Tensor:
    """K12: the counterpart of the JAX package's ``flash_attention_fullc_t``
    (``flash_attention.py:436``), q/k/v (B, S, C) in and out; any S. K10's
    kernel with the anchor rounded to bf16, under TMA's 16-byte rule."""
    if q.device.type == "cpu":
        return anchored_attention_t(q, k, v, heads)
    hd = _check_anchored("flash_attention_fullc_t", q, k, v, heads)
    return _launch(K12, q.dtype, q, k, v, q.shape[0], q.shape[1], heads, hd)


@_differentiable
def cross_attention(q, k, v, heads: int) -> torch.Tensor:
    """K2: q (B, S, C) against a short k/v (B, S_kv, C), 1 <= S_kv <= 512. An
    fp32 q is scaled and rounded here, once, to the TPU body's q'."""
    if q.device.type == "cpu":
        return dot_product_attention(q, k, v, heads)
    hd = _check_cuda("cross_attention", q, k, v, heads, PACKED_HEAD_DIMS)
    if not 1 <= k.shape[1] <= MAX_CROSS_KEYS:
        raise ValueError(f"cross_attention: S_kv = {k.shape[1]}, the kernel holds 1 to "
                         f"{MAX_CROSS_KEYS} keys in shared memory")
    qk = q if q.dtype == torch.bfloat16 else rounded_q(q, hd)
    return _launch(K2, q.dtype, qk, k, v, q.shape[0], q.shape[1], k.shape[1], heads, hd)


@_differentiable
def flash_attention_wide(q, k, v, heads: int) -> torch.Tensor:
    """K4: self-attention with one head of width 512 per (B, S, C) row."""
    if q.device.type == "cpu":
        return dot_product_attention(q, k, v, heads)
    hd = _check_cuda("flash_attention_wide", q, k, v, heads, WIDE_HEAD_DIMS)
    if k.shape[1] != q.shape[1]:
        raise ValueError("flash_attention_wide: self-attention needs S_kv == S")
    return _launch(K4, q.dtype, _bf16(q), k, v, q.shape[0], q.shape[1], heads, hd)


def resident_kv(S_kv: int, hd: int) -> bool:
    """Whether one head's bf16 K and V fit ``RESIDENT_KV_BYTES``."""
    return 2 * S_kv * hd * 2 <= RESIDENT_KV_BYTES


@_differentiable
def flash_attention_resident(q, k, v, heads: int) -> torch.Tensor:
    """K9: self-attention with heads of width 512 over S <= 3072 tokens; K4's
    kernel (16-byte aligned rows, cp.async's rule) under K9's entry point."""
    if q.device.type == "cpu":
        return dot_product_attention(q, k, v, heads)
    hd = _check_cuda("flash_attention_resident", q, k, v, heads, WIDE_HEAD_DIMS)
    if k.shape[1] != q.shape[1] or not resident_kv(k.shape[1], hd):
        raise ValueError(f"flash_attention_resident: needs S_kv == S and S_kv * {hd} * 4 <= "
                         f"{RESIDENT_KV_BYTES} bytes, got S = {q.shape[1]}, S_kv = {k.shape[1]}")
    return _launch(K9, q.dtype, _bf16(q), k, v, q.shape[0], q.shape[1], heads, hd)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Dispatching attention, by shape as the JAX dispatcher on its TPU, in
    its order:

    - 4-D (B, T, P, C) -> K3, temporal attention across frames;
    - 3-D, S_q = S_kv <= 32 and B >= 64 -> K13, many short sequences;
    - S_q = S_kv where ``_use_flash`` holds (S >= 1024 and ``pick_blocks``
      finds blocks with q_block >= 64), head width not a multiple of 128 ->
      K1 while ``TRANSPOSED_FULLC`` and ``NEUTRAL_FULLC`` are on (the
      default); K10 or K11 by ``fullc_resident`` while both are off; with
      only ``TRANSPOSED_FULLC`` on, K10 under the resident limit and K12
      above it;
    - the same shapes, head width a multiple of 128 -> K9 while one head's K
      and V fit ``RESIDENT_KV_BYTES``, else K4;
    - S_q >= 1024 against S_kv <= 512 keys, where ``pick_blocks(S_q)`` gives
      q_block >= 64 -> K2;
    - anything else (the 576- and 144-token UNet levels, S with no blocks
      such as 1156 = 34^2, tiny shapes) -> the plain math, which is what the
      JAX package leaves to XLA.
    """
    if q.ndim == 4:
        return temporal_attention(q, k, v, heads)
    S_q, S_kv = q.shape[1], k.shape[1]
    hd = q.shape[-1] // heads
    if S_q == S_kv and S_q <= MAX_FRAMES and q.shape[0] >= SMALL_SEQUENCE_MIN_BATCH:
        return small_sequence_attention(q, k, v, heads)
    if _use_flash(S_q, S_kv):
        if hd % 128:
            if NEUTRAL_FULLC and TRANSPOSED_FULLC:
                return flash_attention_fullc(q, k, v, heads)
            if TRANSPOSED_FULLC and not fullc_resident(S_kv, q.shape[-1], heads):
                return flash_attention_fullc_t(q, k, v, heads)
            return flash_attention_fullc_anchored(q, k, v, heads)
        if resident_kv(S_kv, hd):
            return flash_attention_resident(q, k, v, heads)
        return flash_attention_wide(q, k, v, heads)
    if S_q >= 1024 and S_kv <= MAX_CROSS_KEYS:
        q_block = pick_blocks(S_q)[0]
        if q_block is not None and q_block >= 64:
            return cross_attention(q, k, v, heads)
    return dot_product_attention(q, k, v, heads)

