"""Attention dispatch and the flash kernels.

Kernels (``csrc/flash_attention.cu``, K9 in ``csrc/flash_resident.cu``, K10
and K11 in ``csrc/flash_anchor.cu``), each beside its plain PyTorch version:

- K1 ``flash_attention_fullc``: packed-heads self-attention (UNet levels
  with S >= 1024), replacing ``_flash_kernel_fullc_nt``.
- K2 ``cross_attention``: S >= 1024 queries against <= 512 keys (the CLIP
  context), replacing ``_cross_kernel_fullc``.
- K4 ``flash_attention_wide``: the VAE mid-block's one head of width 512
  (the route of every head width that is a multiple of 128) where one head's
  K and V exceed ``RESIDENT_KV_BYTES``, replacing ``_flash_kernel``.
- K9 ``flash_attention_resident``: the same heads below that size (S <= 3072
  at width 512: every picture under 512^2), replacing
  ``_flash_kernel_resident``.

- K12 ``flash_attention_fullc_t`` (``csrc/flash_fullc_t.cu``): packed-heads
  self-attention with the anchor rounded to bf16 and folded into the Q K^T
  product and both products transposed, replacing ``_flash_kernel_fullc_t``:
  K1's place above the resident limit while only ``NEUTRAL_FULLC`` is off (the
  transposed configuration: the 5184-token level of 576^2 training).
- K10 / K11 ``flash_attention_fullc_anchored``: packed-heads self-attention
  with the self-score anchor and the +-100 clamp in place of the running
  maximum, replacing ``_flash_kernel_fullc_resident`` (K10, a batch element's
  K and V under ``FULLC_RESIDENT_BYTES``: the 2304-token level) and
  ``_flash_kernel_fullc_stream`` (K11, above it: the 9216-token level). They
  take K1's place while ``TRANSPOSED_FULLC`` and ``NEUTRAL_FULLC`` are off
  (the row-major configuration).

The plain version of K1, K2, K4 and K9 is ``dot_product_attention`` (the JAX
package's ``models/layers.py:60`` math: fp32 scores and softmax, weights cast
to v's dtype), processed in chunks of the batch x head dimension so the
score tensor stays bounded; that of K10 and K11 is ``anchored_attention``,
which is the same function only while the clamp does not bite; that of K12
is ``anchored_attention`` with the anchor rounded to bf16 before it is
subtracted.

Every wrapper is differentiable (``_autograd.differentiable``): the backward
of all of them is the chunked dense recompute of the exact softmax
(``_autograd.flash_backward``), as the JAX package's ``_flash_bwd``.

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. ``attention`` routes
shapes as the JAX dispatcher does on its TPU (``flash_attention.py:945-963``,
with ``flash_attention_padded``'s choice between its two kernels, :690).
"""

from __future__ import annotations

import functools
import math

import torch

from ._autograd import differentiable, flash_vjp
from ._build import CudaKernel
from .temporal_attention import MAX_FRAMES, small_sequence_attention, temporal_attention

_SRC = "mikudance_tpu_torch/csrc/flash_attention.cu"
_TPU = "mikudance_tpu/kernels/flash_attention.py"
K1 = CudaKernel("K1 flash_attention_fullc", "md_flash_fullc", _SRC, f"{_TPU}:485")
K2 = CudaKernel("K2 cross_attention", "md_flash_cross", _SRC, f"{_TPU}:598")
K4 = CudaKernel("K4 flash_attention_wide", "md_flash_wide", _SRC, f"{_TPU}:44")
K9 = CudaKernel("K9 flash_attention_resident", "md_flash_resident",
                "mikudance_tpu_torch/csrc/flash_resident.cu", f"{_TPU}:85")
_SRC_ANCHOR = "mikudance_tpu_torch/csrc/flash_anchor.cu"
K10 = CudaKernel("K10 flash_anchor_resident", "md_flash_anchor_resident", _SRC_ANCHOR,
                 f"{_TPU}:158")
K11 = CudaKernel("K11 flash_anchor_stream", "md_flash_anchor_stream", _SRC_ANCHOR,
                 f"{_TPU}:209")
K12 = CudaKernel("K12 flash_attention_fullc_t", "md_flash_fullc_t",
                 "mikudance_tpu_torch/csrc/flash_fullc_t.cu", f"{_TPU}:357")

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
# Head widths the kernels take, the main path's (the CUDA source
# instantiates only these): packed K1/K2 at UNet levels 0 and 1, wide K4 in
# the VAE mid-block.
PACKED_HEAD_DIMS = (40, 80)
WIDE_HEAD_DIMS = (512,)
# One head's bf16 K and V together, up to which the JAX package keeps them on
# chip and K9 keeps a block's whole score rows in shared memory.
RESIDENT_KV_BYTES = 6 * 1024 * 1024
# Batches from which sequences of <= MAX_FRAMES tokens go to K13.
SMALL_SEQUENCE_MIN_BATCH = 64


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
    the subtraction, which is K12's function (``anchored_attention_t``)."""
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
    """The plain version of K12: what the JAX package's ``_flash_kernel_fullc_t``
    computes. ``anchored_attention`` with the anchor rounded to bf16, as it is
    when it rides the Q K^T product as one more bf16 column. The rounding is a
    factor on a whole row of p that cancels in ``acc / l`` until the clamp
    bites; from there K12 and K10 / K11 clip different scores."""
    return anchored_attention(q, k, v, heads, round_anchor=True)


def anchor_excursion(q: torch.Tensor, k: torch.Tensor, heads: int) -> float:
    """The largest ``|s - off|`` of the anchored scores, in log2 units: past
    ``EXP_CLAMP`` the clamp bites and K10 / K11 leave the exact softmax."""
    return max((s - off).abs().max().item() for _, s, off in _anchored_chunks(q, k, heads))


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
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device
           for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must be contiguous bf16 on one device")
    if any(t.data_ptr() % 16 for t in (q, k, v)):  # the kernels' 16-byte row loads
        raise ValueError(f"{name}: q, k, v must start on a 16-byte boundary")
    B, _, C = q.shape
    if C % heads or C // heads not in head_dims:
        raise ValueError(f"{name}: head width {C / heads} not in {head_dims}")
    if B * heads > 65535:
        raise ValueError(f"{name}: batch x heads = {B * heads} exceeds the grid limit")
    return C // heads


def _launch(kernel: CudaKernel, q, k, v, *dims) -> torch.Tensor:
    o = torch.empty_like(q)
    kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *dims,
                  torch.cuda.current_stream(q.device).cuda_stream)
    return o


def _differentiable(fn):
    """``fn(q, k, v, heads)`` with the flash backward (``_autograd``)."""

    @functools.wraps(fn)
    def wrapper(q, k, v, heads: int) -> torch.Tensor:
        return differentiable(lambda a, b, c: fn(a, b, c, heads), flash_vjp(heads), q, k, v)

    return wrapper


@_differentiable
def flash_attention_fullc(q, k, v, heads: int) -> torch.Tensor:
    """K1: packed-heads self-attention, q/k/v (B, S, C)."""
    if q.device.type == "cpu":
        return dot_product_attention(q, k, v, heads)
    hd = _check_cuda("flash_attention_fullc", q, k, v, heads, PACKED_HEAD_DIMS)
    if k.shape[1] != q.shape[1]:
        raise ValueError("flash_attention_fullc: self-attention needs S_kv == S")
    return _launch(K1, q, k, v, q.shape[0], q.shape[1], heads, hd)


def _check_anchored(name: str, q, k, v, heads: int) -> int:
    hd = _check_cuda(name, q, k, v, heads, PACKED_HEAD_DIMS)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"{name}: self-attention needs S_kv == S")
    return hd


@_differentiable
def flash_anchor_resident(q, k, v, heads: int) -> torch.Tensor:
    """K10: anchored packed-heads self-attention, K/V fragments from L2."""
    if q.device.type == "cpu":
        return anchored_attention(q, k, v, heads)
    hd = _check_anchored("flash_anchor_resident", q, k, v, heads)
    if hd == 40 and heads % 2:  # heads of 40 are read in aligned pairs
        raise ValueError("flash_anchor_resident: head width 40 needs an even number of heads")
    if any(t.data_ptr() % 32 for t in (q, k, v)):  # fragment loads from global memory
        raise ValueError("flash_anchor_resident: q, k, v must start on a 32-byte boundary")
    return _launch(K10, q, k, v, q.shape[0], q.shape[1], heads, hd)


@_differentiable
def flash_anchor_stream(q, k, v, heads: int) -> torch.Tensor:
    """K11: anchored packed-heads self-attention, key tiles staged through
    shared memory."""
    if q.device.type == "cpu":
        return anchored_attention(q, k, v, heads)
    hd = _check_anchored("flash_anchor_stream", q, k, v, heads)
    return _launch(K11, q, k, v, q.shape[0], q.shape[1], heads, hd)


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
    (``flash_attention.py:436``), q/k/v (B, S, C) in and out; any S."""
    if q.device.type == "cpu":
        return anchored_attention_t(q, k, v, heads)
    hd = _check_anchored("flash_attention_fullc_t", q, k, v, heads)
    return _launch(K12, q, k, v, q.shape[0], q.shape[1], heads, hd)


@_differentiable
def cross_attention(q, k, v, heads: int) -> torch.Tensor:
    """K2: q (B, S, C) against a short k/v (B, S_kv, C)."""
    if q.device.type == "cpu":
        return dot_product_attention(q, k, v, heads)
    hd = _check_cuda("cross_attention", q, k, v, heads, PACKED_HEAD_DIMS)
    return _launch(K2, q, k, v, q.shape[0], q.shape[1], k.shape[1], heads, hd)


@_differentiable
def flash_attention_wide(q, k, v, heads: int) -> torch.Tensor:
    """K4: self-attention with one head of width 512 per (B, S, C) row."""
    if q.device.type == "cpu":
        return dot_product_attention(q, k, v, heads)
    hd = _check_cuda("flash_attention_wide", q, k, v, heads, WIDE_HEAD_DIMS)
    if k.shape[1] != q.shape[1]:
        raise ValueError("flash_attention_wide: self-attention needs S_kv == S")
    return _launch(K4, q, k, v, q.shape[0], q.shape[1], heads, hd)


def resident_kv(S_kv: int, hd: int) -> bool:
    """Whether one head's bf16 K and V fit ``RESIDENT_KV_BYTES``."""
    return 2 * S_kv * hd * 2 <= RESIDENT_KV_BYTES


@_differentiable
def flash_attention_resident(q, k, v, heads: int) -> torch.Tensor:
    """K9: self-attention with heads of width 512 over S <= 3072 tokens."""
    if q.device.type == "cpu":
        return dot_product_attention(q, k, v, heads)
    hd = _check_cuda("flash_attention_resident", q, k, v, heads, WIDE_HEAD_DIMS)
    if k.shape[1] != q.shape[1] or not resident_kv(k.shape[1], hd):
        raise ValueError(f"flash_attention_resident: needs S_kv == S and S_kv * {hd} * 4 <= "
                         f"{RESIDENT_KV_BYTES} bytes, got S = {q.shape[1]}, S_kv = {k.shape[1]}")
    if any(t.data_ptr() % 32 for t in (q, k, v)):  # fragment loads from global memory
        raise ValueError("flash_attention_resident: q, k, v must start on a 32-byte boundary")
    return _launch(K9, q, k, v, q.shape[0], q.shape[1], heads, hd)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Dispatching attention, by shape as the JAX dispatcher on its TPU, in
    its order:

    - 4-D (B, T, P, C) -> K3, temporal attention across frames;
    - 3-D, S_q = S_kv <= 32 and B >= 64 -> K13, many short sequences;
    - S_q = S_kv >= 1024, head width not a multiple of 128 -> K1 while
      ``TRANSPOSED_FULLC`` and ``NEUTRAL_FULLC`` are on (the default); K10 or
      K11 by ``fullc_resident`` while both are off; with only
      ``TRANSPOSED_FULLC`` on, K10 under the resident limit and K12 above it;
    - S_q = S_kv >= 1024, head width a multiple of 128 -> K9 while one
      head's K and V fit ``RESIDENT_KV_BYTES``, else K4;
    - S_q >= 1024 against S_kv <= 512 keys -> K2;
    - anything else (the 576- and 144-token UNet levels, tiny shapes) ->
      the plain math, which is what the JAX package leaves to XLA.
    """
    if q.ndim == 4:
        return temporal_attention(q, k, v, heads)
    S_q, S_kv = q.shape[1], k.shape[1]
    hd = q.shape[-1] // heads
    if S_q == S_kv and S_q <= MAX_FRAMES and q.shape[0] >= SMALL_SEQUENCE_MIN_BATCH:
        return small_sequence_attention(q, k, v, heads)
    if S_q == S_kv and S_q >= 1024:
        if hd % 128:
            if NEUTRAL_FULLC and TRANSPOSED_FULLC:
                return flash_attention_fullc(q, k, v, heads)
            if TRANSPOSED_FULLC and not fullc_resident(S_kv, q.shape[-1], heads):
                return flash_attention_fullc_t(q, k, v, heads)
            return flash_attention_fullc_anchored(q, k, v, heads)
        if resident_kv(S_kv, hd):
            return flash_attention_resident(q, k, v, heads)
        return flash_attention_wide(q, k, v, heads)
    if S_q >= 1024 and S_kv <= 512:
        return cross_attention(q, k, v, heads)
    return dot_product_attention(q, k, v, heads)

