"""Attention over at most 32 tokens: across frames, and over tiny maps.

K3 (``csrc/temporal_attention.cu``) replaces the TPU kernel
``mikudance_tpu/kernels/temporal_attention.py::_temporal_kernel_btpc`` on the
motion module's (B, T, P, C) layout. ``temporal_attention_plain`` is its
plain PyTorch version, the math of the JAX package's
``temporal_attention_xla`` (:160).

K13 (``csrc/small_attention.cu``) replaces ``_temporal_kernel`` (:29, entry
``temporal_attention_fused``) on (N, T, C): N independent sequences of
T <= 32 tokens, the UNet mid-block's spatial self-attention once its map has
shrunk that far. ``small_sequence_attention_plain`` is its plain version,
the same math as ``temporal_attention_plain`` with one position a sequence.

Dispatch is by the tensor's device alone: a CPU tensor goes to the plain
version; a CUDA tensor launches the kernel or raises. Both wrappers are
differentiable: the backward is the vector-Jacobian product of the plain
version, as in the JAX package (``temporal_attention.py:239, 252``).
"""

from __future__ import annotations

import math

import torch

from ._autograd import differentiable, plain_vjp
from ._build import CudaKernel

K3 = CudaKernel(
    "K3 temporal_attention", "md_temporal_attention",
    source="mikudance_tpu_torch/csrc/temporal_attention.cu",
    replaces="mikudance_tpu/kernels/temporal_attention.py:120",
)

K13 = CudaKernel(
    "K13 small_sequence_attention", "md_small_attention",
    source="mikudance_tpu_torch/csrc/small_attention.cu",
    replaces="mikudance_tpu/kernels/temporal_attention.py:29",
)

MAX_FRAMES = 32
# Head widths K13 takes: the UNet's 8 heads at 320, 640 and 1280 channels.
SMALL_HEAD_DIMS = (40, 80, 160)
# Upper bound on the fp32 score bytes one chunk of the plain version holds.
PLAIN_SCORE_BYTES = 1 << 30


def temporal_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             heads: int) -> torch.Tensor:
    """Per-position attention across frames: fp32 scores and softmax, weights
    cast to v's dtype for the P V product. Processed in chunks of positions
    so the score tensor stays bounded."""
    B, T, P, C = q.shape
    hd = C // heads
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(v)
    n = max(1, PLAIN_SCORE_BYTES // (B * heads * T * T * 4))
    for p0 in range(0, P, n):
        sl = slice(p0, p0 + n)
        qh = q[:, :, sl].reshape(B, T, -1, heads, hd)
        kh = k[:, :, sl].reshape(B, T, -1, heads, hd)
        vh = v[:, :, sl].reshape(B, T, -1, heads, hd)
        s = torch.einsum("btphd,bsphd->bphts", qh.float(), kh.float()) * scale
        w = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bphts,bsphd->btphd", w, vh)
        out[:, :, sl] = o.reshape(B, T, -1, C)
    return out


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int) -> torch.Tensor:
    """K3 on CUDA tensors, the plain version on CPU tensors."""
    return differentiable(
        lambda a, b, c: _temporal_attention(a, b, c, heads),
        plain_vjp(lambda a, b, c: temporal_attention_plain(a, b, c, heads)), q, k, v)


def _temporal_attention(q, k, v, heads: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return temporal_attention_plain(q, k, v, heads)
    if q.device.type != "cuda":
        raise ValueError(f"temporal_attention: unsupported device {q.device}")
    _check_operands(q, k, v, heads)
    B, T, P, C = q.shape
    o = torch.empty_like(q)
    K3.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, T, P, C, heads,
              torch.cuda.current_stream(q.device).cuda_stream)
    return o


def _check_operands(q, k, v, heads: int) -> None:
    if q.ndim != 4 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"temporal_attention: q, k, v must share a (B, T, P, C) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, P, C = q.shape
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device
           for t in (q, k, v)):
        raise ValueError("temporal_attention: q, k, v must be contiguous bf16 on one device")
    if any(t.data_ptr() % 4 for t in (q, k, v)):  # the kernel's bf16-pair loads
        raise ValueError("temporal_attention: q, k, v must start on a 4-byte boundary")
    if C % heads or (C // heads) % 2 or T > MAX_FRAMES or B > 65535 or heads > 65535:
        raise ValueError(f"temporal_attention: unsupported T={T}, C={C}, heads={heads} "
                         f"(needs an even head width and T <= {MAX_FRAMES})")


def small_sequence_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   heads: int) -> torch.Tensor:
    """Self-attention within each of N sequences (N, T, C): fp32 scores and
    softmax, weights cast to v's dtype for the P V product."""
    return temporal_attention_plain(q[:, :, None], k[:, :, None], v[:, :, None], heads)[:, :, 0]


def small_sequence_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             heads: int) -> torch.Tensor:
    """K13 on CUDA tensors, the plain version on CPU tensors."""
    return differentiable(
        lambda a, b, c: _small_sequence_attention(a, b, c, heads),
        plain_vjp(lambda a, b, c: small_sequence_attention_plain(a, b, c, heads)), q, k, v)


def _small_sequence_attention(q, k, v, heads: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return small_sequence_attention_plain(q, k, v, heads)
    if q.device.type != "cuda":
        raise ValueError(f"small_sequence_attention: unsupported device {q.device}")
    _check_small_operands(q, k, v, heads)
    N, T, C = q.shape
    o = torch.empty_like(q)
    K13.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), N, T, C, heads,
               torch.cuda.current_stream(q.device).cuda_stream)
    return o


def _check_small_operands(q, k, v, heads: int) -> None:
    if q.ndim != 3 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"small_sequence_attention: q, k, v must share an (N, T, C) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    N, T, C = q.shape
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device
           for t in (q, k, v)):
        raise ValueError("small_sequence_attention: q, k, v must be contiguous bf16 on one "
                         "device")
    if any(t.data_ptr() % 4 for t in (q, k, v)):  # the kernel's bf16-pair loads
        raise ValueError("small_sequence_attention: q, k, v must start on a 4-byte boundary")
    if C % heads or C // heads not in SMALL_HEAD_DIMS or not 1 <= T <= MAX_FRAMES \
            or heads > 65535:
        raise ValueError(f"small_sequence_attention: unsupported T={T}, C={C}, heads={heads} "
                         f"(needs a head width in {SMALL_HEAD_DIMS} and T <= {MAX_FRAMES})")
