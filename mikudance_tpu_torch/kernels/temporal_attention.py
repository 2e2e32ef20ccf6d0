"""Temporal attention on the motion module's (B, T, P, C) layout.

K3 (``csrc/temporal_attention.cu``) replaces the TPU kernel
``mikudance_tpu/kernels/temporal_attention.py::_temporal_kernel_btpc``.
``temporal_attention_plain`` is its plain PyTorch version, the math of the
JAX package's ``temporal_attention_xla`` (:160).

Dispatch is by the tensor's device alone: a CPU tensor goes to the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from ._build import CudaKernel

K3 = CudaKernel(
    "K3 temporal_attention", "md_temporal_attention",
    source="mikudance_tpu_torch/csrc/temporal_attention.cu",
    replaces="mikudance_tpu/kernels/temporal_attention.py:120",
)

MAX_FRAMES = 32
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
