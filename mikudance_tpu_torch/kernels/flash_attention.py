"""Attention dispatch and the three flash kernels of the main path.

Kernels (``csrc/flash_attention.cu``), each beside its plain PyTorch version:

- K1 ``flash_attention_fullc``: packed-heads self-attention (UNet levels
  with S >= 1024), replacing ``_flash_kernel_fullc_nt``.
- K2 ``cross_attention``: S >= 1024 queries against <= 512 keys (the CLIP
  context), replacing ``_cross_kernel_fullc``.
- K4 ``flash_attention_wide``: the VAE mid-block's one head of width 512
  (the route of every head width that is a multiple of 128), replacing
  ``_flash_kernel``.

The plain version of all three is ``dot_product_attention`` (the JAX
package's ``models/layers.py:60`` math: fp32 scores and softmax, weights cast
to v's dtype), processed in chunks of the batch x head dimension so the
score tensor stays bounded.

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. ``attention`` routes
shapes exactly as the JAX dispatcher does (``flash_attention.py:929-963``).
"""

from __future__ import annotations

import math

import torch

from ._build import CudaKernel
from .temporal_attention import temporal_attention

_SRC = "mikudance_tpu_torch/csrc/flash_attention.cu"
_TPU = "mikudance_tpu/kernels/flash_attention.py"
K1 = CudaKernel("K1 flash_attention_fullc", "md_flash_fullc", _SRC, f"{_TPU}:485")
K2 = CudaKernel("K2 cross_attention", "md_flash_cross", _SRC, f"{_TPU}:598")
K4 = CudaKernel("K4 flash_attention_wide", "md_flash_wide", _SRC, f"{_TPU}:44")

# Upper bound on the fp32 score bytes one chunk of the plain version holds.
PLAIN_SCORE_BYTES = 1 << 30
# Head widths the kernels take, the main path's (the CUDA source
# instantiates only these): packed K1/K2 at UNet levels 0 and 1, wide K4 in
# the VAE mid-block.
PACKED_HEAD_DIMS = (40, 80)
WIDE_HEAD_DIMS = (512,)


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


def flash_attention_fullc(q, k, v, heads: int) -> torch.Tensor:
    """K1: packed-heads self-attention, q/k/v (B, S, C)."""
    if q.device.type == "cpu":
        return dot_product_attention(q, k, v, heads)
    hd = _check_cuda("flash_attention_fullc", q, k, v, heads, PACKED_HEAD_DIMS)
    if k.shape[1] != q.shape[1]:
        raise ValueError("flash_attention_fullc: self-attention needs S_kv == S")
    return _launch(K1, q, k, v, q.shape[0], q.shape[1], heads, hd)


def cross_attention(q, k, v, heads: int) -> torch.Tensor:
    """K2: q (B, S, C) against a short k/v (B, S_kv, C)."""
    if q.device.type == "cpu":
        return dot_product_attention(q, k, v, heads)
    hd = _check_cuda("cross_attention", q, k, v, heads, PACKED_HEAD_DIMS)
    return _launch(K2, q, k, v, q.shape[0], q.shape[1], k.shape[1], heads, hd)


def flash_attention_wide(q, k, v, heads: int) -> torch.Tensor:
    """K4: self-attention with one head of width 512 per (B, S, C) row."""
    if q.device.type == "cpu":
        return dot_product_attention(q, k, v, heads)
    hd = _check_cuda("flash_attention_wide", q, k, v, heads, WIDE_HEAD_DIMS)
    if k.shape[1] != q.shape[1]:
        raise ValueError("flash_attention_wide: self-attention needs S_kv == S")
    return _launch(K4, q, k, v, q.shape[0], q.shape[1], heads, hd)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Dispatching attention, shape for shape as the JAX dispatcher:

    - 4-D (B, T, P, C) -> K3, temporal attention across frames;
    - S_q = S_kv >= 1024, head width not a multiple of 128 -> K1;
    - S_q = S_kv >= 1024, head width a multiple of 128 -> K4;
    - S_q >= 1024 against S_kv <= 512 keys -> K2;
    - anything else (the 576- and 144-token UNet levels, tiny shapes) ->
      the plain math, which is what the JAX package leaves to XLA.
    """
    if q.ndim == 4:
        return temporal_attention(q, k, v, heads)
    S_q, S_kv = q.shape[1], k.shape[1]
    hd = q.shape[-1] // heads
    if S_q == S_kv and S_q >= 1024:
        if hd % 128:
            return flash_attention_fullc(q, k, v, heads)
        return flash_attention_wide(q, k, v, heads)
    if S_q >= 1024 and S_kv <= 512:
        return cross_attention(q, k, v, heads)
    return dot_product_attention(q, k, v, heads)

