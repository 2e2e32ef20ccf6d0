"""GEGLU over the last axis: ``hidden * gelu(gate)`` of its two halves.

K15 (``csrc/geglu.cu``) replaces no TPU kernel: the JAX package leaves the
GEGLU (``mikudance_tpu/models/layers.py:413``) to XLA, which fuses the
chain, where eager PyTorch runs it as two passes. ``geglu_plain`` is its
plain PyTorch version, the expression the port ran before (exact-erf GELU);
the kernel computes it step for step in the same precision, so the two are
equal bit for bit. It reads the projection's (..., 2I) output once and
writes (..., I): 3 * rows * I * itemsize bytes, against 5 for the two passes.

Dispatch is by the tensor's device alone: a CPU tensor goes to the plain
version; a CUDA tensor launches the kernel or raises. The wrapper is
differentiable; the backward (``geglu_backward``) is plain math that launches
what autograd of the plain version launches, and no more. The kernel takes y
of any leading shape (..., 2I), contiguous, bf16 or fp32, starting on a
16-byte boundary, I a multiple of the 16-byte vector (8 bf16 or 4 fp32
values), fewer than 2^31 such vectors in the output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._autograd import differentiable
from ._build import CudaKernel

K15 = CudaKernel(
    "K15 fused_geglu", "md_geglu",
    source="mikudance_tpu_torch/csrc/geglu.cu",
    replaces="none: XLA's fusion of mikudance_tpu/models/layers.py:413",
)

MAX_VECTORS = 2**31 - 1  # the kernel indexes the output's 16-byte vectors in 32 bits


def geglu_plain(y: torch.Tensor) -> torch.Tensor:
    hidden, gate = y.chunk(2, dim=-1)
    return hidden * F.gelu(gate)  # exact erf GELU (layers.py:413)


def geglu_backward(tensors, g, needs):
    """The gradient of ``geglu_plain`` at y, written into one (..., 2I)
    buffer: d_hidden = g * gelu(gate), d_gate = gelu'(gate) * (g * hidden).
    Four launches, the roundings of autograd through the plain version (its
    two products, ``gelu_backward`` and the concatenation of the halves)."""
    (y,) = tensors
    hidden, gate = y.chunk(2, dim=-1)
    dy = torch.empty_like(y)
    d_hidden, d_gate = dy.chunk(2, dim=-1)
    torch.mul(g, F.gelu(gate), out=d_hidden)
    torch.ops.aten.gelu_backward.grad_input(g * hidden, gate, grad_input=d_gate)
    return [dy]


def _check_operand(y: torch.Tensor) -> tuple[int, int]:
    """Validate what K15 takes; returns (rows, I)."""
    if y.ndim < 1 or y.numel() == 0:
        raise ValueError(f"fused_geglu: need y (..., 2I), got {tuple(y.shape)}")
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_geglu: y must be bf16 or fp32, got {y.dtype}")
    if not y.is_contiguous():
        raise ValueError("fused_geglu: y must be contiguous "
                         f"(shape {tuple(y.shape)}, strides {y.stride()})")
    if y.data_ptr() % 16:
        raise ValueError("fused_geglu: y must start on a 16-byte boundary")
    width, vec = y.shape[-1], 16 // y.element_size()
    if width % (2 * vec):
        raise ValueError(f"fused_geglu: width {width} must be twice a multiple of the "
                         f"{vec}-value vector")
    rows, half = y.numel() // width, width // 2
    if rows * (half // vec) > MAX_VECTORS:
        raise ValueError(f"fused_geglu: {rows} rows of {half} exceed {MAX_VECTORS} vectors")
    return rows, half


def fused_geglu(y: torch.Tensor) -> torch.Tensor:
    """K15 on a CUDA tensor, the plain version on a CPU tensor."""
    return differentiable(_fused_geglu, geglu_backward, y)


def _fused_geglu(y: torch.Tensor) -> torch.Tensor:
    if y.device.type == "cpu":
        return geglu_plain(y)
    if y.device.type != "cuda":
        raise ValueError(f"fused_geglu: unsupported device {y.device}")
    rows, half = _check_operand(y)
    out = y.new_empty(y.shape[:-1] + (half,))
    K15.launch(y.data_ptr(), out.data_ptr(), rows, half, y.dtype is torch.float32,
               torch.cuda.current_stream(y.get_device()).cuda_stream)
    return out
