"""Row-major fused linear on token rows.

K7 (``csrc/linear.cu``) replaces the TPU kernels
``mikudance_tpu/kernels/linear.py::_linear_kernel`` and ``_linear_res_kernel``:
``y = cast(x @ W^T + b) [+ residual]`` with the sum and the bias in fp32, one
cast to x's dtype, then the residual added in that dtype (two roundings, in
that order). ``linear_plain`` is its plain PyTorch version. Its only caller
is the transformer block's row-major chain (``models/layers.py``).

``w`` is an ``nn.Linear`` weight ``(Cout, Cin)``: W^T row-major, which the
kernel reads in place as its K-major right operand. The kernel is the
warpgroup GEMM core of ``csrc/gemm_wg.cuh`` (wgmma, operands by TMA), which
K8 shares; ``_gemm_plan.column_tile`` is the tile width both launch it with.

Dispatch is by the tensor's device alone: a CPU tensor goes to the plain
version; a CUDA tensor launches the kernel or raises. The wrapper is
differentiable: the backward is the vector-Jacobian product of the plain
version, as in the JAX package (``linear.py:131``), with no gradient for an
absent bias or residual. The kernel takes bf16
``x`` of any leading shape ``(..., Cin)``, contiguous and 16-byte aligned,
``Cin`` and ``Cout`` multiples of 8, a bf16 weight, a bf16 or fp32 bias (or
none) and a bf16 residual of the output's shape (or none). fp32 operands
raise: the TPU body multiplies fp32 operands at ``Precision.DEFAULT``, and
what that is inside Mosaic the code does not settle, so K7 stays bf16-only
(the row-major configuration is for bf16 requests).
"""

from __future__ import annotations

from typing import Optional

import torch

from ._autograd import differentiable, plain_vjp
from ._build import CudaKernel
from ._gemm_plan import column_tile

K7 = CudaKernel(
    "K7 fused_linear", "md_linear",
    source="mikudance_tpu_torch/csrc/linear.cu",
    replaces="mikudance_tpu/kernels/linear.py:48",
)


MAX_ROWS = 2 ** 31 - 1 - 128  # the last row tile starts at a 32-bit TMA coordinate


def linear_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w.T + b`` in fp32, cast to x's dtype, then ``+ residual``."""
    y = torch.matmul(x.float(), w.to(x.dtype).float().t())
    if b is not None:
        y = y + b.float()
    y = y.to(x.dtype)
    if residual is not None:
        y = y + residual.to(x.dtype)
    return y


def _check_operands(x, w, b, residual) -> None:
    if x.ndim < 1 or x.numel() == 0 or w.ndim != 2 or w.shape[1] != x.shape[-1]:
        raise ValueError(f"fused_linear: need x (..., Cin) and w (Cout, Cin), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    cout, cin = w.shape
    if cin % 8 or cout % 8:
        raise ValueError(f"fused_linear: Cin {cin} and Cout {cout} must be multiples of the "
                         "8-element (16-byte) vector")
    if x.numel() // cin > MAX_ROWS:
        raise ValueError(f"fused_linear: {x.numel() // cin} rows, more than TMA's 32-bit "
                         f"coordinates reach ({MAX_ROWS})")
    operands = [("x", x, x.shape), ("w", w, w.shape)]
    if residual is not None:
        operands.append(("residual", residual, x.shape[:-1] + (cout,)))
    for name, t, shape in operands:
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != x.device \
                or tuple(t.shape) != tuple(shape):
            raise ValueError(f"fused_linear: {name} must be a contiguous bf16 tensor of shape "
                             f"{tuple(shape)} on x's device, got {t.dtype} {tuple(t.shape)} "
                             f"strides {t.stride()} (K7 takes bf16 only: an fp32 request runs "
                             "outside row_major())")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_linear: {name} must start on a 16-byte boundary")
    if b is not None and (b.shape != (cout,) or not b.is_contiguous() or b.device != x.device
                          or b.dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError(f"fused_linear: bias must be a contiguous ({cout},) bf16 or fp32 "
                         "tensor on x's device")


def fused_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7 on CUDA tensors, the plain version on CPU tensors.
    x: (..., Cin); w: (Cout, Cin); b: (Cout,) or None; residual: (..., Cout)."""
    return differentiable(_fused_linear, plain_vjp(linear_plain), x, w, b, residual)


def _fused_linear(x, w, b, residual) -> torch.Tensor:
    if x.device.type == "cpu":
        return linear_plain(x, w, b, residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_linear: unsupported device {x.device}")
    _check_operands(x, w, b, residual)
    cout, cin = w.shape
    y = torch.empty(x.shape[:-1] + (cout,), dtype=x.dtype, device=x.device)
    K7.launch(x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
              None if residual is None else residual.data_ptr(), y.data_ptr(),
              x.numel() // cin, cin, cout, int(b is not None and b.dtype == torch.float32),
              column_tile(cout), torch.cuda.current_stream(x.device).cuda_stream)
    return y
