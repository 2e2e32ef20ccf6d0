"""Row LayerNorm over the last axis.

K6 (``csrc/layer_norm.cu``) replaces the TPU kernel
``mikudance_tpu/kernels/layer_norm.py::_ln_kernel``. ``layer_norm_plain`` is
its plain PyTorch version: the one-pass variance E[x^2] - E[x]^2 in fp32 that
the JAX package's default path uses (``models/layers.py:154-160``). The
kernel takes the mean first and the centred variance from the row it holds in
registers, as ``_ln_kernel`` does; the two differ by fp32 rounding only.

Dispatch is by the tensor's device alone: a CPU tensor goes to the plain
version; a CUDA tensor launches the kernel or raises. The wrapper is
differentiable: the backward is the vector-Jacobian product of the plain
version, as in the JAX package (``layer_norm.py:113``).

The kernel takes x of any leading shape (..., C), contiguous, bf16 or fp32,
with an even C <= 1280, starting on a boundary of one pair (4 bytes of bf16,
8 of fp32); weight and bias of shape (C,), contiguous, both fp32 or both
bf16.
"""

from __future__ import annotations

import torch

from ._autograd import differentiable, plain_vjp
from ._build import CudaKernel

K6 = CudaKernel(
    "K6 fused_layer_norm", "md_layer_norm",
    source="mikudance_tpu_torch/csrc/layer_norm.cu",
    replaces="mikudance_tpu/kernels/layer_norm.py:51",
)

MAX_WIDTH = 1280  # a lane holds at most 20 pairs of the row


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics (one-pass variance),
    cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.square().mean(dim=-1, keepdim=True) - mu.square()
    y = (xf - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def _check_operands(x, weight, bias) -> None:
    if x.ndim < 1 or x.numel() == 0:
        raise ValueError(f"fused_layer_norm: need x (..., C), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_layer_norm: x must be bf16 or fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_layer_norm: x must be contiguous "
                         f"(shape {tuple(x.shape)}, strides {x.stride()})")
    pair = 2 * x.element_size()
    if x.data_ptr() % pair:
        raise ValueError(f"fused_layer_norm: x must start on a {pair}-byte boundary")
    C = x.shape[-1]
    if C % 2 or C > MAX_WIDTH:
        raise ValueError(f"fused_layer_norm: width {C} must be even and <= {MAX_WIDTH}")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.shape != (C,) or not p.is_contiguous() or p.device != x.device \
                or p.dtype != weight.dtype or p.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"fused_layer_norm: {name} must be a contiguous ({C},) fp32 or "
                             "bf16 tensor on x's device, weight and bias of one dtype")


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """K6 on CUDA tensors, the plain version on CPU tensors."""
    return differentiable(lambda a, w, b: _fused_layer_norm(a, w, b, eps),
                          plain_vjp(lambda a, w, b: layer_norm_plain(a, w, b, eps)),
                          x, weight, bias)


def _fused_layer_norm(x, weight, bias, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    _check_operands(x, weight, bias)
    C = x.shape[-1]
    y = torch.empty_like(x)
    K6.launch(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
              x.numel() // C, C, eps, int(x.dtype == torch.float32),
              int(weight.dtype == torch.float32),
              torch.cuda.current_stream(x.device).cuda_stream)
    return y
