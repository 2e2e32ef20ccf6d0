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
with C <= 1280 a multiple of the 16-byte vector (8 bf16 or 4 fp32 values),
starting on a 16-byte boundary; weight and bias of shape (C,), contiguous,
16-byte aligned, both fp32 or both bf16. ``lane_plan`` picks the lanes that
take a row and the vectors each lane holds.
"""

from __future__ import annotations

import functools

import torch

from ._autograd import differentiable, plain_vjp
from ._build import CudaKernel

K6 = CudaKernel(
    "K6 fused_layer_norm", "md_layer_norm",
    source="mikudance_tpu_torch/csrc/layer_norm.cu",
    replaces="mikudance_tpu/kernels/layer_norm.py:51",
)

MAX_WIDTH = 1280  # 32 lanes of 10 vectors of fp32
LANE_GROUPS = (32, 16, 8)  # lanes that may take a row, the widest first
MAX_VECTORS_PER_LANE = 10
VECTOR_COUNTS = (1, 2, 4, 5, 8, 10)  # the kernel's instantiations: vectors a lane at most


@functools.lru_cache(maxsize=None)
def lane_plan(channels: int, vec: int) -> tuple[int, int, int]:
    """(lanes a row L, vectors a lane, the kernel instantiation's count) for
    a row of ``channels`` values in 16-byte vectors of ``vec``: the widest
    lane group that divides the row's vectors into whole runs of at most
    ``MAX_VECTORS_PER_LANE`` (320 bf16: 8 lanes of 5; 640: 16 of 5; 1280:
    32 of 5; 1024: 32 of 4), else 32 lanes with a masked tail."""
    nv = channels // vec
    lanes = next((L for L in LANE_GROUPS if nv % L == 0 and nv // L <= MAX_VECTORS_PER_LANE),
                 LANE_GROUPS[0])
    per_lane = -(-nv // lanes)
    return lanes, per_lane, next(n for n in VECTOR_COUNTS if n >= per_lane)


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics (one-pass variance),
    cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.square().mean(dim=-1, keepdim=True) - mu.square()
    y = (xf - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def _check_operands(x, weight, bias) -> tuple[int, int, int]:
    """Validate what K6 takes; returns its ``lane_plan``."""
    if x.ndim < 1 or x.numel() == 0:
        raise ValueError(f"fused_layer_norm: need x (..., C), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_layer_norm: x must be bf16 or fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_layer_norm: x must be contiguous "
                         f"(shape {tuple(x.shape)}, strides {x.stride()})")
    if x.data_ptr() % 16:
        raise ValueError("fused_layer_norm: x must start on a 16-byte boundary")
    C, vec = x.shape[-1], 16 // x.element_size()
    if C % vec or C > MAX_WIDTH:
        raise ValueError(f"fused_layer_norm: width {C} must be a multiple of the {vec}-value "
                         f"vector and <= {MAX_WIDTH}")
    card, wtype = x.get_device(), weight.dtype
    for name, p in (("weight", weight), ("bias", bias)):
        if p.shape != (C,) or not p.is_contiguous() or p.get_device() != card \
                or p.dtype != wtype or wtype not in (torch.bfloat16, torch.float32) \
                or p.data_ptr() % 16:
            raise ValueError(f"fused_layer_norm: {name} must be a contiguous ({C},) fp32 or "
                             "bf16 tensor on x's device starting on a 16-byte boundary, "
                             "weight and bias of one dtype")
    return lane_plan(C, vec)


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
    lanes, _, vectors = _check_operands(x, weight, bias)
    C = x.shape[-1]
    y = torch.empty_like(x)
    K6.launch(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel() // C, C,
              lanes, vectors, eps, x.dtype is torch.float32, weight.dtype is torch.float32,
              torch.cuda.current_stream(x.get_device()).cuda_stream)
    return y
