"""GroupNorm(+SiLU) on channels-last tensors.

K5 (``csrc/group_norm.cu``) replaces the TPU kernels
``mikudance_tpu/kernels/group_norm.py::_stats_kernel`` / ``_apply_kernel``
and the glue between them. ``group_norm_plain`` is its plain PyTorch version,
the two-pass math of the JAX package's ``group_norm_ref`` (:33).

Dispatch is by the tensor's device alone: a CPU tensor goes to the plain
version; a CUDA tensor launches the kernel or raises. The wrapper is
differentiable: the backward is the vector-Jacobian product of the plain
version, as in the JAX package (``group_norm.py:161``).

The kernel takes x of shape (N, ..., C), contiguous, bf16 or fp32, starting
on a 16-byte boundary, with C a multiple of the 16-byte vector (8 bf16 or 4
fp32 channels) and of ``groups``; weight and bias of shape (C,), contiguous,
both fp32 or both bf16. Statistics pool over everything between the first
and the last axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._autograd import differentiable, plain_vjp
from ._build import CudaKernel

K5 = CudaKernel(
    "K5 fused_group_norm", "md_group_norm",
    source="mikudance_tpu_torch/csrc/group_norm.cu",
    replaces="mikudance_tpu/kernels/group_norm.py:51",
)

BLOCK_THREADS = 256  # threads of a statistics block: row lanes x column vectors
TARGET_BLOCKS = 1024  # statistics blocks wanted in flight (132 SMs, several each)
MAX_ROWS_PER_LANE = 256  # longest run of fp32 adds into one accumulator
MIN_ROWS_PER_LANE = 8


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) over channels-last x with fp32 statistics (two-pass
    variance), cast back to x's dtype."""
    N, C = x.shape[0], x.shape[-1]
    xf = x.float().reshape(N, -1, groups, C // groups)
    mu = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mu).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * weight.float() + bias.float()
    if silu:
        y = F.silu(y)
    return y.to(x.dtype)


def stats_plan(images: int, rows: int, channels: int, vec: int):
    """How the statistics pass cuts one launch: (rows_per_block, splits,
    chunk_w, lanes). A block is ``lanes`` row lanes by ``chunk_w`` column
    vectors of ``vec`` channels; an image's rows are cut into ``splits`` runs
    of ``rows_per_block`` so that about ``TARGET_BLOCKS`` blocks exist
    whatever the batch, and no lane adds more than ``MAX_ROWS_PER_LANE`` rows
    into one accumulator."""
    cv = channels // vec
    chunks = -(-cv // BLOCK_THREADS)
    chunk_w = -(-cv // chunks)
    lanes = max(1, BLOCK_THREADS // chunk_w)
    want_splits = -(-TARGET_BLOCKS // (images * chunks))
    rows_per_block = min(lanes * MAX_ROWS_PER_LANE,
                         max(lanes * MIN_ROWS_PER_LANE, -(-rows // want_splits)))
    return rows_per_block, -(-rows // rows_per_block), chunk_w, lanes


def _check_operands(x, weight, bias, groups: int) -> int:
    """Validate what K5 takes; returns the channels per 16-byte vector."""
    if x.ndim < 2 or x.numel() == 0:
        raise ValueError(f"fused_group_norm: need x (N, ..., C), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_group_norm: x must be bf16 or fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_group_norm: x must be contiguous channels-last "
                         f"(shape {tuple(x.shape)}, strides {x.stride()})")
    if x.data_ptr() % 16:
        raise ValueError("fused_group_norm: x must start on a 16-byte boundary")
    C, vec = x.shape[-1], 16 // x.element_size()
    if C % groups or C % vec:
        raise ValueError(f"fused_group_norm: {C} channels must be a multiple of {groups} "
                         f"groups and of the {vec}-channel vector")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.shape != (C,) or not p.is_contiguous() or p.device != x.device \
                or p.dtype != weight.dtype or p.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"fused_group_norm: {name} must be a contiguous ({C},) fp32 or "
                             "bf16 tensor on x's device, weight and bias of one dtype")
    if x.shape[0] > 65535:
        raise ValueError(f"fused_group_norm: batch {x.shape[0]} exceeds the grid limit")
    return vec


def fused_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """K5 on CUDA tensors, the plain version on CPU tensors."""
    return differentiable(
        lambda a, w, b: _fused_group_norm(a, w, b, groups, eps, silu),
        plain_vjp(lambda a, w, b: group_norm_plain(a, w, b, groups, eps, silu)),
        x, weight, bias)


def _fused_group_norm(x, weight, bias, groups: int, eps: float, silu: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm: unsupported device {x.device}")
    vec = _check_operands(x, weight, bias, groups)
    N, C = x.shape[0], x.shape[-1]
    rows = x.numel() // (N * C)
    rows_per_block, splits, chunk_w, lanes = stats_plan(N, rows, C, vec)
    y = torch.empty_like(x)
    # partial sums (N, splits, 2, C), then a and b as (N, 2, C)
    scratch = torch.empty(N * (splits + 1) * 2 * C, dtype=torch.float32, device=x.device)
    K5.launch(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
              scratch.data_ptr(), N, rows, C, groups, eps, int(silu),
              int(x.dtype == torch.float32), int(weight.dtype == torch.float32),
              rows_per_block, splits, chunk_w, lanes,
              torch.cuda.current_stream(x.device).cuda_stream)
    return y
