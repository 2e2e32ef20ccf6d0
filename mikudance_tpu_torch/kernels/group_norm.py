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
on a 16-byte boundary, with C <= 16384 a multiple of the 16-byte vector (8
bf16 or 4 fp32 channels) and of ``groups``, and a slab (``slab_width``) of
at most 256 vectors; weight and bias of shape (C,), contiguous, 16-byte
aligned, both fp32 or both bf16. Statistics pool over everything between the
first and the last axis.

``group_norm_plan`` picks one of the kernel's two variants a call, by bytes:
R (one launch, x read once) where one image's slab fits the shared memory of
a thread-block cluster, else S (two launches, x read twice). ``plan_for``
holds the plan to what the card schedules (``cudaOccupancyMaxActiveClusters``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from ._autograd import differentiable, plain_vjp
from ._build import CudaKernel, load

K5 = CudaKernel(
    "K5 fused_group_norm", "md_group_norm",
    source="mikudance_tpu_torch/csrc/group_norm.cu",
    replaces="mikudance_tpu/kernels/group_norm.py:51",
)

RESIDENT_THREADS = 256  # threads of an R block
STREAM_THREADS = 256  # threads of an S block
MAX_SLAB_GROUPS = 8  # a slab holds vec / gcd(group width, vec) groups: at most 8
MAX_SLAB_VECTORS = 256  # 16-byte vectors of a slab row at most
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 only where the card schedules it (non-portable)
PORTABLE_CLUSTER = 8
MAX_SMEM = 232448  # shared memory a block may take on sm_90 (227 KB)
# An R block's tile where four, then two blocks share an SM (227 KB of the
# SM's 228, less each block's head and 1 KB the card reserves a block)
TILE_BYTES = (52 * 1024, 104 * 1024)
SECTOR_BYTES = 32  # an L2 sector: R's slabs are whole sectors a row where they fit
STREAM_BLOCKS_PER_SM = 4  # S blocks wanted a multiprocessor, in each of its two launches
APPLY_VECTORS = 8  # 16-byte vectors a thread of the S apply has in flight
MIN_ROWS_PER_LANE = 8
MAX_CHANNELS = 16384  # S keeps a and b for every channel in shared memory


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one K5 call runs. ``variant`` "R": one launch of clusters of
    ``cluster`` blocks, each cluster one (image, slab of ``slab`` channels),
    each block ``rows_per_block`` rows held in ``smem`` bytes of shared
    memory. "S": a statistics launch over ``splits`` runs of
    ``rows_per_split`` rows and chunks of ``chunk_w`` column vectors, then an
    apply launch of ``apply_blocks`` blocks an image."""
    variant: str
    slab: int
    cluster: int = 0
    rows_per_block: int = 0
    smem: int = 0
    splits: int = 0
    rows_per_split: int = 0
    chunk_w: int = 0
    apply_blocks: int = 0


def slab_width(channels: int, groups: int, vec: int) -> int:
    """The smallest run of channels that is a multiple of both the group
    width and the 16-byte vector."""
    return math.lcm(channels // groups, vec)


def resident_head(slab: int) -> int:
    """Bytes of an R block's shared memory ahead of its tile: partial sums,
    the warps' partials and the cluster's totals in double, a and b."""
    return 8 * 2 * MAX_SLAB_GROUPS * (2 + RESIDENT_THREADS // 32) + 4 * 2 * slab


def group_norm_plan(images: int, rows: int, channels: int, groups: int, elem_bytes: int,
                    max_cluster: int = CLUSTER_SIZES[-1], sms: int = 132,
                    aligned: bool = True) -> Plan:
    """R where one image's slab fits a cluster's shared memory, else S.

    R's slab: the smallest that is a whole number of 32-byte sectors a row
    (80 channels at 320, 640 and 1280 in bf16, where the smallest is 40, 80
    bytes), where such a slab fits a cluster of at most ``max_cluster``
    blocks, else the smallest (``aligned`` False: always the smallest). Its
    cluster: the smallest whose blocks' tiles leave room for four blocks an
    SM, else two, else one. S is cut for about ``STREAM_BLOCKS_PER_SM``
    blocks on each of ``sms`` multiprocessors."""
    vec = 16 // elem_bytes
    base = slab_width(channels, groups, vec)
    slabs = [base]
    if aligned:
        wider = next((m * base for m in range(1, MAX_SLAB_GROUPS + 1)
                      if m * base * elem_bytes % SECTOR_BYTES == 0 and channels % (m * base) == 0
                      and m * base // (channels // groups) <= MAX_SLAB_GROUPS), base)
        slabs = list(dict.fromkeys((wider, base)))
    sizes = [cs for cs in CLUSTER_SIZES if cs <= max_cluster]
    for slab in slabs:
        for limit in (*TILE_BYTES, MAX_SMEM - resident_head(slab)):
            for cs in sizes:
                rows_per_block = -(-rows // cs)
                tile = rows_per_block * slab * elem_bytes
                if tile <= limit:
                    return Plan("R", slab, cs, rows_per_block, resident_head(slab) + tile)
    nvs, nvc = base // vec, channels // vec
    chunk_w = min(nvc, STREAM_THREADS // nvs * nvs)  # whole slabs, so whole groups
    chunks = -(-nvc // chunk_w)
    lanes = STREAM_THREADS // chunk_w
    target = STREAM_BLOCKS_PER_SM * sms
    splits = max(1, min(-(-target // (images * chunks)), -(-rows // (lanes * MIN_ROWS_PER_LANE))))
    rows_per_split = -(-rows // splits)
    apply_blocks = max(1, min(-(-target // images),
                              -(-rows * nvc // (STREAM_THREADS * APPLY_VECTORS))))
    return Plan("S", base, splits=-(-rows // rows_per_split), rows_per_split=rows_per_split,
                chunk_w=chunk_w, apply_blocks=apply_blocks)


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


def _check_operands(x, weight, bias, groups: int) -> None:
    """Validate what K5 takes; raise on anything else."""
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
    if C > MAX_CHANNELS or slab_width(C, groups, vec) > MAX_SLAB_VECTORS * vec:
        raise ValueError(f"fused_group_norm: {C} channels in {groups} groups: at most "
                         f"{MAX_CHANNELS} channels, and a slab (a run of whole groups and "
                         f"whole vectors) of at most {MAX_SLAB_VECTORS} vectors")
    card, wtype = x.get_device(), weight.dtype
    for name, p in (("weight", weight), ("bias", bias)):
        if p.shape != (C,) or not p.is_contiguous() or p.get_device() != card \
                or p.dtype != wtype or wtype not in (torch.bfloat16, torch.float32) \
                or p.data_ptr() % 16:
            raise ValueError(f"fused_group_norm: {name} must be a contiguous ({C},) fp32 or "
                             "bf16 tensor on x's device starting on a 16-byte boundary, "
                             "weight and bias of one dtype")
    if x.shape[0] > 65535:
        raise ValueError(f"fused_group_norm: batch {x.shape[0]} exceeds the grid limit")


def fused_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """K5 on CUDA tensors, the plain version on CPU tensors."""
    return differentiable(
        lambda a, w, b: _fused_group_norm(a, w, b, groups, eps, silu),
        plain_vjp(lambda a, w, b: group_norm_plain(a, w, b, groups, eps, silu)),
        x, weight, bias)


def max_active_clusters(plan: Plan, x_fp32: bool, w_fp32: bool, silu: bool) -> int:
    """``cudaOccupancyMaxActiveClusters`` for an R plan: how many of its
    clusters the card holds at once."""
    out = ctypes.c_int(0)
    err = load().md_group_norm_clusters(int(x_fp32), int(w_fp32), int(silu), plan.cluster,
                                        plan.slab, plan.rows_per_block, ctypes.byref(out))
    if err:
        raise RuntimeError(f"md_group_norm_clusters: CUDA error {err} "
                           f"({load().md_error_string(err).decode()})")
    return out.value


@functools.lru_cache(maxsize=None)
def plan_for(device: int, images: int, rows: int, channels: int, groups: int, x_fp32: bool,
             w_fp32: bool, silu: bool) -> tuple[Plan, int]:
    """The plan of a call on card ``device`` and, for R, how many of its
    clusters the card holds at once (0 for S). A cluster of 16 that the card
    does not schedule gives the plan with clusters of at most 8, which may be
    S; an R plan that the card reports it cannot hold raises."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    args = (images, rows, channels, groups, 4 if x_fp32 else 2)
    plan = group_norm_plan(*args, sms=sms)
    if plan.variant == "S":
        return plan, 0
    held = max_active_clusters(plan, x_fp32, w_fp32, silu)
    if held == 0 and plan.cluster > PORTABLE_CLUSTER:
        plan = group_norm_plan(*args, max_cluster=PORTABLE_CLUSTER, sms=sms)
        if plan.variant == "S":
            return plan, 0
        held = max_active_clusters(plan, x_fp32, w_fp32, silu)
    if held == 0:
        raise RuntimeError(f"fused_group_norm: the card holds no cluster of {plan.cluster} "
                           f"blocks with {plan.smem} bytes of shared memory each")
    return plan, held


def _fused_group_norm(x, weight, bias, groups: int, eps: float, silu: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm: unsupported device {x.device}")
    _check_operands(x, weight, bias, groups)
    N, C = x.shape[0], x.shape[-1]
    plan, _ = plan_for(x.device.index, N, x.numel() // (N * C), C, groups,
                       x.dtype is torch.float32, weight.dtype is torch.float32, silu)
    return launch(x, weight, bias, groups, eps, silu, plan)


def launch(x, weight, bias, groups: int, eps: float, silu: bool, plan: Plan) -> torch.Tensor:
    """One K5 launch of ``plan`` on checked CUDA operands."""
    N, C = x.shape[0], x.shape[-1]
    y = torch.empty_like(x)
    # S: per (image, split, group) sums and sums of squares in double
    scratch = (torch.empty(N * plan.splits * 2 * groups, dtype=torch.float64, device=x.device)
               if plan.variant == "S" else None)
    K5.launch(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
              None if scratch is None else scratch.data_ptr(), N, x.numel() // (N * C), C,
              groups, eps, silu, x.dtype is torch.float32, weight.dtype is torch.float32,
              plan.cluster, plan.slab, plan.rows_per_block, plan.splits, plan.rows_per_split,
              plan.chunk_w, plan.apply_blocks,
              torch.cuda.current_stream(x.get_device()).cuda_stream)
    return y
