"""The plans of K5 (GroupNorm) and K6 (LayerNorm) on the CPU.

``kernels/group_norm.py::group_norm_plan`` picks K5's variant a call: R, one
launch of thread-block clusters that hold an image's slab (a run of whole
groups and whole 16-byte vectors) in shared memory, x read once; or S, a
statistics launch and an apply launch, x read twice. The CUDA side refuses a
plan it cannot run (``md_group_norm``), so these checks are what keeps every
norm of the models launchable: every (image, channel, row) in exactly one
block, shared memory within a block's 227 KB, clusters of 1-16 blocks.
``kernels/layer_norm.py::lane_plan`` picks K6's lanes a row and vectors a
lane. No JAX here.
"""

from __future__ import annotations

import math

import pytest

from mikudance_tpu_torch.kernels import group_norm as gn
from mikudance_tpu_torch.kernels import layer_norm as ln

# Request A's UNets: 16 frames x CFG 2 = 32 images at 768^2 (latents 96^2);
# (height, channels) of every GroupNorm, the up blocks' concatenations included
UNET_NORMS = ((96, 320), (96, 640), (96, 960), (48, 640), (48, 960), (48, 1280), (48, 1920),
              (24, 1280), (24, 1920), (24, 2560), (12, 1280), (12, 2560))
# The smoke's K5 shapes (images, rows, channels, groups), the cuda tests'
# shapes, and one image of each UNet level
SMOKE = ((32, 96 * 96, 320), (32, 96 * 96, 960), (32, 96 * 96, 640), (32, 48 * 48, 640),
         (32, 24 * 24, 1280), (32, 12 * 12, 2560), (8, 768 * 768, 128), (1, 12288 * 768, 128))
CUDA_TESTS = ((3, 24 * 24, 320), (1, 4100 * 16, 128), (2, 9 * 9, 960), (2, 96 * 96, 320),
              (2, 96 * 96, 960), (2, 49 * 49, 320), (2, 512 * 512, 128), (2, 48 * 48, 640))
ONE_IMAGE = ((1, 48 * 48, 1280), (1, 24 * 24, 2560), (1, 12 * 12, 1280))


def covered_once(spans, total: int) -> bool:
    """Whether half-open spans (start, stop) cover [0, total) exactly once."""
    at = 0
    for start, stop in sorted(s for s in spans if s[1] > s[0]):
        if start != at:
            return False
        at = stop
    return at == total


def check_plan(images, rows, channels, groups=32, elem=2, max_cluster=16):
    vec = 16 // elem
    plan = gn.group_norm_plan(images, rows, channels, groups, elem, max_cluster=max_cluster)
    gw, base = channels // groups, math.lcm(channels // groups, vec)
    assert plan.slab % base == 0 and channels % plan.slab == 0  # whole groups, whole vectors
    assert plan.slab // gw <= gn.MAX_SLAB_GROUPS and plan.slab // vec <= gn.MAX_SLAB_VECTORS
    if plan.slab != base:  # wider than the smallest only to end rows on whole sectors
        assert plan.slab * elem % gn.SECTOR_BYTES == 0 and plan.variant == "R"
        assert all((m * base * elem) % gn.SECTOR_BYTES for m in range(1, plan.slab // base))
    # channels: slabs side by side (R) or chunks of whole slabs (S), each once
    if plan.variant == "R":
        assert plan.cluster in gn.CLUSTER_SIZES and plan.cluster <= max_cluster
        assert covered_once([(s, s + plan.slab) for s in range(0, channels, plan.slab)], channels)
        spans = [(r * plan.rows_per_block, min(rows, (r + 1) * plan.rows_per_block))
                 for r in range(plan.cluster)]
        assert covered_once(spans, rows)  # every row of the (image, slab) in one rank
        tile = plan.rows_per_block * plan.slab * elem
        assert plan.smem == gn.resident_head(plan.slab) + tile <= gn.MAX_SMEM
        # the smallest cluster that fits: one size down would not
        smaller = [c for c in gn.CLUSTER_SIZES if c < plan.cluster]
        if smaller:
            assert -(-rows // smaller[-1]) * plan.slab * elem > gn.TILE_BYTES[0]
        # where four blocks share an SM, their shared memory fits its 228 KB
        if tile <= gn.TILE_BYTES[0]:
            assert 4 * (plan.smem + 1024) <= 228 * 1024
        assert images * (channels // plan.slab) * plan.cluster < 2 ** 31
    else:
        assert plan.variant == "S" and plan.cluster == 0
        nvc = channels // vec
        assert plan.chunk_w % (plan.slab // vec) == 0 or plan.chunk_w == nvc
        assert 1 <= plan.chunk_w <= gn.STREAM_THREADS
        chunks = -(-nvc // plan.chunk_w)
        assert covered_once([(c * plan.chunk_w, min(nvc, (c + 1) * plan.chunk_w))
                             for c in range(chunks)], nvc)
        assert covered_once([(s * plan.rows_per_split, min(rows, (s + 1) * plan.rows_per_split))
                             for s in range(plan.splits)], rows)
        assert plan.apply_blocks >= 1
        # S keeps a and b for every channel and its fold in shared memory
        assert 8 * channels + 8 * (gn.STREAM_THREADS + 2 * groups) <= gn.MAX_SMEM
        # no slab fits a cluster of the largest allowed size
        tile = -(-rows // max_cluster) * plan.slab * elem
        assert tile > gn.MAX_SMEM - gn.resident_head(plan.slab)
    return plan


@pytest.mark.parametrize("images,rows,channels", SMOKE + CUDA_TESTS + ONE_IMAGE)
@pytest.mark.parametrize("max_cluster", [16, 8])
def test_k5_plan_covers_every_element_once(images, rows, channels, max_cluster):
    """Every (image, channel, row) in exactly one block, slabs of whole groups
    and whole vectors, shared memory within a block's budget, clusters within
    the allowed size, in bf16 and in fp32."""
    for elem in (2, 4):
        check_plan(images, rows, channels, elem=elem, max_cluster=max_cluster)


@pytest.mark.parametrize("height,channels", UNET_NORMS)
def test_k5_is_resident_at_every_unet_norm(height, channels):
    """R at every GroupNorm of request A's UNets (the motion modules' are per
    frame, the same shapes); where the card schedules no cluster of 16 the
    level-0 960-channel map alone is S."""
    assert check_plan(32, height * height, channels).variant == "R"
    portable = check_plan(32, height * height, channels, max_cluster=gn.PORTABLE_CLUSTER)
    assert portable.variant == ("S" if (height, channels) == (96, 960) else "R")


@pytest.mark.parametrize("images,rows,channels", [(8, 768 * 768, 128), (1, 12288 * 768, 128)])
def test_k5_streams_the_vae_maps(images, rows, channels):
    """S at the SD VAE's 768^2 maps and the temporal decoder's joint norm over
    16 frames: no cluster holds one image's slab."""
    plan = check_plan(images, rows, channels)
    assert plan.variant == "S" and plan.splits * images >= 132  # the card filled


@pytest.mark.parametrize("groups,channels,slab,rows,chosen", [
    (32, 320, 40, 96 * 96, 80), (32, 640, 40, 96 * 96, 80), (32, 960, 120, 96 * 96, 120),
    (32, 1920, 120, 48 * 48, 240), (32, 1280, 40, 24 * 24, 80), (32, 2560, 80, 12 * 12, 80),
    (32, 128, 8, 96 * 96, 16), (32, 512, 16, 192 * 192, 16)])
def test_k5_slab_widths(groups, channels, slab, rows, chosen):
    """The smallest slab, and R's at a UNet or VAE map: whole 32-byte sectors
    a row (bf16) where that still fits a cluster; the level-0 960-channel
    map's 240 channels would not, so it keeps 120."""
    assert gn.slab_width(channels, groups, 8) == slab
    assert gn.group_norm_plan(32, rows, channels, groups, 2).slab == chosen


@pytest.mark.parametrize("channels,lanes,per_lane", [(320, 8, 5), (640, 16, 5), (1280, 32, 5),
                                                     (1024, 32, 4)])
def test_k6_lane_plan_covers_the_row(channels, lanes, per_lane):
    """At the models' widths a row's 16-byte vectors split into whole runs,
    one a lane: L x vectors a lane x the vector is the width, in bf16; fp32
    doubles the vectors and keeps every width within the kernel's limits."""
    assert ln.lane_plan(channels, 8)[:2] == (lanes, per_lane)
    for vec in (8, 4):
        L, n, inst = ln.lane_plan(channels, vec)
        assert L * n * vec == channels and L in ln.LANE_GROUPS
        assert n <= inst <= ln.MAX_VECTORS_PER_LANE and inst in ln.VECTOR_COUNTS


@pytest.mark.parametrize("channels", [8, 64, 960, 1000, 1272])
def test_k6_lane_plan_masks_a_tail_no_group_divides(channels):
    """Widths whose vector count no lane group divides into runs of at most
    10 take 32 lanes and a masked tail, still within the instantiations."""
    L, n, inst = ln.lane_plan(channels, 8)
    nv = channels // 8
    assert L * n >= nv > L * (n - 1) and inst in ln.VECTOR_COUNTS and n <= inst
