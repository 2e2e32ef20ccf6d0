#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card.

    python3 chip_smoke.py             # the smoke, below
    python3 chip_smoke.py --profile   # device-time breakdown of requests A, B, E, one F step
    python3 chip_smoke.py --kernels K12,K14   # phases 1-3 for the named kernels, ptxas's report
    python3 chip_smoke.py --budgets   # peak memory, phase by phase, as the clip grows
    python3 chip_smoke.py --train     # phases 1-2, then requests F and G alone
    python3 chip_smoke.py --train --profile   # one request-F train step under the profiler

Phases, in order, one line each; any failure exits non-zero:

1. card: the device and its power limit (nvidia-smi), TF32 switches;
2. build: nvcc builds the kernel library from ``mikudance_tpu_torch/csrc``;
3. kernels: K1-K14 against their plain PyTorch versions at the
   paths' shapes, atol = rtol = 2e-2 and a relative-L2 limit, each with a
   control that the limit must reject (attention: softmax scale off by 9% on
   bf16 N(0, 1) inputs;
   K5: the wrong group size, K6: a row width miscounted by 20%, both on
   inputs with a per-channel offset and spread, K6's with a per-row offset
   too; K7: the bias or the residual left out; K8: the taps transposed; K14:
   the bank K/V left out),
   median times of the
   kernel, its plain version and the one library call that computes the
   same function, and the least time the card could take (``bound_ms``);
4. request A: ``VideoPipeline.__call__`` at the headline geometry (16 uint8
   frames at 768^2, SD1.5 widths, context 30/8, CFG 3.5, 20 DDIM steps,
   absent face/hand streams, ready-made CLIP tokens and zero flow, SD-VAE
   decode to the host) with random seeded weights in bf16; checks shape,
   dtype, finite latents and that every kernel launched;
5. request A again, warm, with another seed and 4 steps;
6. request B, the CLI-shaped one: camera matrices and a depth map ->
   ``scene_motion_flow`` on the card; a reference picture -> CLIP tower
   (ViT-L/14 widths) -> tokens; the same sampler, 20 steps, with the
   temporal decoder; checks as for A plus the flow and the tokens;
7. an image request: ``ImagePipeline`` at 768^2, 20 steps, stage-1 networks
   (no MAN, no motion modules), SD VAE;
8. interpolation: a small request with ``interpolation_factor = 2``;
9. check: a small request (256^2, 4 frames, one step) through the kernels
   and through the plain versions, same weights and inputs, its latents
   decoded by each decoder both ways;
10. request C, long clips at 768^2 with context 30/8 and 2 steps, explicit
    budgets: 48 frames with ``bank_mode="auto"`` past 64 cached positions
    (three windows, per-step banks), the same clip with ``"cached_q8"``, and
    40 frames with ``max_denoise_frame_batch=32`` (two windows,
    cached-grouped). The tiers are held to one another on the same clip:
    q8 against per-step under a limit that a control (the int8 banks read
    back with scales off by 2x) must exceed, cached-grouped against per-step;
11. request D, the CLI's steps for ``-W 256 -H 256 -L 40`` (depth resize,
    scene motion, CLIP tower, seeded noise, sampler, temporal decode) with
    both windows in one UNet batch of 120 frames: the VAE goes through K9
    and the UNet mid-block through K13, and K4 must not launch;
12. request E, the row-major configuration: the warm request A of phase 5
    (same weights, inputs, seed and steps) inside ``kernels.row_major()``: the
    transformer blocks as the chain through K6 and K7, the stride-1 3x3
    convolutions through K8, packed-heads self-attention through K10 (2304
    tokens) and K11 (9216 tokens), K1 not launched. Its latents and decoded
    frames are held to warm request A's under relative-L2 limits that a
    control (the bank K/V left out of the chain) must exceed; the largest
    ``|s - off|`` of one level-0 self-attention call says whether the +-100
    clamp of K10 / K11, which the default configuration does not have, was
    idle. Then the small request of phase 9 once more inside ``row_major()``.
13. request F, training: ``scripts.train_stage2.main`` on synthetic batches at
    the reference's geometry (20 frames at 576^2, batch 1, SD1.5 widths, MAN
    and motion modules on, bf16 with fp32 master copies, remat on), three
    optimizer steps in the default configuration (K1) and three inside
    ``kernels.transposed()`` (K12 at level 0, K10 at level 1), same seeds and
    so the same draws: each must launch K2, K3, K4 (the frozen VAE encoder),
    K5, K6 and its own self-attention kernels and none of the others; finite
    losses, the trainable partition moved, the frozen one bit-identical;
    losses and gradient norms of the two runs held to one another, with
    another step's draws as the control; seconds and peak memory per phase.
    Then a small train step (4 frames at 256^2, the same networks) through
    the kernels and with every wrapper forced to its plain version, loss and
    gradients held to one another (control: the conditioning dropped); then
    two ``train_stage1`` steps at 768^2 (batch cut from 8 to 1).
14. request G: the mega-block probe K14 at (32, 2304, 640) in one launch
    against the port's ``TransformerBlock`` read path on the same weights,
    both timed (control: the bank K/V left out).

The kernel counts are set to 0 just before each request and read just after.
It prints the kernel record (one JSON object; ``ms``, ``plain_ms``,
``library_ms`` and ``bound_ms`` at each kernel's first shape; ``launches``
from request B, for K9 and K13 from request D, for K7, K8, K10 and K11 from
request E, for K12 from request F, for K14 from request G), the nvidia-smi
line, and
last the result line. Uses one card, the first visible one; imports nothing
of JAX.

``--profile`` runs phases 1-2, then torch.profiler over a 2-step and a
20-step request A and a 20-step request B (after a 1-step warm-up), then a
2-step and a 6-step request E (request A inside ``row_major()``), and prints
device time by kernel category, per request and per denoise step, and the
top kernels; then one request-F train step (forward, backward and optimizer
shares, device time by category).
"""

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

STEPS = 20  # DDIM steps of each request, as the headline configuration
T, H, W = 16, 768, 768
ATOL = RTOL = 2e-2  # bf16 kernel against its plain version, as tests/test_flash_attention.py
# N(0, 1) inputs leave the softmax over thousands of keys nearly flat, so
# outputs are small (std ~0.017 at S = 9216) and ATOL alone would pass a
# wrong kernel. Each kernel's output is also held to a relative L2 distance
# from its plain version's, and a control proves the limit can fail: the
# plain version with the softmax scale off by 9% (1/sqrt(48) for 1/sqrt(40),
# the padded width for the real one) must land above it.
REL_L2 = 1e-2
CONTROL_Q_SCALE = math.sqrt(40 / 48)
# Small request, kernels vs plain versions, relative L2 of the latents: bf16
# rounding differences grow through the random full-width network (2.7e-2
# measured on an H100); a kernel that computes the wrong thing gives O(1).
SMALL_REL_L2 = 1e-1
# The same latents decoded through the kernels and through the plain versions
# differ by the decoder's bf16 rounding alone (7e-3 measured on an H100 for
# either decoder): their own limit, about four times that reading.
SMALL_DECODED_REL_L2 = 3e-2
# K5's control runs the plain version with half the groups; K6's with the row
# width miscounted as 48/40 of what it is (statistics divided by the wrong
# count), the norms' counterpart of the padded head width above.
CONTROL_GROUPS = 16
CONTROL_WIDTH = 48 / 40
WARM_STEPS = 4  # the second, warm request A
LONG_STEPS = 2  # request C, the long clips
# cached_q8 against per-step banks on the same clip, relative L2 of the
# latents: the int8 rounding of the banks (under half a percent of each
# position's largest value) on top of bf16 rounding; the control reads the
# same cache back with its scales doubled and must land above the limit.
Q8_REL_L2 = 1e-1
D_FRAMES, D_SIZE, D_STEPS = 40, 256, 4  # request D, the CLI-shaped long clip
# Request E against warm request A, relative L2: the same function through
# other kernels and another order of bf16 roundings, four steps deep at full
# size (1.6e-2 for the latents and 1.1e-2 for the decoded frames measured on
# an H100): the small request's limits hold. The control (the bank K/V left
# out of the chain: 6.3e-1) must land above.
E_REL_L2 = SMALL_REL_L2
E_DECODED_REL_L2 = SMALL_DECODED_REL_L2
PROFILE_E_STEPS = 6
# The card's published peaks (H100 SXM): device memory, dense bf16 tensor
# cores, fp32 outside the tensor cores.
PEAK_BYTES, PEAK_BF16, PEAK_FP32 = 3.35e12, 989e12, 67e12
# Request F, the stage-2 trainer's geometry (configs/train/train_stage2.yaml):
# 20 frames at 576^2, batch 1; its level-0 self-attention shape
TRAIN_FRAMES, TRAIN_SIZE = 20, 576
TRAIN_LEVEL0 = (TRAIN_FRAMES, (TRAIN_SIZE // 8) ** 2, 320)
TRAIN_STEPS = 3
# Request F in the transposed configuration (K12, K10) against the default one
# (K1), same seeds and so the same draws: relative difference of each step's
# loss and gradient norm (3.6e-5 and 4.7e-5 at most, measured on an H100).
# The control is the loss under another step's draws.
F_LOSS_REL = 1e-3
F_NORM_REL = 1e-3
# The small train step through the kernels against the plain versions: the
# loss, and the relative L2 of all gradients taken as one vector (bf16
# rounding through the full-width networks, forwards and backwards: 3.4e-5
# and 1.2e-2 measured on an H100; the control, the conditioning dropped, 4.6e-1).
SMALL_STEP_LOSS_REL = 1e-3
SMALL_STEP_GRAD_REL_L2 = 5e-2
# Request G: the mega-block probe against the block's read path
G_REL_L2 = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    """Fail the run (also under ``python -O``, which strips asserts)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` timed runs, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def seeded_modules(seed: int, device, make):
    """``make()`` builds modules under PyTorch's default init and a seed; every
    tensor that starts at zero (biases, norm shifts, the motion modules'
    proj_out) is refilled with seeded N(0, 1e-2) so that every branch, K3's
    included, reaches the output. Then cast to bf16."""
    from mikudance_tpu_torch.core.params import cast_params

    torch.manual_seed(seed)
    with torch.device(device):
        mods = make()
    g = torch.Generator(device=device).manual_seed(seed + 1)
    with torch.no_grad():
        for m in mods:
            for p in m.parameters():
                if not p.any():
                    p.normal_(0.0, 1e-2, generator=g)
            cast_params(m.eval(), torch.bfloat16)
    return mods


def build_bundle(seed: int, device):
    """SD1.5-width guidance UNet (MAN), denoising UNet (motion modules) and SD
    VAE, random seeded weights in bf16."""
    from mikudance_tpu_torch.core.configs import DenoisingUNetConfig, GuidanceUNetConfig
    from mikudance_tpu_torch.models.unet import DenoisingUNet, GuidanceUNet
    from mikudance_tpu_torch.models.vae import Decoder, Encoder
    from mikudance_tpu_torch.pipelines.video import ModelBundle

    return ModelBundle(*seeded_modules(seed, device, lambda: [
        GuidanceUNet(GuidanceUNetConfig()), DenoisingUNet(DenoisingUNetConfig()),
        Encoder(), Decoder()]))


def build_slice_b_parts(seed: int, device):
    """The CLI-shaped request's extra networks at full width: the CLIP
    ViT-L/14 tower and the temporal decoder."""
    from mikudance_tpu_torch.core.configs import CLIPVisionConfig
    from mikudance_tpu_torch.models.clip_vision import CLIPVisionTower
    from mikudance_tpu_torch.models.vae_temporal import TemporalDecoder

    return seeded_modules(seed, device, lambda: [CLIPVisionTower(CLIPVisionConfig()),
                                                 TemporalDecoder()])


def build_stage1_unets(seed: int, device):
    """The stage-1 image networks: guidance UNet without MAN, denoising UNet
    without motion modules, SD1.5 widths."""
    from mikudance_tpu_torch.core.configs import DENOISING_2D, GUIDANCE_MIX_CHAR
    from mikudance_tpu_torch.models.unet import DenoisingUNet, GuidanceUNet

    return seeded_modules(seed, device, lambda: [GuidanceUNet(GUIDANCE_MIX_CHAR),
                                                 DenoisingUNet(DENOISING_2D)])


def make_inputs(seed: int, frames: int, height: int, width: int):
    """uint8 media as a serving request brings it; absent face/hand streams
    arrive as black frames; scene motion zero; CLIP tokens and noise N(0, 1)."""
    rng = np.random.default_rng(seed)
    h, w = height // 8, width // 8
    return (rng.integers(0, 256, (height, width, 3), dtype=np.uint8),
            rng.integers(0, 256, (height, width, 3), dtype=np.uint8),
            rng.integers(0, 256, (frames, height, width, 3), dtype=np.uint8),
            np.zeros((frames, height, width, 3), np.uint8),
            np.zeros((frames, height, width, 3), np.uint8),
            np.zeros((frames, h, w, 2), np.float32),
            rng.normal(0, 1, (1, 257, 768)).astype(np.float32),
            rng.normal(0, 1, (frames, h, w, 4)).astype(np.float32))


def make_camera(seed: int, frames: int, height: int, width: int):
    """A seeded camera path (a slow pan: yaw of 0.01 rad and a drift of up to
    0.5 units a frame) as world-to-camera and camera-to-world matrices
    (frames, 4, 4), a latent-resolution depth map in [0, 1], and a reference
    picture."""
    rng = np.random.default_rng(seed)
    c2w = np.tile(np.eye(4), (frames, 1, 1))
    yaw = np.cumsum(rng.normal(0.01, 0.002, frames))
    c2w[:, 0, 0], c2w[:, 0, 2] = np.cos(yaw), np.sin(yaw)
    c2w[:, 2, 0], c2w[:, 2, 2] = -np.sin(yaw), np.cos(yaw)
    c2w[:, :3, 3] = np.cumsum(rng.uniform(-0.5, 0.5, (frames, 3)), axis=0)
    depth = rng.uniform(0, 1, (height // 8, width // 8)).astype(np.float32)
    picture = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
    return np.linalg.inv(c2w), c2w, depth, picture


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel to its plain version (reference run)."""
    from mikudance_tpu_torch.kernels import conv2d as cv
    from mikudance_tpu_torch.kernels import flash_attention as fa
    from mikudance_tpu_torch.kernels import group_norm as gn
    from mikudance_tpu_torch.kernels import layer_norm as ln
    from mikudance_tpu_torch.kernels import linear as lin
    from mikudance_tpu_torch.kernels import temporal_attention as ta
    from mikudance_tpu_torch.models import layers

    patches = [(fa, n, fa.dot_product_attention)
               for n in ("flash_attention_fullc", "cross_attention", "flash_attention_wide",
                         "flash_attention_resident")]
    patches += [(fa, "flash_attention_fullc_anchored", fa.anchored_attention),
                (fa, "flash_attention_fullc_t", fa.anchored_attention_t),
                (layers, "fused_linear", lin.linear_plain),
                (cv, "conv3x3_fused", lambda x, w, b, packed=None: cv.conv3x3_plain(x, w, b)),
                (fa, "temporal_attention", ta.temporal_attention_plain),
                (fa, "small_sequence_attention", ta.small_sequence_attention_plain),
                (layers, "fused_group_norm", gn.group_norm_plain),
                (layers, "fused_layer_norm", ln.layer_norm_plain)]
    saved = [(mod, n, getattr(mod, n)) for mod, n, _ in patches]
    for mod, n, f in patches:
        setattr(mod, n, f)
    try:
        yield
    finally:
        for mod, n, f in saved:
            setattr(mod, n, f)


def library_kernel_name(fn) -> str:
    """The device kernel that takes most of ``fn``'s time (which backend a
    library call chose), or "" if the profiler recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return max(rows)[1][:60] if rows else ""


def sdpa_backend_times(fn) -> str:
    """``fn`` (one scaled_dot_product_attention call) under each backend alone:
    its median ms, or "refused". The default call's time beside these says
    which backend PyTorch chose."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                out.append(f"{backend.name} {cuda_ms(fn, 3):.3f} ms")
        except RuntimeError:
            out.append(f"{backend.name} refused")
    return "backends alone: " + ", ".join(out)


def norm_input(shape, g, dev, row_offset: bool = False) -> torch.Tensor:
    """bf16 data with a per-channel mean in [-8, 8] and spread in [0.25, 4]
    and, for LayerNorm, a per-row offset in [-8, 8] on top (channel means
    average out along a row), so that a wrong mean or a lost variance shows;
    filled in slabs to bound the fp32 temporaries."""
    C = shape[-1]
    mean = torch.rand(C, generator=g, device=dev) * 16 - 8
    std = torch.rand(C, generator=g, device=dev) * 3.75 + 0.25
    x = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    rows = x.view(-1, C)
    for i in range(0, rows.shape[0], 1 << 22):
        slab = rows[i:i + (1 << 22)]
        values = torch.randn(slab.shape, generator=g, device=dev) * std + mean
        if row_offset:
            values += torch.rand((slab.shape[0], 1), generator=g, device=dev) * 16 - 8
        slab.copy_(values)
    return x


def wanted(kern, only) -> bool:
    """Whether ``only`` (kernel numbers such as "K9"; empty: all) names ``kern``."""
    return not only or kern.name.split(" ")[0] in only


def attention_cases(dev, only=()):
    """K1-K4, K9 and K13 at the sampler's shapes: (kernel, label, run, plain,
    control, library, flops, bytes, peak rate); ``only`` keeps the kernels
    whose names it lists."""
    import torch.nn.functional as F

    from mikudance_tpu_torch.kernels import flash_attention as fa
    from mikudance_tpu_torch.kernels import temporal_attention as ta

    g = torch.Generator(device=dev).manual_seed(0)

    def r(*s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    # (kernel, wrapper, plain, shapes of q, k, v, heads); batch = the main
    # path's (2 CFG halves x 16 frames; B=2 for the motion modules; the VAE
    # encode chunk of 8 frames)
    cases = [
        (fa.K1, fa.flash_attention_fullc, fa.dot_product_attention, [(32, 9216, 320)] * 3, 8),
        (fa.K1, fa.flash_attention_fullc, fa.dot_product_attention, [(32, 2304, 640)] * 3, 8),
        (fa.K2, fa.cross_attention, fa.dot_product_attention,
         [(32, 9216, 320), (32, 257, 320), (32, 257, 320)], 8),
        (fa.K2, fa.cross_attention, fa.dot_product_attention,
         [(32, 2304, 640), (32, 257, 640), (32, 257, 640)], 8),
        (ta.K3, ta.temporal_attention, ta.temporal_attention_plain, [(2, 16, 9216, 320)] * 3, 8),
        (ta.K3, ta.temporal_attention, ta.temporal_attention_plain, [(2, 16, 2304, 640)] * 3, 8),
        (ta.K3, ta.temporal_attention, ta.temporal_attention_plain, [(2, 16, 576, 1280)] * 3, 8),
        (ta.K3, ta.temporal_attention, ta.temporal_attention_plain, [(2, 16, 144, 1280)] * 3, 8),
        # the 30-frame windows of a long clip: one window, and four at 256^2
        (ta.K3, ta.temporal_attention, ta.temporal_attention_plain, [(1, 30, 9216, 320)] * 3, 8),
        (ta.K3, ta.temporal_attention, ta.temporal_attention_plain, [(4, 30, 1024, 320)] * 3, 8),
        (fa.K4, fa.flash_attention_wide, fa.dot_product_attention, [(8, 9216, 512)] * 3, 1),
        # the VAE mid-block under 512^2: 256^2, 384^2, the largest S K9 takes,
        # and a ragged S (a 33 x 35 latent map)
        (fa.K9, fa.flash_attention_resident, fa.dot_product_attention, [(8, 1024, 512)] * 3, 1),
        (fa.K9, fa.flash_attention_resident, fa.dot_product_attention, [(8, 2304, 512)] * 3, 1),
        (fa.K9, fa.flash_attention_resident, fa.dot_product_attention, [(8, 3072, 512)] * 3, 1),
        (fa.K9, fa.flash_attention_resident, fa.dot_product_attention, [(2, 1155, 512)] * 3, 1),
        # the UNet mid-block on a 4 x 4 map (256^2, four 30-frame windows),
        # then the other head widths, 32 tokens, and a T off the multiples of 8
        (ta.K13, ta.small_sequence_attention, ta.small_sequence_attention_plain,
         [(120, 16, 1280)] * 3, 8),
        (ta.K13, ta.small_sequence_attention, ta.small_sequence_attention_plain,
         [(64, 32, 320)] * 3, 8),
        (ta.K13, ta.small_sequence_attention, ta.small_sequence_attention_plain,
         [(256, 16, 640)] * 3, 8),
        (ta.K13, ta.small_sequence_attention, ta.small_sequence_attention_plain,
         [(64, 30, 1280)] * 3, 8),
    ]
    for kern, fn, plain, shapes, heads in cases:
        if not wanted(kern, only):
            continue
        q, k, v = (r(*s) for s in shapes)
        C = q.shape[-1]
        hd = C // heads
        if q.ndim == 4:  # K3: one T x T attention per (batch, position, head)
            B, T, P, _ = q.shape
            flops = 4 * B * P * T * T * C
            lib = [t.reshape(B, T, P, heads, hd).permute(0, 2, 3, 1, 4)
                   .reshape(B * P, heads, T, hd).contiguous() for t in (q, k, v)]
        else:
            flops = 4 * q.shape[0] * q.shape[1] * k.shape[1] * C
            lib = [t.view(t.shape[0], t.shape[1], heads, hd).transpose(1, 2) for t in (q, k, v)]
        yield (kern, f"{kern.name} q{shapes[0]} kv{shapes[1][1]} heads {heads}",
               lambda: fn(q, k, v, heads), lambda: plain(q, k, v, heads),
               lambda: plain(q * CONTROL_Q_SCALE, k, v, heads),
               lambda: F.scaled_dot_product_attention(*lib),
               flops, 2 * (2 * q.numel() + k.numel() + v.numel()), PEAK_BF16)


def norm_cases(dev, only=()):
    """K5 and K6 at the shapes the UNets, the VAEs (the temporal decoder's
    joint norm over 16 frames included) and the CLIP tower give them."""
    import torch.nn.functional as F

    from mikudance_tpu_torch.kernels import group_norm as gn
    from mikudance_tpu_torch.kernels import layer_norm as ln

    g = torch.Generator(device=dev).manual_seed(1)
    eps, groups = 1e-6, 32
    group_norm_shapes = (((32, 96, 96, 320), True), ((32, 96, 96, 960), False),
                         ((32, 12, 12, 2560), False), ((8, 768, 768, 128), True),
                         ((1, 12288, 768, 128), True))
    for shape, silu in group_norm_shapes if wanted(gn.K5, only) else ():
        x = norm_input(shape, g, dev)
        w, b = (torch.randn(shape[-1], generator=g, device=dev) for _ in range(2))

        def library(x=x, w=w.bfloat16(), b=b.bfloat16(), silu=silu):
            y = F.group_norm(x.permute(0, 3, 1, 2), groups, w, b, eps)
            return F.silu(y) if silu else y

        yield (gn.K5, f"{gn.K5.name} x{shape} silu {silu}",
               lambda x=x, w=w, b=b, silu=silu: gn.fused_group_norm(x, w, b, groups, eps, silu),
               lambda x=x, w=w, b=b, silu=silu: gn.group_norm_plain(x, w, b, groups, eps, silu),
               lambda x=x, w=w, b=b, silu=silu: gn.group_norm_plain(x, w, b, CONTROL_GROUPS,
                                                                     eps, silu),
               library, 8 * x.numel(), 2 * 2 * x.numel(), PEAK_FP32)
        del x
    layer_norm_shapes = ((32, 9216, 320), (32, 2304, 640), (32, 576, 1280), (2, 16, 9216, 320),
                         (1, 257, 1024))
    for shape in layer_norm_shapes if wanted(ln.K6, only) else ():
        x = norm_input(shape, g, dev, row_offset=True)
        C = shape[-1]
        w, b = (torch.randn(C, generator=g, device=dev) for _ in range(2))

        def control(x=x, w=w, b=b, C=C):  # statistics divided by the wrong count
            xf = x.float()
            mu = xf.sum(-1, keepdim=True) / (C * CONTROL_WIDTH)
            var = xf.square().sum(-1, keepdim=True) / (C * CONTROL_WIDTH) - mu.square()
            return ((xf - mu) * torch.rsqrt(var + 1e-5) * w + b).to(x.dtype)

        yield (ln.K6, f"{ln.K6.name} x{shape}",
               lambda x=x, w=w, b=b: ln.fused_layer_norm(x, w, b, 1e-5),
               lambda x=x, w=w, b=b: ln.layer_norm_plain(x, w, b, 1e-5), control,
               lambda x=x, w=w.bfloat16(), b=b.bfloat16(), C=C: F.layer_norm(x, (C,), w, b, 1e-5),
               8 * x.numel(), 2 * 2 * x.numel(), PEAK_FP32)
        del x


def anchored_cases(dev, only=()):
    """K10 and K11, each at both UNet levels (first the one the byte rule gives
    it) and on an input where the clamp bites: q three times as large, so
    that many rows' scores all lie more than 100 log2 units under the anchor."""
    import torch.nn.functional as F

    from mikudance_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(2)
    level0, level1 = (32, 9216, 320), (32, 2304, 640)
    cases = [(fa.K10, fa.flash_anchor_resident, level1, 1.0),
             (fa.K10, fa.flash_anchor_resident, level0, 1.0),
             (fa.K10, fa.flash_anchor_resident, (8, 2304, 640), 3.0),
             (fa.K11, fa.flash_anchor_stream, level0, 1.0),
             (fa.K11, fa.flash_anchor_stream, level1, 1.0),
             (fa.K11, fa.flash_anchor_stream, (8, 2304, 320), 3.0),
             # K12: the 576^2 trainer's level 0 (5184 = 40.5 x 128 tokens), the
             # 768^2 level beside K1 and K11, heads of 80 on a ragged S, the clamp
             (fa.K12, fa.flash_attention_fullc_t, TRAIN_LEVEL0, 1.0),
             (fa.K12, fa.flash_attention_fullc_t, level0, 1.0),
             (fa.K12, fa.flash_attention_fullc_t, (20, 1296, 640), 1.0),
             (fa.K12, fa.flash_attention_fullc_t, (8, 2304, 320), 3.0)]
    heads = 8
    check(fa.fullc_resident(2304, 640, heads) and not fa.fullc_resident(9216, 320, heads),
          "the byte rule gives K10 the 2304-token level and K11 the 9216-token level")
    for kern, fn, shape, q_scale in cases:
        if not wanted(kern, only):
            continue
        q, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
        q, k, v = (q * q_scale).to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)
        hd = shape[-1] // heads
        lib = [t.view(t.shape[0], t.shape[1], heads, hd).transpose(1, 2) for t in (q, k, v)]
        excursion = fa.anchor_excursion(q[:1], k[:1], heads)
        check((excursion > fa.EXP_CLAMP) == (q_scale > 1.0),
              f"{kern.name} {shape}: largest |s - off| {excursion:.1f} with q x {q_scale}")
        plain = fa.anchored_attention_t if kern is fa.K12 else fa.anchored_attention
        what = (f"{kern.name} q{shape} heads {heads} q x {q_scale} (largest |s - off| "
                f"{excursion:.1f}")
        if kern is fa.K12 and q_scale > 1.0:
            # the anchor rounded to bf16 moves which scores the clamp clips:
            # here K12's function is no longer K10 / K11's
            apart = rel_l2(plain(q, k, v, heads), fa.anchored_attention(q, k, v, heads))
            check(apart > 0.0, f"{kern.name} {shape}: its plain version equals K10 / K11's "
                               "on an input where the clamp bites")
            what += f"; plain version against K10 / K11's: relative L2 {apart:.3e}"
        yield (kern, what + ")",
               lambda: fn(q, k, v, heads), lambda: plain(q, k, v, heads),
               lambda: plain(q * CONTROL_Q_SCALE, k, v, heads),
               lambda: F.scaled_dot_product_attention(*lib),
               4 * shape[0] * shape[1] * shape[1] * shape[2], 2 * 4 * q.numel(), PEAK_BF16)


def linear_cases(dev, only=()):
    """K7 at the chain's products: (rows, Cin, Cout, residual); the control
    leaves out the residual where there is one, else the bias."""
    import torch.nn.functional as F

    from mikudance_tpu_torch.kernels import linear as lin

    g = torch.Generator(device=dev).manual_seed(3)
    shapes = ((294912, 320, 320, False), (294912, 320, 320, True), (294912, 320, 2560, False),
              (294912, 1280, 320, True), (18432, 1280, 10240, False), (4321, 640, 640, True))
    for rows, cin, cout, with_res in shapes if wanted(lin.K7, only) else ():
        x = torch.randn((rows, cin), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((cout, cin), generator=g, device=dev) / math.sqrt(cin)).to(torch.bfloat16)
        b = torch.randn(cout, generator=g, device=dev).to(torch.bfloat16)
        r = (torch.randn((rows, cout), generator=g, device=dev).to(torch.bfloat16)
             if with_res else None)

        def library(x=x, w=w, b=b, r=r):
            y = F.linear(x, w, b)
            return y if r is None else y + r

        yield (lin.K7, f"{lin.K7.name} x({rows}, {cin}) -> {cout}"
                       + (" + residual" if with_res else ""),
               lambda x=x, w=w, b=b, r=r: lin.fused_linear(x, w, b, r),
               lambda x=x, w=w, b=b, r=r: lin.linear_plain(x, w, b, r),
               lambda x=x, w=w, b=b, r=r: lin.linear_plain(x, w, b if with_res else None, None),
               library, 2 * rows * cin * cout,
               2 * (rows * cin + cin * cout + cout + rows * cout * (2 if with_res else 1)),
               PEAK_BF16)
        del x, r


def conv_cases(dev, only=()):
    """K8 at convolutions of the UNets (down path, an up-path width change, the
    widest up-path input) and of the VAE at 768^2; the control runs the plain
    version with the taps transposed."""
    import torch.nn.functional as F

    from mikudance_tpu_torch.kernels import conv2d as cv

    g = torch.Generator(device=dev).manual_seed(4)
    shapes = (((32, 96, 96, 320), 320), ((32, 48, 48, 1280), 640), ((32, 24, 24, 2560), 1280),
              ((8, 768, 768, 128), 128))
    for shape, cout in shapes if wanted(cv.K8, only) else ():
        cin = shape[-1]
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((cout, cin, 3, 3), generator=g, device=dev)
             / math.sqrt(9 * cin)).to(torch.bfloat16)
        b = torch.randn(cout, generator=g, device=dev).to(torch.bfloat16)
        packed = cv.pack_weight(w)  # as the model path keeps it: packed once

        def library(x=x.permute(0, 3, 1, 2), w=w.contiguous(memory_format=torch.channels_last),
                    b=b):
            return F.conv2d(x, w, b, padding=1)

        yield (cv.K8, f"{cv.K8.name} x{shape} -> {cout}",
               lambda x=x, w=w, b=b, packed=packed: cv.conv3x3_fused(x, w, b, packed),
               lambda x=x, w=w, b=b: cv.conv3x3_plain(x, w, b),
               lambda x=x, w=w, b=b: cv.conv3x3_plain(x, w.transpose(2, 3), b),
               library, 2 * 9 * x.numel() * cout,
               2 * (x.numel() + w.numel() + cout + x.numel() // cin * cout), PEAK_BF16)
        del x


def mega_inputs(dev, level, seed: int = 5):
    """The probe's inputs at one of its levels, (B, S, C): bank K/V and context
    K/V N(0, 0.5), the 257 context rows padded with zeros to 320, and a seeded
    ``TransformerBlock`` of that width whose weights the probe and the block's
    read path share. The hidden states are N(0, 0.1), not the probe's N(0, 1):
    LayerNorm makes the sublayers blind to their scale, so this only shrinks
    the residual that the output carries along, and a wrong sublayer (the
    control: the bank K/V left out) moves the output by 2e-1 and not 2e-2."""
    from mikudance_tpu_torch.kernels import mega_block as mb
    from mikudance_tpu_torch.models import layers

    B, S, C = level
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=dev) * scale).to(torch.bfloat16)

    (block,) = seeded_modules(seed, dev, lambda: [layers.TransformerBlock(C, mb.HEADS)])
    x, rk, rv = r(B, S, C, scale=0.1), r(B, S, C, scale=0.5), r(B, S, C, scale=0.5)
    ck, cv = (torch.zeros(B, 320, C, dtype=torch.bfloat16, device=dev) for _ in range(2))
    ck[:, :mb.CTX_LEN], cv[:, :mb.CTX_LEN] = (r(B, mb.CTX_LEN, C, scale=0.5) for _ in range(2))
    return block, (x, rk, rv, ck, cv), mb.weights_from_block(block)


def block_read_path(block, x, rk, rv, ck, cv):
    """What the probe spans, through the port's ``TransformerBlock`` as the
    denoising UNet calls it (K6, library products, K1, K2)."""
    from mikudance_tpu_torch.kernels import mega_block as mb

    ctx_kv = (ck[:, :mb.CTX_LEN].contiguous(), cv[:, :mb.CTX_LEN].contiguous())

    def run():
        with torch.inference_mode():
            return block(x, None, ref_kv=(rk, rv), ctx_kv=ctx_kv)[0]

    return run


MEGA_LEVELS = ((32, 2304, 640), (32, 576, 1280), (32, 9216, 320))  # the probe's own, mid, big


def mega_cases(dev, only=()):
    """K14 at the probe's three levels; the control leaves the bank K/V out.
    No single library call computes the block: the read path is timed beside."""
    from mikudance_tpu_torch.kernels import mega_block as mb

    for level in MEGA_LEVELS if wanted(mb.K14, only) else ():
        block, ins, w = mega_inputs(dev, level)
        x, rk, rv, ck, cv = ins
        B, S, C = level
        FF, SC = 4 * C, mb.CTX_LEN
        flops = B * 2 * (4 * S * C * C + 2 * S * S * C + 2 * S * SC * C + 2 * S * C * C
                         + S * C * 2 * FF + S * FF * C)
        nbytes = (2 * (4 * x.numel() + 2 * ck.numel() + sum(w[n].numel() for n in mb.MATRICES))
                  + 4 * sum(w[n].numel() for n in mb.VECTORS))
        zero = torch.zeros_like(rk)
        yield (mb.K14, f"{mb.K14.name} x{level} heads {mb.HEADS} context {SC} of {ck.shape[1]}",
               lambda: mb.mega_block(*ins, w), lambda: mb.mega_block_plain(*ins, w),
               lambda: mb.mega_block_plain(x, zero, zero, ck, cv, w), None, flops, nbytes,
               PEAK_BF16, {"the block's read path": block_read_path(block, *ins)})
        del block, ins, w, x, rk, rv, ck, cv, zero


def train_config_file(stage: str, out_dir: str, **sections) -> str:
    """The repo's ``configs/train/train_<stage>.yaml`` as it is, with the run's
    output under ``out_dir``, a log line every step, no checkpoint, export or
    validation inside these few steps, and ``sections`` merged over its
    sections; written to ``out_dir`` and returned as a path."""
    import yaml

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "configs", "train", f"train_{stage}.yaml")) as f:
        cfg = yaml.safe_load(f)
    never = 10**9
    cfg.update(output_dir=out_dir, log_every=1, checkpointing_steps=never,
               save_model_step_interval=never, validation_steps=never)
    cfg.pop("val", None)
    for name, values in sections.items():
        cfg.setdefault(name, {}).update(values)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"train_{stage}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def run_training(stage: str, n_steps: int, out_dir: str, dev, **sections):
    """The trainer's ``main([...])`` on ``n_steps`` synthetic batches, with a
    clock and a peak-memory reading at the borders of a step's phases: batch
    (host data, VAE and CLIP encoders), forward (``diffusion_loss``), backward,
    optimizer. Returns (the final TrainState, the log's records, {phase:
    [seconds per step]}, {phase: peak GiB}); the first step's batch phase
    holds the build of the networks."""
    import shutil

    from mikudance_tpu_torch.scripts import train_stage1, train_stage2
    from mikudance_tpu_torch.train import steps as tsteps

    shutil.rmtree(out_dir, ignore_errors=True)
    path = train_config_file(stage, out_dir, **sections)
    phases, peaks = defaultdict(list), defaultdict(float)
    clock = {"t": time.perf_counter()}
    torch.cuda.reset_peak_memory_stats(dev)

    def mark(name):
        torch.cuda.synchronize(dev)
        now = time.perf_counter()
        phases[name].append(now - clock["t"])
        peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated(dev) / 2**30)
        torch.cuda.reset_peak_memory_stats(dev)
        clock["t"] = now

    loss_fn, update = tsteps.diffusion_loss, tsteps.Optimizer.update

    def timed_loss(*args, **kwargs):
        mark("batch")
        out = loss_fn(*args, **kwargs)
        mark("forward")
        return out

    def timed_update(self, grads):
        mark("backward")
        fired = update(self, grads)
        mark("optimizer")
        return fired

    tsteps.diffusion_loss, tsteps.Optimizer.update = timed_loss, timed_update
    try:
        main = {"stage1": train_stage1.main, "stage2": train_stage2.main}[stage]
        state = main(["--config", path, "--synthetic", str(n_steps), "--max_steps",
                      str(n_steps)])
    finally:
        tsteps.diffusion_loss, tsteps.Optimizer.update = loss_fn, update
    with open(os.path.join(out_dir, f"train_{stage}_mikudance", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    check(len(records) == n_steps == state.optimizer.count,
          f"{stage}: {len(records)} log records, {state.optimizer.count} optimizer steps")
    return state, records, dict(phases), dict(peaks)


def training_text(phases, peaks) -> str:
    """First step | later steps (median seconds a phase) | peak GiB a phase."""
    later = {k: float(np.median(v[1:])) for k, v in phases.items() if len(v) > 1}
    first = " ".join(f"{k} {v[0]:.2f}s" for k, v in phases.items())
    return (f"first step (build and warm-up in it): {first} | later steps, median: "
            + " ".join(f"{k} {v:.3f}s" for k, v in later.items())
            + f" = {sum(later.values()):.3f} s a step | peak "
            + " ".join(f"{k} {v:.2f} GiB" for k, v in peaks.items()))


def initial_stage2_weights(dev):
    """The stage-2 trainer's networks as it builds them (seeded random init,
    no files), cast to bf16: what its parameters were before the first step
    (on the host)."""
    from mikudance_tpu_torch.core import loaders

    guide = loaders.load_guidance(None, use_man=True, device=dev)
    den = loaders.load_denoising(None, None, use_motion=True, device=dev)
    out = {f"guide.{k}": v.to(torch.bfloat16).cpu() for k, v in guide.state_dict().items()}
    out.update({f"den.{k}": v.to(torch.bfloat16).cpu() for k, v in den.state_dict().items()})
    return out  # on the host: the runs' peak-memory readings stay their own


def small_train_batch(dev, seed: int, frames: int = 4, size: int = 256):
    """A ready stage-2 batch at a small geometry (no encoders), and its draws."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h = size // 8

    def r(*s, scale=1.0):
        return torch.randn(s, generator=g, device=dev) * scale

    batch = {"latents": r(1, frames, h, h, 4), "cond20": r(1, frames, h, h, 20),
             "motion": r(1, frames, h, h, 2, scale=0.1), "clip_ctx": r(1, 257, 768),
             "uncond": torch.zeros(1, device=dev)}
    draws = {"noise": r(1, frames, h, h, 4), "offset": r(1, 1, 1, 1, 4),
             "t": torch.tensor([400], device=dev)}
    return batch, draws


def loss_and_gradients(state, cfg, schedule, batch, draws):
    """(loss, {name: gradient}) of one loss evaluation on ``state``'s modules."""
    from mikudance_tpu_torch.train import steps as tsteps

    for p in state.trainable.values():
        p.grad = None
    loss, _ = tsteps.diffusion_loss(cfg, schedule, state.guide, state.den, batch, draws=draws)
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in state.trainable.items() if p.grad is not None}
    for p in state.trainable.values():
        p.grad = None
    return float(loss.detach()), grads


def flat(grads) -> torch.Tensor:
    return torch.cat([g.reshape(-1) for _, g in sorted(grads.items())])


def phase_kernels(dev, only=()):
    """Every kernel against its plain version at the paths' shapes. Returns
    the kernel record: per kernel the times at its first shape."""
    import itertools

    record = {}
    for kern, what, run, plain, control, library, flops, nbytes, peak, *rest in itertools.chain(
            attention_cases(dev, only), norm_cases(dev, only), anchored_cases(dev, only),
            linear_cases(dev, only), conv_cases(dev, only), mega_cases(dev, only)):
        got = run()
        torch.cuda.synchronize()
        want = plain()
        err = (got.float() - want.float()).abs().max().item()
        rel = rel_l2(got, want)
        torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=RTOL,
                                   msg=lambda m: f"{what}: {m}")
        del want
        ctl = rel_l2(got, control())
        check(rel < REL_L2, f"{what}: relative L2 {rel:.3e} >= {REL_L2}")
        check(ctl > REL_L2, f"{what}: the control reads {ctl:.3e}, under the limit "
                            f"{REL_L2}: the check cannot fail")
        del got
        ms = cuda_ms(run, 5)
        plain_ms = cuda_ms(plain, 3)
        library_ms = cuda_ms(library, 5) if library is not None else None
        also = {name: cuda_ms(fn, 5) for name, fn in (rest[0] if rest else {}).items()}
        # the least time the card could take: every input read once and every
        # output written once at the memory rate, or the operations at the
        # peak rate of their type, whichever is longer
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
        bound_ms, bound_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        if library is None:
            lib_text = "no library call computes this; " + ", ".join(
                f"{name} {t:.3f} ms" for name, t in also.items())
        else:
            chose = library_kernel_name(library)
            if kern.name.startswith("K4"):  # head width 512: which backend takes it
                chose = f"{chose}; {sdpa_backend_times(library)}"
            lib_text = f"library {library_ms:.3f} ms ({chose})"
        log(f"kernels: {what}: max_abs_err {err:.3e}  rel_l2 {rel:.3e} (limit {REL_L2}; "
            f"control {ctl:.3e})  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  {lib_text}  "
            f"bound {bound_ms:.3f} ms by {bound_by}")
        # the record keeps each kernel's first (largest) shape's times
        rec = record.setdefault(kern.name, {
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": 0, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shape": what.split(" ", 2)[2],
            **{name.replace(" ", "_").replace("'", "") + "_ms": t for name, t in also.items()}})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        torch.cuda.empty_cache()
    return record


# kernel-name substrings -> category, first match wins
PROFILE_CATEGORIES = [
    ("K1/K2 hd 40 (S=9216 self + cross)", ("attn_tile_kernel<48",)),
    ("K1/K2 hd 80 (S=2304 self + cross)", ("attn_tile_kernel<80",)),
    ("K4 hd 512 (VAE)", ("attn_tile_kernel<512",)),
    ("K3 temporal", ("temporal_kernel",)),
    ("K5 GroupNorm (statistics, finish, apply)", ("gn_stats_kernel", "gn_finish_kernel",
                                                  "gn_apply_kernel")),
    ("K6 LayerNorm", ("ln_kernel",)),
    ("K7 linear (the chain's products)", ("linear_kernel",)),
    ("K8 conv3x3", ("conv3x3_kernel",)),
    ("K12 transposed anchored attention", ("fullc_t_kernel",)),
    ("K14 mega-block", ("mega_kernel",)),
    ("K10 anchored attention, K/V from L2", ("anchor_resident_kernel",)),
    ("K11 anchored attention, K/V staged", ("anchor_stream_kernel",)),
    ("conv (cuDNN)", ("fprop", "conv", "implicit_gemm", "cudnn", "nhwc")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "Kernel2")),
    ("softmax (plain attention)", ("softmax",)),
    ("reduce (instance-norm statistics, sums)", ("reduce_kernel",)),
    ("elementwise / copies", ("elementwise", "vectorized", "copy", "Cat", "index", "fill")),
]


def profile_request(run, steps: int):
    """``run(steps)`` (one request, returning its Timer) under torch.profiler:
    (wall s, phases, ms by category, [(ms, calls, kernel name)] sorted by time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        timer = run(steps)
        wall = time.perf_counter() - t0
    sums, top = defaultdict(float), []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        cat = next((c for c, keys in PROFILE_CATEGORIES if any(k in e.key for k in keys)),
                   "other")
        sums[cat] += ms
        top.append((ms, e.count, e.key))
    return wall, timer.phases, sums, sorted(top, reverse=True)


def log_profile(name: str, steps: int, res) -> None:
    wall, phases, sums, _ = res
    busy = sum(sums.values())
    log(f"profile: {name}, {steps} steps: wall {wall:.3f} s, kernel time {busy / 1e3:.3f} s "
        f"(busy {busy / 1e3 / wall:.1%}), phases "
        + " ".join(f"{k} {v:.3f}s" for k, v in phases.items()))
    for cat, ms in sorted(sums.items(), key=lambda kv: -kv[1]):
        log(f"   {cat:44s} {ms:10.1f} ms  {ms / busy:6.1%}")


def profile_train_step(dev) -> None:
    """One request-F step under torch.profiler: stage 2 at 20 x 576^2 in the
    transposed configuration, on a ready batch (random latents, condition
    stack and tokens of the trainer's shapes; the encoders are not part of the
    step). Wall shares of forward, backward and optimizer between device
    synchronisations, and device time by kernel category."""
    from types import SimpleNamespace

    from mikudance_tpu_torch.core import loaders
    from mikudance_tpu_torch.diffusion.ddim import DDIMSchedule
    from mikudance_tpu_torch.kernels import transposed
    from mikudance_tpu_torch.train import steps as tsteps

    cfg = tsteps.TrainConfig(trainable_substrings=("motion", "man_"))
    schedule = DDIMSchedule.create(beta_schedule="linear")
    state = tsteps.init_train_state(
        cfg, loaders.load_guidance(None, use_man=True, device=dev, remat=True),
        loaders.load_denoising(None, None, use_motion=True, device=dev, remat=True),
        frozen_dtype=torch.bfloat16)
    step = tsteps.make_train_step(cfg, schedule, state)
    batch, _ = small_train_batch(dev, 12, TRAIN_FRAMES, TRAIN_SIZE)
    g = torch.Generator(device=dev).manual_seed(0)
    phases = {}
    loss_fn, update = tsteps.diffusion_loss, tsteps.Optimizer.update
    clock = {}

    def mark(name):
        torch.cuda.synchronize(dev)
        now = time.perf_counter()
        phases[name] = now - clock["t"]
        clock["t"] = now

    def timed_loss(*a, **k):
        mark("before")
        out = loss_fn(*a, **k)
        mark("forward")
        return out

    def timed_update(self, grads):
        mark("backward")
        fired = update(self, grads)
        mark("optimizer")
        return fired

    def one_step(_steps):
        clock["t"] = time.perf_counter()
        step(batch, g)
        return SimpleNamespace(phases={k: v for k, v in phases.items() if k != "before"})

    tsteps.diffusion_loss, tsteps.Optimizer.update = timed_loss, timed_update
    try:
        with transposed():
            one_step(1)  # warm-up
            torch.cuda.reset_peak_memory_stats(dev)
            res = profile_request(one_step, 1)
    finally:
        tsteps.diffusion_loss, tsteps.Optimizer.update = loss_fn, update
    log_profile("request F, one stage-2 step (transposed)", 1, res)
    total = sum(res[1].values())
    log("profile: request F shares of the step: " + ", ".join(
        f"{k} {v / total:.1%}" for k, v in res[1].items())
        + f"; peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    log("profile: top kernels, request F step (ms, calls, name)")
    for ms, n, name in res[3][:25]:
        log(f"   {ms:10.1f} {n:6d}  {name[:110]}")


def phase_profile(pipe, request_b) -> None:
    """Device time by kernel category of a 2-step and a 20-step request A at
    the headline geometry, per denoise step from their difference, and of a
    20-step request B."""
    def request_a(steps):
        return run_request(pipe, make_inputs(steps, T, H, W), steps)[2]

    request_a(1)  # warm-up
    res = {s: profile_request(request_a, s) for s in (2, 20)}
    for s, r in res.items():
        log_profile("request A", s, r)
    s2, s20 = res[2][2], res[20][2]
    per_step = {c: (s20.get(c, 0.0) - s2.get(c, 0.0)) / 18 for c in set(s2) | set(s20)}
    tot = sum(per_step.values())
    log(f"profile: per denoise step ((20-step - 2-step) / 18): {tot:.1f} ms")
    for cat, ms in sorted(per_step.items(), key=lambda kv: -kv[1]):
        log(f"   {cat:44s} {ms:10.1f} ms  {ms / tot:6.1%}")
    log("profile: top kernels, request A, 20 steps (ms, calls, name)")
    for ms, n, name in res[20][3][:30]:
        log(f"   {ms:10.1f} {n:6d}  {name[:110]}")
    del res
    request_b(1)  # warm-up: the CLIP tower, the temporal decoder's convolutions
    res_b = profile_request(lambda steps: request_b(steps)[2], STEPS)
    log_profile("request B", STEPS, res_b)
    log("profile: top kernels, request B, 20 steps (ms, calls, name)")
    for ms, n, name in res_b[3][:20]:
        log(f"   {ms:10.1f} {n:6d}  {name[:110]}")
    del res_b
    # request E: request A inside row_major(), per step from 6 and 2 steps
    from mikudance_tpu_torch.kernels import row_major

    with row_major():
        request_a(1)  # warm-up: the packed conv weights
        res_e = {s: profile_request(request_a, s) for s in (2, PROFILE_E_STEPS)}
    for s, r in res_e.items():
        log_profile("request E (row-major)", s, r)
    e2, e6 = res_e[2][2], res_e[PROFILE_E_STEPS][2]
    per_step = {c: (e6.get(c, 0.0) - e2.get(c, 0.0)) / (PROFILE_E_STEPS - 2)
                for c in set(e2) | set(e6)}
    tot = sum(per_step.values())
    log(f"profile: request E per denoise step (({PROFILE_E_STEPS}-step - 2-step) / "
        f"{PROFILE_E_STEPS - 2}): {tot:.1f} ms")
    for cat, ms in sorted(per_step.items(), key=lambda kv: -kv[1]):
        log(f"   {cat:44s} {ms:10.1f} ms  {ms / tot:6.1%}")
    log(f"profile: top kernels, request E, {PROFILE_E_STEPS} steps (ms, calls, name)")
    for ms, n, name in res_e[PROFILE_E_STEPS][3][:20]:
        log(f"   {ms:10.1f} {n:6d}  {name[:110]}")


def peak_timer(device):
    """A ``Timer`` that also keeps each phase's peak device memory in GiB
    (``max_memory_allocated``, reset at every mark) in ``peaks``."""
    from mikudance_tpu_torch.utils.profiling import Timer

    class PeakTimer(Timer):
        peaks = None

        def start(self):
            super().start()
            self.peaks = {}
            torch.cuda.reset_peak_memory_stats(self.device)

        def mark(self, name):
            super().mark(name)
            peak = torch.cuda.max_memory_allocated(self.device) / 2**30
            self.peaks[name] = max(self.peaks.get(name, 0.0), peak)
            torch.cuda.reset_peak_memory_stats(self.device)

    return PeakTimer(device)


def phase_text(timer) -> str:
    peaks = getattr(timer, "peaks", None) or {}
    return " ".join(f"{k} {v:.3f}s" + (f" ({peaks[k]:.2f} GiB)" if k in peaks else "")
                    for k, v in timer.phases.items())


def run_request(pipe, inputs, steps: int, decode: bool = True):
    """One ``__call__`` (decode to the host, or the latents alone); returns
    (frames or None, latents, timer)."""
    timer = peak_timer(pipe.device)
    if not decode:
        return None, pipe(*inputs, num_inference_steps=steps, decode=False, timer=timer), timer
    seen = []
    decode_to_host = pipe.decode_to_host

    def spy(latents):  # the latents on their way to the decoder
        seen.append(latents)
        return decode_to_host(latents)

    pipe.decode_to_host = spy
    try:
        frames = pipe(*inputs, num_inference_steps=steps, to_host=True, timer=timer)
    finally:
        del pipe.decode_to_host
    return frames, seen[0], timer


def run_request_b(pipe, seed: int, steps: int):
    """The CLI-shaped request: camera matrices and depth -> flow on the card,
    reference picture -> CLIP tokens through the bundle's tower, then the
    sampler with the bundle's decoder. Returns (frames, latents, timer, flow,
    tokens); the timer's phases start with scene_motion and clip."""
    from mikudance_tpu_torch.pipelines.scene_motion import scene_motion_flow
    from mikudance_tpu_torch.utils.profiling import Timer

    w2c, c2w, depth, picture = make_camera(seed, T, H, W)
    inputs = list(make_inputs(seed, T, H, W))
    before = Timer(pipe.device)
    before.start()
    flow = scene_motion_flow(w2c, c2w, depth, device=pipe.device)
    before.mark("scene_motion")
    tokens = pipe.clip_context(picture)
    before.mark("clip")
    inputs[0], inputs[5], inputs[6] = picture, flow, tokens
    frames, latents, timer = run_request(pipe, inputs, steps)
    timer.phases = {**before.phases, **timer.phases}
    return frames, latents, timer, flow, tokens


def run_request_d(pipe, seed: int, steps: int, frames: int, size: int):
    """The CLI's steps for ``-W size -H size -L frames``: a full-resolution
    depth map resized to the latent grid (bilinear, in torch: the CLI's PIL is
    not needed here), camera matrices -> flow on the card, the reference
    picture -> CLIP tokens, noise from torch's seeded CPU generator in the
    reference's (1, 4, T, h, w) fp16 layout, then the sampler and the decode
    to the host. Returns (frames, latents, timer, flow)."""
    import torch.nn.functional as F

    from mikudance_tpu_torch.pipelines.scene_motion import scene_motion_flow
    from mikudance_tpu_torch.utils.media import torch_seed_noise
    from mikudance_tpu_torch.utils.profiling import Timer

    h = w = size // 8
    w2c, c2w, _, picture = make_camera(seed, frames, size, size)
    depth_full = np.random.default_rng(seed).uniform(0, 1, (1, 1, size, size)).astype(np.float32)
    inputs = list(make_inputs(seed, frames, size, size))
    before = Timer(pipe.device)
    before.start()
    depth = F.interpolate(torch.from_numpy(depth_full), size=(h, w), mode="bilinear",
                          antialias=True)[0, 0].numpy()
    flow = scene_motion_flow(w2c, c2w, depth, device=pipe.device)
    before.mark("scene_motion")
    tokens = pipe.clip_context(picture)
    before.mark("clip")
    noise = np.moveaxis(torch_seed_noise(seed, (1, 4, frames, h, w))[0], 0, -1)
    inputs[0], inputs[5], inputs[6], inputs[7] = picture, flow, tokens, noise
    out, latents, timer = run_request(pipe, inputs, steps)
    timer.phases = {**before.phases, **timer.phases}
    return out, latents, timer, flow


def phase_budgets(bundle, dev) -> None:
    """Peak device memory, phase by phase, of one-step 768^2 requests
    (latents only) as the clip grows: what ``cached_bank_positions`` and
    ``max_denoise_frame_batch`` are derived from. Positions = windows x 30
    frames (16 and 30 frames are one window)."""
    from mikudance_tpu_torch.core.configs import ContextConfig, PipelineConfig
    from mikudance_tpu_torch.pipelines.video import VideoPipeline

    log(f"budgets: weights on the card {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    big = 1 << 20
    cases = [
        ("cached, one UNet batch with CFG folded in", 16, dict(bank_mode="cached")),
        ("cached, one UNet batch with CFG folded in", 30, dict(bank_mode="cached")),
        ("cached, one UNet batch with CFG folded in", 40, dict(bank_mode="cached")),
        ("cached-grouped, one window a group", 40, dict(bank_mode="cached",
                                                        max_denoise_frame_batch=32)),
        ("cached-grouped, one window a group", 48, dict(bank_mode="cached",
                                                        max_denoise_frame_batch=32)),
        ("per-step, one window a group", 48, dict(bank_mode="per_step",
                                                  cached_bank_positions=32)),
        ("per-step, three windows a group", 48, dict(bank_mode="per_step",
                                                     cached_bank_positions=96)),
        ("cached_q8, one window a group", 48, dict(bank_mode="cached_q8",
                                                   cached_bank_positions=64,
                                                   max_denoise_frame_batch=32)),
        # the largest last: a case that does not fit is reported, not fatal
        ("cached-grouped, two windows a group", 74, dict(bank_mode="cached",
                                                         max_denoise_frame_batch=64)),
        ("cached, one UNet batch with CFG folded in", 48, dict(bank_mode="cached")),
        # PipelineConfig's own budgets: three windows in one batch; six windows
        # cached and denoised in two groups; seven windows past the bank budget
        ("the default budgets", 66, None),
        ("the default budgets", 130, None),
        ("the default budgets", 150, None),
    ]
    for what, frames, change in cases:
        base = dict(width=W, height=H, num_inference_steps=1,
                    context=ContextConfig(frames=30, overlap=8))
        if change is None:
            cfg = PipelineConfig(**base)
            what += (f" ({cfg.bank_mode}, cached_bank_positions {cfg.cached_bank_positions}, "
                     f"max_denoise_frame_batch {cfg.max_denoise_frame_batch})")
        else:
            cfg = PipelineConfig(**{**base, "cached_bank_positions": big,
                                    "max_denoise_frame_batch": big, **change})
        pipe = VideoPipeline(bundle, cfg)
        from mikudance_tpu_torch.pipelines import context as ctx_sched
        nw, wf = ctx_sched.window_matrix(frames, 30, 1, 8).shape
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            _, latents, timer = run_request(pipe, make_inputs(frames, frames, H, W), 1,
                                            decode=False)
        except torch.OutOfMemoryError:
            log(f"budgets: {frames} frames = {nw * wf} positions, {what}: out of memory")
            continue
        check(bool(torch.isfinite(latents).all()), f"budgets: {what}, {frames} frames")
        log(f"budgets: {frames} frames = {nw} x {wf} = {nw * wf} positions, {what}: "
            f"{time.perf_counter() - t0:.2f} s | {phase_text(timer)} | whole-request peak "
            f"{max(timer.peaks.values()):.2f} GiB")
        del latents, pipe


def check_video(frames, latents, n_frames: int, what: str, height: int = H,
                width: int = W) -> None:
    check(frames is None or (isinstance(frames, np.ndarray) and frames.dtype == np.uint8
                             and frames.shape == (n_frames, height, width, 3)),
          f"{what}: frames {type(frames)} {getattr(frames, 'shape', '')}")
    check(latents.shape == (n_frames, height // 8, width // 8, 4)
          and bool(torch.isfinite(latents).all()), f"{what}: latents {tuple(latents.shape)} finite")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="device-time breakdown of requests A, B, E and of one request-F "
                         "train step instead of the smoke")
    ap.add_argument("--train", action="store_true",
                    help="build, then requests F and G alone (the trainers, the mega-block)")
    ap.add_argument("--budgets", action="store_true",
                    help="peak memory of one-step 768^2 requests as the clip grows")
    ap.add_argument("--kernels", metavar="K7,K8",
                    help="build, hold the named kernels to their plain versions, and stop")
    args = ap.parse_args()
    # one card, the first visible one, fixed before CUDA initialises
    card = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the card")
    check(torch.cuda.device_count() == 1, f"one card, got {torch.cuda.device_count()}")
    from mikudance_tpu_torch.core.configs import ContextConfig, PipelineConfig
    from mikudance_tpu_torch.kernels import _build, row_major, transposed
    from mikudance_tpu_torch.kernels import mega_block as mb
    from mikudance_tpu_torch.kernels import conv2d as cv
    from mikudance_tpu_torch.kernels import flash_attention as fa
    from mikudance_tpu_torch.kernels import group_norm as gn
    from mikudance_tpu_torch.kernels import layer_norm as ln
    from mikudance_tpu_torch.kernels import linear as lin
    from mikudance_tpu_torch.kernels import temporal_attention as ta
    from mikudance_tpu_torch.models import layers
    from mikudance_tpu_torch.pipelines.image import ImagePipeline
    from mikudance_tpu_torch.pipelines.video import ModelBundle, VideoPipeline

    dev = torch.device("cuda", 0)
    kernels = (fa.K1, fa.K2, ta.K3, fa.K4, gn.K5, ln.K6, lin.K7, cv.K8, fa.K9, fa.K10, fa.K11,
               fa.K12, ta.K13, mb.K14)
    # the row-major configuration's kernels launch only inside row_major();
    # K12 only inside transposed(); K14 is the probe's and on no model's path
    row_major_only = (lin.K7, cv.K8, fa.K10, fa.K11)
    off_the_sampler = (fa.K12, mb.K14)
    default_kernels = [k for k in kernels if k not in row_major_only + off_the_sampler]
    # K9 and K13 take only maps under 512^2: requests A, B and C run at 768^2
    at_768 = [k for k in default_kernels if k not in (fa.K9, ta.K13)]

    def reset_counts() -> None:
        for k in kernels:
            k.launches = 0

    def read_counts(what: str, expect=default_kernels, absent=row_major_only,
                    also_absent=off_the_sampler) -> dict:
        counts = {k.name: k.launches for k in kernels}
        missing = [k.name for k in expect if k.launches == 0]
        check(not missing, f"{what}: kernels not launched: {missing}")
        stray = [k.name for k in tuple(absent) + tuple(also_absent) if k.launches]
        check(not stray, f"{what}: kernels launched that are not on this path: {stray}")
        return counts

    # 1. card
    smi = subprocess.run(["nvidia-smi", "-i", card, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' fp32 scores
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | matmul.allow_tf32=False cudnn.allow_tf32=False")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s "
        f"(ptxas report: {lib.with_suffix('.log')})")

    cfg = PipelineConfig(width=W, height=H, num_inference_steps=STEPS, guidance_scale=3.5,
                         context=ContextConfig(frames=30, overlap=8))

    def headline_pipes():
        """Request A's pipeline (SD VAE) and request B's (same UNets and
        encoder, the temporal decoder and the CLIP tower)."""
        t0 = time.perf_counter()
        bundle = build_bundle(0, dev)
        clip, temporal = build_slice_b_parts(10, dev)
        bundle_b = ModelBundle(bundle.guide, bundle.den, bundle.vae_enc, temporal, clip)
        log(f"bundles: SD1.5 widths, CLIP ViT-L/14 tower, both decoders, bf16, built in "
            f"{time.perf_counter() - t0:.1f} s")
        return bundle, VideoPipeline(bundle, cfg), bundle_b, VideoPipeline(bundle_b, cfg)

    def training_phases():
        """Requests F and G; returns their launch counts (F transposed, F
        default, the stage-1 steps, G)."""
        # 13. request F: the stage-2 trainer at the reference's geometry, a few
        # optimizer steps, in the transposed configuration and in the default one
        train_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                 "chip_smoke")
        before = initial_stage2_weights(dev)
        runs = {}
        # the default configuration first: the transposed run's state is kept
        # for the small step below, the default run's is dropped at once
        for name, configuration in (("default", contextlib.nullcontext),
                                    ("transposed", transposed)):
            reset_counts()
            t0 = time.perf_counter()
            with configuration():
                state, records, phases, peaks = run_training("stage2", TRAIN_STEPS,
                                                             os.path.join(train_dir, name), dev)
            wall = time.perf_counter() - t0
            on_f = [fa.K2, ta.K3, fa.K4, gn.K5, ln.K6] + ([fa.K12, fa.K10] if name == "transposed"
                                                          else [fa.K1])
            launches = read_counts(f"request F ({name})", on_f,
                                   absent=[k for k in kernels if k not in on_f], also_absent=())
            losses = [r["train_loss"] for r in records]
            norms = [r["grad_norm"] for r in records]
            check(all(math.isfinite(v) for v in losses + norms), f"request F ({name}): {records}")
            named = {**{f"guide.{k}": v.cpu() for k, v in state.guide.state_dict().items()},
                     **{f"den.{k}": v.cpu() for k, v in state.den.state_dict().items()}}
            trainable = set(state.trainable)
            check(trainable == {n for n in named if "motion" in n or "man_" in n}
                  and 0 < len(trainable) < len(named),
                  f"request F ({name}): the trainable partition")
            moved = sum(not torch.equal(named[n], before[n]) for n in trainable)
            frozen_moved = [n for n in named if n not in trainable
                            and not torch.equal(named[n], before[n])]
            check(not frozen_moved,
                  f"request F ({name}): frozen parameters moved: {frozen_moved[:3]}")
            check(moved > len(trainable) // 2,
                  f"request F ({name}): {moved} of {len(trainable)} trainable tensors moved")
            check(all(p.dtype == torch.bfloat16 for p in state.den.parameters())
                  and all(m.dtype == torch.float32 for m in state.optimizer.master.values()),
                  f"request F ({name}): bf16 modules, fp32 master copies")
            log(f"request F ({name}): stage 2, {TRAIN_FRAMES}x{TRAIN_SIZE}x{TRAIN_SIZE}, batch "
                f"1, bf16, remat on, {TRAIN_STEPS} optimizer steps in {wall:.1f} s | "
                f"{training_text(phases, peaks)} | losses {losses} | gradient norms {norms} | "
                f"{moved} of {len(trainable)} trainable tensors moved, "
                f"{len(named) - len(trainable)} frozen ones bit-identical | launches {launches}")
            runs[name] = (losses, norms, launches, state if name == "transposed" else None)
            del named, state
        del before
        (loss_t, norm_t, launches_f, state), (loss_d, norm_d, launches_f_default, _) = \
            runs["transposed"], runs["default"]
        runs.clear()
        # the same draws through K12 + K10 and through K1: the first step's loss and
        # gradient norm come from identical weights; later steps follow weights that
        # already differ by one bf16-rounded update. The control: another step's
        # draws (step 2 against step 1).
        rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
        d_loss = [rel(a, b) for a, b in zip(loss_t, loss_d)]
        d_norm = [rel(a, b) for a, b in zip(norm_t, norm_d)]
        ctl_loss = rel(loss_t[1], loss_d[0])
        log(f"request F, transposed against default, same draws: loss apart by {d_loss} (limit "
            f"{F_LOSS_REL}; control, another step's draws, {ctl_loss:.3e}), gradient norm apart "
            f"by {d_norm} (limit {F_NORM_REL})")
        check(max(d_loss) < F_LOSS_REL < ctl_loss,
              f"request F: losses {d_loss}, control {ctl_loss}")
        check(max(d_norm) < F_NORM_REL, f"request F: gradient norms {d_norm}")

        # a small train step (stage 2, full widths, 4 frames at 256^2) through the
        # kernels and with every wrapper forced to its plain version
        from mikudance_tpu_torch.diffusion.ddim import DDIMSchedule
        from mikudance_tpu_torch.train.steps import TrainConfig

        tcfg = TrainConfig(trainable_substrings=("motion", "man_"))
        schedule = DDIMSchedule.create(beta_schedule="linear")
        batch, draws = small_train_batch(dev, 11)
        reset_counts()
        loss_k, grads_k = loss_and_gradients(state, tcfg, schedule, batch, draws)
        used = [k.name for k in kernels if k.launches > 0]
        with plain_kernels():
            counts = {k.name: k.launches for k in kernels}
            loss_p, grads_p = loss_and_gradients(state, tcfg, schedule, batch, draws)
            check(counts == {k.name: k.launches for k in kernels},
                  "the plain step launched a kernel")
        # the control: the sample's banks and tokens switched off
        zero_bank = {**batch, "uncond": torch.ones(1, device=dev)}
        loss_c, grads_c = loss_and_gradients(state, tcfg, schedule, zero_bank, draws)
        rel_g, rel_c = rel_l2(flat(grads_k), flat(grads_p)), rel_l2(flat(grads_c), flat(grads_p))
        log(f"check, train step: stage 2, 4x256x256, kernels {used} vs plain versions: loss "
            f"{loss_k:.6f} vs {loss_p:.6f} (apart by {rel(loss_k, loss_p):.3e}, limit "
            f"{SMALL_STEP_LOSS_REL}), relative L2 of all {len(grads_k)} gradients {rel_g:.3e} "
            f"(limit {SMALL_STEP_GRAD_REL_L2}; control, the conditioning dropped: loss "
            f"{loss_c:.6f}, gradients {rel_c:.3e})")
        check(rel(loss_k, loss_p) < SMALL_STEP_LOSS_REL and grads_k.keys() == grads_p.keys()
              and rel_g < SMALL_STEP_GRAD_REL_L2 < rel_c,
              f"small train step: loss {loss_k} vs {loss_p}, gradients {rel_g} (control {rel_c})")
        check(used == [k.name for k in (fa.K1, fa.K2, ta.K3, gn.K5, ln.K6)],
              f"small train step: kernels {used}")
        del state, grads_k, grads_p, grads_c, batch, draws
        torch.cuda.empty_cache()

        # one stage-1 step at 768^2 (both UNets train; batch cut from 8 to 1)
        reset_counts()
        t0 = time.perf_counter()
        state1, records1, phases1, peaks1 = run_training(
            "stage1", 2, os.path.join(train_dir, "stage1"), dev, data={"train_bs": 1})
        wall = time.perf_counter() - t0
        launches_s1 = read_counts("stage-1 steps", [fa.K1, fa.K2, fa.K4, gn.K5, ln.K6],
                                  absent=[ta.K3, fa.K9, ta.K13])
        check(all(math.isfinite(r["train_loss"]) and math.isfinite(r["grad_norm"])
                  for r in records1)
              and len(state1.trainable) == len(list(state1.guide.parameters()))
              + len(list(state1.den.parameters())), f"stage-1 steps: {records1}")
        log(f"stage-1 steps: 768x768, batch 1, bf16, 2 optimizer steps in {wall:.1f} s | "
            f"{training_text(phases1, peaks1)} | losses {[r['train_loss'] for r in records1]} | "
            f"launches {launches_s1}")
        del state1
        torch.cuda.empty_cache()

        # 14. request G: the mega-block probe against the block's read path
        block, ins, w = mega_inputs(dev, MEGA_LEVELS[0], seed=6)
        read_path = block_read_path(block, *ins)
        reset_counts()
        out_g = mb.mega_block(*ins, w)
        torch.cuda.synchronize()
        launches_g = {k.name: k.launches for k in kernels}
        check(launches_g[mb.K14.name] == 1 and sum(launches_g.values()) == 1,
              f"request G: one launch of K14 and nothing else, got {launches_g}")
        want_g = read_path()
        zero = torch.zeros_like(ins[1])
        rel_g = rel_l2(out_g, want_g)
        rel_g_ctl = rel_l2(mb.mega_block(ins[0], zero, zero, ins[3], ins[4], w), want_g)
        check(out_g.shape == ins[0].shape and bool(torch.isfinite(out_g.float()).all()),
              "request G: finite output of the input's shape")
        ms_g, ms_read = cuda_ms(lambda: mb.mega_block(*ins, w), 5), cuda_ms(read_path, 5)
        log(f"request G: mega-block probe x{MEGA_LEVELS[0]} in one launch {ms_g:.3f} ms; the "
            f"port's TransformerBlock read path on the same weights {ms_read:.3f} ms; relative L2 "
            f"between them {rel_g:.3e} (limit {G_REL_L2}: tanh for erf GELU, an fp32 for a bf16 residual "
            f"stream; control without the bank K/V {rel_g_ctl:.3e})")
        check(rel_g < G_REL_L2 < rel_g_ctl, f"request G: {rel_g:.3e} and the control "
                                            f"{rel_g_ctl:.3e} on either side of {G_REL_L2}")
        del block, ins, w, out_g, want_g, zero

        return launches_f, launches_f_default, launches_s1, launches_g

    if args.budgets:
        phase_budgets(build_bundle(0, dev), dev)
        return 0
    if args.profile and args.train:  # the train step's profile alone
        profile_train_step(dev)
        return 0
    if args.profile:
        _, pipe, _, pipe_b = headline_pipes()
        phase_profile(pipe, lambda steps: run_request_b(pipe_b, 5, steps))
        del pipe, pipe_b
        torch.cuda.empty_cache()
        profile_train_step(dev)
        return 0

    if args.train:
        training_phases()
        return 0
    if args.kernels:
        log((lib.with_suffix(".log")).read_text())
        phase_kernels(dev, tuple(args.kernels.split(",")))
        return 0

    # 3. kernels against plain versions
    record = phase_kernels(dev)

    # 4. request A at the headline geometry
    bundle, pipe, bundle_b, pipe_b = headline_pipes()
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    frames, latents, timer = run_request(pipe, make_inputs(0, T, H, W), STEPS)
    wall = time.perf_counter() - t0
    launches_a = read_counts("request A", at_768)
    check_video(frames, latents, T, "request A")
    phases = phase_text(timer)
    log(f"request A: {T}x{H}x{W} {STEPS} steps in {wall:.3f} s | {phases} | peak "
        f"{max(timer.peaks.values()):.2f} GiB | launches {launches_a} | "
        f"latents std {latents.std().item():.4f} | frames mean {frames.mean():.2f}")

    # 5. request A again, warm, fewer steps
    t0 = time.perf_counter()
    frames_warm, lat_warm, timer = run_request(pipe, make_inputs(1, T, H, W), WARM_STEPS)
    wall = time.perf_counter() - t0
    check_video(frames_warm, lat_warm, T, "request A, warm")
    phases = phase_text(timer)
    log(f"request A, warm, {WARM_STEPS} steps: {wall:.3f} s | {phases}")

    # 6. request B: scene motion, CLIP tower, sampler, temporal decoder
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    frames, latents, timer, flow, tokens = run_request_b(pipe_b, 2, STEPS)
    wall = time.perf_counter() - t0
    launches_b = read_counts("request B", at_768)
    check_video(frames, latents, T, "request B")
    check(flow.shape == (T, H // 8, W // 8, 2) and bool(torch.isfinite(flow).all())
          and bool(flow.any()), f"request B: flow {tuple(flow.shape)} finite and not all zero")
    check(tokens.shape == (1, 257, 768) and bool(np.isfinite(tokens).all()),
          f"request B: CLIP tokens {tokens.shape} finite")
    phases = phase_text(timer)
    log(f"request B: {T}x{H}x{W} {STEPS} steps, temporal decoder, in {wall:.3f} s | {phases} | "
        f"peak {max(timer.peaks.values()):.2f} GiB | launches {launches_b} | "
        f"flow abs max {flow.abs().max().item():.3f} | tokens std {tokens.std():.4f} | "
        f"latents std {latents.std().item():.4f} | frames mean {frames.mean():.2f}")
    del frames, latents, flow

    # 7. the stage-1 image request
    t0 = time.perf_counter()
    guide1, den1 = build_stage1_unets(20, dev)
    image_pipe = ImagePipeline(ModelBundle(guide1, den1, bundle.vae_enc, bundle.vae_dec), cfg)
    built = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    pictures = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(5)]
    noise = rng.normal(0, 1, (1, H // 8, W // 8, 4)).astype(np.float32)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    image = image_pipe(*pictures, tokens, noise).cpu().numpy()
    wall = time.perf_counter() - t0
    # no motion modules at stage 1: K3 is not on this path
    launches_i = read_counts("image request", [k for k in at_768 if k is not ta.K3])
    check(image.shape == (1, H, W, 3) and image.dtype == np.uint8, f"image {image.shape}")
    lat = image_pipe(*pictures, tokens, noise, num_inference_steps=2, decode=False)
    check(lat.shape == (1, H // 8, W // 8, 4) and bool(torch.isfinite(lat).all()),
          "image request: finite latents")
    log(f"image request: {H}x{W} {STEPS} steps in {wall:.3f} s (networks built in {built:.1f} s)"
        f" | launches {launches_i} | image mean {image.mean():.2f}")
    del image_pipe, guide1, den1

    # 8. interpolation: 4 frames become 7
    small = make_inputs(2, 4, 256, 256)
    small_cfg = PipelineConfig(width=256, height=256, num_inference_steps=1,
                               context=ContextConfig(frames=30, overlap=8))
    interp_cfg = PipelineConfig(width=256, height=256, num_inference_steps=1,
                                interpolation_factor=2,
                                context=ContextConfig(frames=30, overlap=8))
    frames = VideoPipeline(bundle, interp_cfg)(*small, to_host=True)
    check(frames.shape == (7, 256, 256, 3), f"interpolation: frames {frames.shape}")
    log(f"interpolation: 4 frames at 256x256, factor 2 -> {frames.shape[0]} frames")

    # 9. small request through the kernels and through the plain versions
    small_pipe = VideoPipeline(bundle, small_cfg)
    reset_counts()
    lat_k = small_pipe(*small, decode=False)
    decoded_k = [VideoPipeline(b, small_cfg)._decode(lat_k).float() for b in (bundle, bundle_b)]
    used = [k.name for k in kernels if k.launches > 0]
    with plain_kernels():
        before = {k.name: k.launches for k in kernels}
        lat_p = small_pipe(*small, decode=False)
        decoded_p = [VideoPipeline(b, small_cfg)._decode(lat_k).float()
                     for b in (bundle, bundle_b)]
        check(before == {k.name: k.launches for k in kernels},
              "the plain run launched a kernel")
    rel = rel_l2(lat_k, lat_p)
    rel_sd, rel_temporal = (rel_l2(a, b) for a, b in zip(decoded_k, decoded_p))
    log(f"check: 4x256x256, 1 step, kernels {used} vs plain versions: relative L2 of the "
        f"latents {rel:.3e}, of the same latents decoded by the SD decoder {rel_sd:.3e}, by "
        f"the temporal decoder {rel_temporal:.3e} (limits {SMALL_REL_L2} for the latents, "
        f"{SMALL_DECODED_REL_L2} for the decoded frames)")
    # 256^2: the VAE takes K9, not K4; a UNet batch of 8 frames stays under K13's 64
    small_kernels = [k.name for k in default_kernels if k not in (fa.K4, ta.K13)]
    check(rel < SMALL_REL_L2 and max(rel_sd, rel_temporal) < SMALL_DECODED_REL_L2
          and used == small_kernels,
          f"small request: rel {rel} {rel_sd} {rel_temporal}, kernels {used}")

    # 10. request C: long clips at 768^2 through the three bank tiers
    def tier_pipe(**change):
        return VideoPipeline(bundle, PipelineConfig(
            width=W, height=H, num_inference_steps=LONG_STEPS, guidance_scale=3.5,
            context=ContextConfig(frames=30, overlap=8), **change))

    def long_request(what, pipe, inputs, decode=True, expect=at_768):
        reset_counts()
        t0 = time.perf_counter()
        frames, latents, timer = run_request(pipe, inputs, LONG_STEPS, decode=decode)
        wall = time.perf_counter() - t0
        counts = read_counts(what, expect)
        n = inputs[2].shape[0]
        check_video(frames, latents, n, what)
        log(f"{what}: {n}x{H}x{W} {LONG_STEPS} steps in {wall:.3f} s | {phase_text(timer)} | "
            f"peak {max(timer.peaks.values()):.2f} GiB | launches {counts} | latents std "
            f"{latents.std().item():.4f}")
        return latents, counts

    from mikudance_tpu_torch.pipelines import video as video_mod

    clip48, clip40 = make_inputs(6, 48, H, W), make_inputs(7, 40, H, W)
    lat_step, launches_c = long_request(
        "request C, 48 frames, auto past 64 cached positions (3 windows, per-step banks)",
        tier_pipe(bank_mode="auto", cached_bank_positions=64), clip48)
    q8_pipe = tier_pipe(bank_mode="cached_q8", cached_bank_positions=64,
                        max_denoise_frame_batch=32)
    lat_q8, launches_q8 = long_request("request C, 48 frames, cached_q8", q8_pipe, clip48)
    dequantize = video_mod.dequantize_banks
    video_mod.dequantize_banks = lambda qv, qs, dtype: dequantize(
        qv, {k: 2 * v for k, v in qs.items()}, dtype)
    try:  # the control: the int8 banks read back with scales off by 2x
        lat_ctl, _ = long_request("request C, control (q8 scales off by 2x)", q8_pipe, clip48,
                                  decode=False)
    finally:
        video_mod.dequantize_banks = dequantize
    lat_grouped, launches_grouped = long_request(
        "request C, 40 frames, max_denoise_frame_batch 32 (2 windows, cached-grouped)",
        tier_pipe(bank_mode="auto", cached_bank_positions=64, max_denoise_frame_batch=32), clip40)
    lat_step40, _ = long_request(
        "request C, 40 frames, per-step banks", tier_pipe(bank_mode="per_step",
                                                          cached_bank_positions=32), clip40,
        decode=False)
    rel_q8, rel_ctl = rel_l2(lat_q8, lat_step), rel_l2(lat_ctl, lat_step)
    rel_grouped = rel_l2(lat_grouped, lat_step40)
    log(f"request C, tiers against one another (relative L2 of the latents): cached_q8 vs "
        f"per-step {rel_q8:.3e} (limit {Q8_REL_L2}; control {rel_ctl:.3e}), cached-grouped vs "
        f"per-step {rel_grouped:.3e} (limit {SMALL_REL_L2})")
    check(rel_q8 < Q8_REL_L2 < rel_ctl, f"cached_q8 {rel_q8:.3e} and its control {rel_ctl:.3e} "
                                        f"on either side of {Q8_REL_L2}")
    check(rel_grouped < SMALL_REL_L2, f"cached-grouped vs per-step {rel_grouped:.3e}")
    del lat_step, lat_q8, lat_ctl, lat_grouped, lat_step40, clip48, clip40

    # 11. request D: the CLI's steps at 256^2, 40 frames, both windows in one batch
    d_pipe = VideoPipeline(bundle_b, PipelineConfig(
        width=D_SIZE, height=D_SIZE, num_inference_steps=D_STEPS, guidance_scale=3.5,
        context=ContextConfig(frames=30, overlap=8), max_denoise_frame_batch=64,
        cached_bank_positions=64))
    reset_counts()
    t0 = time.perf_counter()
    frames, latents, timer, flow = run_request_d(d_pipe, 8, D_STEPS, D_FRAMES, D_SIZE)
    wall = time.perf_counter() - t0
    launches_d = read_counts("request D", [k for k in default_kernels if k is not fa.K4])
    check(launches_d[fa.K4.name] == 0, f"request D launched K4: {launches_d}")
    check_video(frames, latents, D_FRAMES, "request D", D_SIZE, D_SIZE)
    check(bool(flow.any()) and bool(torch.isfinite(flow).all()), "request D: flow")
    log(f"request D: {D_FRAMES}x{D_SIZE}x{D_SIZE} {D_STEPS} steps, temporal decoder, in "
        f"{wall:.3f} s | {phase_text(timer)} | peak {max(timer.peaks.values()):.2f} GiB | "
        f"launches {launches_d} | latents std {latents.std().item():.4f} | frames mean "
        f"{frames.mean():.2f}")

    # 12. request E: warm request A inside the row-major configuration
    seen = {}
    stream = fa.flash_anchor_stream

    def spy(q, k, v, heads):  # one batch element of the first 9216-token call
        if not seen:
            seen["qk"] = (q[:1].clone(), k[:1].clone(), heads)
        return stream(q, k, v, heads)

    fa.flash_anchor_stream = spy
    try:
        with row_major():
            reset_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            frames, latents, timer = run_request(pipe, make_inputs(1, T, H, W), WARM_STEPS)
            wall = time.perf_counter() - t0
            on_e = [k for k in at_768 if k is not fa.K1] + list(row_major_only)
            launches_e = read_counts("request E", on_e, absent=(fa.K1, fa.K9, ta.K13))
    finally:
        fa.flash_anchor_stream = stream
    check_video(frames, latents, T, "request E")
    excursion = fa.anchor_excursion(*seen.pop("qk"))
    rel_e = rel_l2(latents, lat_warm)
    rel_e_frames = rel_l2(torch.from_numpy(frames), torch.from_numpy(frames_warm))
    chain = layers.TransformerBlock._chain
    layers.TransformerBlock._chain = lambda self, x, ref_kv, ctx_kv: chain(self, x, None, ctx_kv)
    try:  # the control: the chain without the bank K/V
        with row_major():
            _, lat_ctl, _ = run_request(pipe, make_inputs(1, T, H, W), WARM_STEPS, decode=False)
    finally:
        layers.TransformerBlock._chain = chain
    rel_e_ctl = rel_l2(lat_ctl, lat_warm)
    log(f"request E (row-major): {T}x{H}x{W} {WARM_STEPS} steps in {wall:.3f} s | "
        f"{phase_text(timer)} | peak {max(timer.peaks.values()):.2f} GiB | launches "
        f"{launches_e} | against warm request A, relative L2: latents {rel_e:.3e} (limit "
        f"{E_REL_L2}; control without the bank K/V {rel_e_ctl:.3e}), decoded frames "
        f"{rel_e_frames:.3e} (limit {E_DECODED_REL_L2}) | largest |s - off| of one level-0 "
        f"self-attention call {excursion:.1f} log2 units (the clamp bites past "
        f"{fa.EXP_CLAMP:.0f})")
    check(rel_e < E_REL_L2 < rel_e_ctl, f"request E latents {rel_e:.3e} and the control "
                                        f"{rel_e_ctl:.3e} on either side of {E_REL_L2}")
    check(rel_e_frames < E_DECODED_REL_L2, f"request E decoded frames {rel_e_frames:.3e}")
    del frames, latents, lat_ctl, frames_warm

    # the small request of phase 9 once more, inside row_major()
    with row_major():
        reset_counts()
        lat_k = small_pipe(*small, decode=False)
        used = [k.name for k in kernels if k.launches > 0]
        with plain_kernels():
            before = {k.name: k.launches for k in kernels}
            lat_p = small_pipe(*small, decode=False)
            check(before == {k.name: k.launches for k in kernels},
                  "the plain row-major run launched a kernel")
    rel = rel_l2(lat_k, lat_p)
    log(f"check, row-major: 4x256x256, 1 step, kernels {used} vs plain versions: relative L2 "
        f"of the latents {rel:.3e} (limit {SMALL_REL_L2})")
    # 256^2: 1024 tokens at level 0 stay under the resident limit (K10, not K11)
    small_row_major = [k.name for k in kernels
                       if k not in (fa.K1, fa.K4, fa.K11, ta.K13) + off_the_sampler]
    check(rel < SMALL_REL_L2 and used == small_row_major,
          f"small row-major request: rel {rel}, kernels {used}")

    # 13-14. requests F and G
    del bundle, pipe, bundle_b, pipe_b, small_pipe, d_pipe, q8_pipe, lat_k, lat_p, lat_warm
    torch.cuda.empty_cache()
    launches_f, launches_f_default, launches_s1, launches_g = training_phases()

    for rec in record.values():
        # launches: from the main path that runs the kernel, request B at
        # 768^2, request D for the two kernels of smaller maps, request E for
        # the row-major configuration's
        on_d = rec["name"] in (fa.K9.name, ta.K13.name)
        rec["launches_request_e"] = launches_e[rec["name"]]
        rec["launches_request_b"] = launches_b[rec["name"]]
        rec["launches_request_c_per_step"] = launches_c[rec["name"]]
        rec["launches_request_c_q8"] = launches_q8[rec["name"]]
        rec["launches_request_c_grouped"] = launches_grouped[rec["name"]]
        rec["launches_request_d"] = launches_d[rec["name"]]
        rec["launches"] = (launches_d if on_d else launches_b)[rec["name"]]
        if rec["name"] in [k.name for k in row_major_only]:
            rec["launches"] = launches_e[rec["name"]]
        rec["launches_request_f"] = launches_f[rec["name"]]
        rec["launches_request_f_default"] = launches_f_default[rec["name"]]
        rec["launches_stage1_steps"] = launches_s1[rec["name"]]
        rec["launches_request_g"] = launches_g[rec["name"]]
        if rec["name"] == fa.K12.name:
            rec["launches"] = launches_f[rec["name"]]
        if rec["name"] == mb.K14.name:
            rec["launches"] = launches_g[rec["name"]]
        rec["launches_request_a"] = launches_a[rec["name"]]
        rec["launches_image_request"] = launches_i[rec["name"]]
    kern_line = {"kernels": list(record.values())}
    print(json.dumps(kern_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
