#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card.

    python3 chip_smoke.py             # the smoke, below
    python3 chip_smoke.py --profile   # device-time breakdown of requests A and B

Phases, in order, one line each; any failure exits non-zero:

1. card: the device and its power limit (nvidia-smi), TF32 switches;
2. build: nvcc builds the kernel library from ``mikudance_tpu_torch/csrc``;
3. kernels: K1-K6 against their plain PyTorch versions at the paths' shapes,
   atol = rtol = 2e-2 and a relative-L2 limit, each with a control that the
   limit must reject (K1-K4: softmax scale off by 9% on bf16 N(0, 1) inputs;
   K5: the wrong group size, K6: a row width miscounted by 20%, both on
   inputs with a per-channel offset and spread, K6's with a per-row offset
   too), median times of the
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
   decoded by each decoder both ways.

The kernel counts are set to 0 just before each of A, B and the image
request and read just after. It prints the kernel record (one JSON object;
``ms``, ``plain_ms``, ``library_ms`` and ``bound_ms`` at each kernel's first,
largest shape; ``launches`` from request B), the nvidia-smi line, and last
the result line. Uses one card, the first visible one; imports nothing of
JAX.

``--profile`` runs phases 1-2, then torch.profiler over a 2-step and a
20-step request A and a 20-step request B (after a 1-step warm-up) and
prints device time by kernel category, per request and per denoise step,
and the top kernels.
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
# The card's published peaks (H100 SXM): device memory, dense bf16 tensor
# cores, fp32 outside the tensor cores.
PEAK_BYTES, PEAK_BF16, PEAK_FP32 = 3.35e12, 989e12, 67e12


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
    """Route all six kernels to their plain versions (reference run)."""
    from mikudance_tpu_torch.kernels import flash_attention as fa
    from mikudance_tpu_torch.kernels import group_norm as gn
    from mikudance_tpu_torch.kernels import layer_norm as ln
    from mikudance_tpu_torch.kernels import temporal_attention as ta
    from mikudance_tpu_torch.models import layers

    patches = [(fa, n, fa.dot_product_attention)
               for n in ("flash_attention_fullc", "cross_attention", "flash_attention_wide")]
    patches += [(fa, "temporal_attention", ta.temporal_attention_plain),
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


def attention_cases(dev):
    """K1-K4 at the sampler's shapes: (kernel, label, run, plain, control,
    library, flops, bytes)."""
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
        (fa.K4, fa.flash_attention_wide, fa.dot_product_attention, [(8, 9216, 512)] * 3, 1),
    ]
    for kern, fn, plain, shapes, heads in cases:
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


def norm_cases(dev):
    """K5 and K6 at the shapes the UNets, the VAEs (the temporal decoder's
    joint norm over 16 frames included) and the CLIP tower give them."""
    import torch.nn.functional as F

    from mikudance_tpu_torch.kernels import group_norm as gn
    from mikudance_tpu_torch.kernels import layer_norm as ln

    g = torch.Generator(device=dev).manual_seed(1)
    eps, groups = 1e-6, 32
    for shape, silu in (((32, 96, 96, 320), True), ((32, 96, 96, 960), False),
                        ((32, 12, 12, 2560), False), ((8, 768, 768, 128), True),
                        ((1, 12288, 768, 128), True)):
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
    for shape in ((32, 9216, 320), (32, 2304, 640), (32, 576, 1280), (2, 16, 9216, 320),
                  (1, 257, 1024)):
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


def phase_kernels(dev):
    """K1-K6 against their plain versions at the paths' shapes. Returns the
    kernel record: per kernel the times at its first (largest) shape."""
    import itertools

    record = {}
    for kern, what, run, plain, control, library, flops, nbytes, peak in itertools.chain(
            attention_cases(dev), norm_cases(dev)):
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
        library_ms = cuda_ms(library, 5)
        # the least time the card could take: every input read once and every
        # output written once at the memory rate, or the operations at the
        # peak rate of their type, whichever is longer
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
        bound_ms, bound_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        chose = library_kernel_name(library)
        if kern.name.startswith("K4"):  # head width 512: which backend takes it
            chose = f"{chose}; {sdpa_backend_times(library)}"
        log(f"kernels: {what}: max_abs_err {err:.3e}  rel_l2 {rel:.3e} (limit {REL_L2}; "
            f"control {ctl:.3e})  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  library "
            f"{library_ms:.3f} ms ({chose})  bound {bound_ms:.3f} ms by {bound_by}")
        # the record keeps each kernel's first (largest) shape's times
        rec = record.setdefault(kern.name, {
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": 0, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shape": what.split(" ", 2)[2]})
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


def run_request(pipe, inputs, steps: int):
    """One ``__call__`` (decode to the host); returns (frames, latents, timer)."""
    from mikudance_tpu_torch.utils.profiling import Timer

    seen = []
    decode_to_host = pipe.decode_to_host

    def spy(latents):  # the latents on their way to the decoder
        seen.append(latents)
        return decode_to_host(latents)

    pipe.decode_to_host = spy
    timer = Timer(pipe.device)
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


def check_video(frames, latents, n_frames: int, what: str) -> None:
    check(isinstance(frames, np.ndarray) and frames.shape == (n_frames, H, W, 3)
          and frames.dtype == np.uint8,
          f"{what}: frames {type(frames)} {getattr(frames, 'shape', '')}")
    check(latents.shape == (n_frames, H // 8, W // 8, 4)
          and bool(torch.isfinite(latents).all()), f"{what}: latents {tuple(latents.shape)} finite")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="device-time breakdown of requests A and B instead of the smoke")
    args = ap.parse_args()
    # one card, the first visible one, fixed before CUDA initialises
    card = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the card")
    check(torch.cuda.device_count() == 1, f"one card, got {torch.cuda.device_count()}")
    from mikudance_tpu_torch.core.configs import ContextConfig, PipelineConfig
    from mikudance_tpu_torch.kernels import _build
    from mikudance_tpu_torch.kernels import flash_attention as fa
    from mikudance_tpu_torch.kernels import group_norm as gn
    from mikudance_tpu_torch.kernels import layer_norm as ln
    from mikudance_tpu_torch.kernels import temporal_attention as ta
    from mikudance_tpu_torch.pipelines.image import ImagePipeline
    from mikudance_tpu_torch.pipelines.video import ModelBundle, VideoPipeline

    dev = torch.device("cuda", 0)
    kernels = (fa.K1, fa.K2, ta.K3, fa.K4, gn.K5, ln.K6)

    def reset_counts() -> None:
        for k in kernels:
            k.launches = 0

    def read_counts(what: str, expect=kernels) -> dict:
        counts = {k.name: k.launches for k in kernels}
        missing = [k.name for k in expect if k.launches == 0]
        check(not missing, f"{what}: kernels not launched: {missing}")
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

    if args.profile:
        _, pipe, _, pipe_b = headline_pipes()
        phase_profile(pipe, lambda steps: run_request_b(pipe_b, 5, steps))
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
    launches_a = read_counts("request A")
    check_video(frames, latents, T, "request A")
    phases = " ".join(f"{k} {v:.3f}s" for k, v in timer.phases.items())
    log(f"request A: {T}x{H}x{W} {STEPS} steps in {wall:.3f} s | {phases} | peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB | launches {launches_a} | "
        f"latents std {latents.std().item():.4f} | frames mean {frames.mean():.2f}")

    # 5. request A again, warm, fewer steps
    t0 = time.perf_counter()
    frames, latents, timer = run_request(pipe, make_inputs(1, T, H, W), WARM_STEPS)
    wall = time.perf_counter() - t0
    check_video(frames, latents, T, "request A, warm")
    phases = " ".join(f"{k} {v:.3f}s" for k, v in timer.phases.items())
    log(f"request A, warm, {WARM_STEPS} steps: {wall:.3f} s | {phases}")

    # 6. request B: scene motion, CLIP tower, sampler, temporal decoder
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    frames, latents, timer, flow, tokens = run_request_b(pipe_b, 2, STEPS)
    wall = time.perf_counter() - t0
    launches_b = read_counts("request B")
    check_video(frames, latents, T, "request B")
    check(flow.shape == (T, H // 8, W // 8, 2) and bool(torch.isfinite(flow).all())
          and bool(flow.any()), f"request B: flow {tuple(flow.shape)} finite and not all zero")
    check(tokens.shape == (1, 257, 768) and bool(np.isfinite(tokens).all()),
          f"request B: CLIP tokens {tokens.shape} finite")
    phases = " ".join(f"{k} {v:.3f}s" for k, v in timer.phases.items())
    log(f"request B: {T}x{H}x{W} {STEPS} steps, temporal decoder, in {wall:.3f} s | {phases} | "
        f"peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB | launches {launches_b} | "
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
    launches_i = read_counts("image request", [k for k in kernels if k is not ta.K3])
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
    check(rel < SMALL_REL_L2 and max(rel_sd, rel_temporal) < SMALL_DECODED_REL_L2
          and len(used) == len(kernels),
          f"small request: rel {rel} {rel_sd} {rel_temporal}, kernels {used}")

    for rec in record.values():
        rec["launches"] = launches_b[rec["name"]]
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
