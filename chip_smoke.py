#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py             # the smoke, below
    python3 chip_smoke.py --profile   # device-time breakdown of the request

Phases, in order, one line each; any failure exits non-zero:

1. card: the device and its power limit (nvidia-smi), TF32 switches;
2. build: nvcc builds the kernel library from ``mikudance_tpu_torch/csrc``;
3. kernels: K1-K4 against their plain PyTorch versions at main-path shapes,
   bf16 N(0, 1) inputs, atol = rtol = 2e-2 and a relative-L2 limit, with a
   wrong-scale control that the limit must reject, and median times of both;
4. request: ``VideoPipeline.__call__`` at the headline geometry (16 uint8
   frames at 768^2, SD1.5 widths, context 30/8, CFG 3.5, absent face/hand
   streams, SD-VAE decode to the host) with random seeded weights in bf16;
   checks shape, dtype, finite latents and that every kernel launched;
5. second request with another seed (the first one included warm-up);
6. check: a small request (256^2, 4 frames, one step) through the kernels
   and through the plain versions, same weights and inputs.

It prints the kernel record (one JSON object; ``ms`` and ``plain_ms`` at
each kernel's first, largest shape above), the nvidia-smi line, and last
the result line. Uses one card, the first visible one; imports nothing of
JAX.

``--profile`` runs phases 1-2, then torch.profiler over one 2-step and one
20-step request (after a 1-step warm-up) and prints device time by kernel
category, per request and per denoise step, and the top kernels.
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


def build_bundle(seed: int, device):
    """SD1.5-width guidance UNet (MAN), denoising UNet (motion modules) and SD
    VAE with PyTorch's default init under a seed; every tensor that starts at
    zero (biases, norm shifts, the motion modules' proj_out) is refilled with
    seeded N(0, 1e-2) so that every branch, K3's included, reaches the video.
    Then cast to bf16."""
    from mikudance_tpu_torch.core.configs import DenoisingUNetConfig, GuidanceUNetConfig
    from mikudance_tpu_torch.core.params import cast_params
    from mikudance_tpu_torch.models.unet import DenoisingUNet, GuidanceUNet
    from mikudance_tpu_torch.models.vae import Decoder, Encoder
    from mikudance_tpu_torch.pipelines.video import ModelBundle

    torch.manual_seed(seed)
    with torch.device(device):
        mods = [GuidanceUNet(GuidanceUNetConfig()), DenoisingUNet(DenoisingUNetConfig()),
                Encoder(), Decoder()]
    g = torch.Generator(device=device).manual_seed(seed + 1)
    with torch.no_grad():
        for m in mods:
            for p in m.parameters():
                if not p.any():
                    p.normal_(0.0, 1e-2, generator=g)
            cast_params(m.eval(), torch.bfloat16)
    return ModelBundle(*mods)


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


@contextlib.contextmanager
def plain_attention():
    """Route the attention dispatcher to the plain versions (reference run)."""
    from mikudance_tpu_torch.kernels import flash_attention as fa
    from mikudance_tpu_torch.kernels import temporal_attention as ta

    names = ("flash_attention_fullc", "cross_attention", "flash_attention_wide",
             "temporal_attention")
    saved = {n: getattr(fa, n) for n in names}
    for n in names[:3]:
        setattr(fa, n, fa.dot_product_attention)
    fa.temporal_attention = ta.temporal_attention_plain
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(fa, n, f)


def phase_kernels(dev):
    """K1-K4 against their plain versions at the main path's shapes."""
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
    record = {}
    for kern, fn, plain, shapes, heads in cases:
        args = [r(*s) for s in shapes] + [heads]
        got = fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        err = (got.float() - want.float()).abs().max().item()
        rel = rel_l2(got, want)
        control = rel_l2(got, plain(args[0] * CONTROL_Q_SCALE, *args[1:]))
        what = f"{kern.name} q{shapes[0]} kv{shapes[1][1]} heads {heads}"
        torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=RTOL,
                                   msg=lambda m: f"{what}: {m}")
        check(rel < REL_L2, f"{what}: relative L2 {rel:.3e} >= {REL_L2}")
        check(control > REL_L2, f"{what}: the wrong-scale control reads {control:.3e}, "
                                f"under the limit {REL_L2}: the check cannot fail")
        ms = cuda_ms(lambda: fn(*args), 5)
        plain_ms = cuda_ms(lambda: plain(*args), 3)
        log(f"kernels: {what}: max_abs_err {err:.3e}  rel_l2 {rel:.3e} (limit {REL_L2}; "
            f"wrong-scale control {control:.3e})  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms")
        # the record keeps each kernel's first (largest) shape's times
        rec = record.setdefault(kern.name, {"name": kern.name, "route": "cuda",
                                            "source": kern.source, "replaces": kern.replaces,
                                            "launches": 0, "max_abs_err": 0.0, "ms": ms,
                                            "plain_ms": plain_ms})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        del args, got, want
    return record


# kernel-name substrings -> category, first match wins
PROFILE_CATEGORIES = [
    ("K1/K2 hd 40 (S=9216 self + cross)", ("attn_tile_kernel<48",)),
    ("K1/K2 hd 80 (S=2304 self + cross)", ("attn_tile_kernel<80",)),
    ("K4 hd 512 (VAE)", ("attn_tile_kernel<512",)),
    ("K3 temporal", ("temporal_kernel",)),
    ("conv (cuDNN)", ("fprop", "conv", "implicit_gemm", "cudnn", "nhwc")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "Kernel2")),
    ("softmax (plain attention)", ("softmax",)),
    ("reduce (norm statistics)", ("reduce_kernel",)),
    ("elementwise / copies", ("elementwise", "vectorized", "copy", "Cat", "index", "fill")),
]


def profile_request(pipe, steps: int, seed: int):
    """One request under torch.profiler: (wall s, phases, ms by category,
    [(ms, calls, kernel name)] sorted by time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, timer = run_request(pipe, make_inputs(seed, T, H, W), steps)
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


def phase_profile(pipe) -> None:
    """Device time by kernel category of a 2-step and a 20-step request at the
    headline geometry, and per denoise step from their difference."""
    run_request(pipe, make_inputs(9, T, H, W), 1)  # warm-up
    res = {s: profile_request(pipe, s, s) for s in (2, 20)}
    for s, (wall, phases, sums, _) in res.items():
        busy = sum(sums.values())
        log(f"profile: {s} steps: wall {wall:.3f} s, kernel time {busy / 1e3:.3f} s "
            f"(busy {busy / 1e3 / wall:.1%}), phases "
            + " ".join(f"{k} {v:.3f}s" for k, v in phases.items()))
        for cat, ms in sorted(sums.items(), key=lambda kv: -kv[1]):
            log(f"   {cat:44s} {ms:10.1f} ms  {ms / busy:6.1%}")
    s2, s20 = res[2][2], res[20][2]
    per_step = {c: (s20.get(c, 0.0) - s2.get(c, 0.0)) / 18 for c in set(s2) | set(s20)}
    tot = sum(per_step.values())
    log(f"profile: per denoise step ((20-step - 2-step) / 18): {tot:.1f} ms")
    for cat, ms in sorted(per_step.items(), key=lambda kv: -kv[1]):
        log(f"   {cat:44s} {ms:10.1f} ms  {ms / tot:6.1%}")
    log("profile: top kernels, 20 steps (ms, calls, name)")
    for ms, n, name in res[20][3][:30]:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="device-time breakdown of the request instead of the smoke")
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
    from mikudance_tpu_torch.kernels import temporal_attention as ta
    from mikudance_tpu_torch.pipelines.video import VideoPipeline

    dev = torch.device("cuda", 0)
    kernels = (fa.K1, fa.K2, ta.K3, fa.K4)

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

    def headline_pipe():
        t0 = time.perf_counter()
        bundle = build_bundle(0, dev)
        cfg = PipelineConfig(width=W, height=H, num_inference_steps=STEPS, guidance_scale=3.5,
                             context=ContextConfig(frames=30, overlap=8))
        log(f"bundle: SD1.5 widths, bf16, built in {time.perf_counter() - t0:.1f} s")
        return bundle, VideoPipeline(bundle, cfg)

    if args.profile:
        phase_profile(headline_pipe()[1])
        return 0

    # 3. kernels against plain versions
    record = phase_kernels(dev)

    # 4. one request at the headline geometry
    bundle, pipe = headline_pipe()
    inputs = make_inputs(0, T, H, W)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    frames, latents, timer = run_request(pipe, inputs, STEPS)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    check(isinstance(frames, np.ndarray) and frames.shape == (T, H, W, 3)
          and frames.dtype == np.uint8, f"frames {type(frames)} {getattr(frames, 'shape', '')}")
    check(latents.shape == (T, H // 8, W // 8, 4) and bool(torch.isfinite(latents).all()),
          f"latents {tuple(latents.shape)} finite")
    missing = [n for n, c in launches.items() if c == 0]
    check(not missing, f"kernels not launched on the main path: {missing}")
    phases = " ".join(f"{k} {v:.3f}s" for k, v in timer.phases.items())
    log(f"request: {T}x{H}x{W} {STEPS} steps in {wall:.3f} s | {phases} | peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB | launches {launches} | "
        f"latents std {latents.std().item():.4f} | frames mean {frames.mean():.2f}")

    # 5. a second request, warm
    t0 = time.perf_counter()
    frames2, latents2, timer2 = run_request(pipe, make_inputs(1, T, H, W), STEPS)
    wall2 = time.perf_counter() - t0
    check(frames2.shape == (T, H, W, 3) and bool(torch.isfinite(latents2).all()),
          "second request: shape and finite latents")
    phases2 = " ".join(f"{k} {v:.3f}s" for k, v in timer2.phases.items())
    log(f"request 2: {wall2:.3f} s | {phases2}")
    del frames, frames2, latents, latents2

    # 6. small request through the kernels and through the plain versions
    small = make_inputs(2, 4, 256, 256)
    small_cfg = PipelineConfig(width=256, height=256, num_inference_steps=1,
                               context=ContextConfig(frames=30, overlap=8))
    small_pipe = VideoPipeline(bundle, small_cfg)
    before = {k.name: k.launches for k in kernels}
    lat_k = small_pipe(*small, decode=False)
    used = [k.name for k in kernels if k.launches > before[k.name]]
    with plain_attention():
        lat_p = small_pipe(*small, decode=False)
    rel = ((lat_k - lat_p).norm() / lat_p.norm()).item()
    log(f"check: 4x256x256, 1 step, kernels {used} vs plain versions: relative L2 "
        f"{rel:.3e} (limit {SMALL_REL_L2})")
    check(rel < SMALL_REL_L2 and len(used) == 4, f"small request: rel {rel}, kernels {used}")

    for rec in record.values():
        rec["launches"] = launches[rec["name"]]
    kern_line = {"kernels": list(record.values())}
    print(json.dumps(kern_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
