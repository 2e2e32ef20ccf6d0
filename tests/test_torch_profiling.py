"""The port's profiling tools on the CPU: ``utils/profiling.py`` and
``scripts/profile_pipeline.py``.

The port's video pipeline with a ``Timer`` reports the JAX pipeline's phases
in the JAX order (the same seeded tiny weights, carried over by the JAX
package's converters, and the same inputs), and a timer changes none of its
bits. ``profile_pipeline`` reads CPU time on a tiny CPU pipeline; the
category table, the kernel names and the per-op rows are held on fixed
profiler keys and on a made-up device profile (no card here). torch runs on
2 threads.
"""

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mikudance_tpu.core import convert as jconvert
from mikudance_tpu.core.configs import (ContextConfig, DenoisingUNetConfig, GuidanceUNetConfig,
                                        MotionModuleConfig, PipelineConfig, UNetConfig,
                                        VAEConfig)
from mikudance_tpu.models import unet as junet
from mikudance_tpu.models import vae as jvae
from mikudance_tpu.pipelines import video as jvideo
from mikudance_tpu.utils import profiling as jprofiling
from mikudance_tpu_torch.models import unet, vae
from mikudance_tpu_torch.pipelines import video
from mikudance_tpu_torch.scripts import _synthetic, profile_pipeline as pp
from mikudance_tpu_torch.utils import profiling as pf

TINY = UNetConfig(block_out_channels=(32, 64, 96, 96), attention_heads=4)
TINY_VAE = VAEConfig(block_out_channels=(16, 32, 32, 32), norm_num_groups=8)
T, H, W = 5, 64, 64
CONFIG = PipelineConfig(width=W, height=H, num_inference_steps=3, guidance_scale=3.5,
                        context=ContextConfig(frames=3, overlap=1))
PHASES = ["h2d_normalize", "vae_encode", "guidance_banks", "denoise"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


def seeded(module, seed):
    """PyTorch's init under a seed, zero tensors refilled from numpy and weight
    matrices halved (as ``test_torch_port_pipeline.py`` does)."""
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.copy_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
            if p.ndim > 1:
                p.mul_(0.5)
    return module.eval()


@pytest.fixture(scope="module")
def pipes():
    guide = seeded(unet.GuidanceUNet(GuidanceUNetConfig(unet=TINY, use_man=True)), 0)
    den_cfg = DenoisingUNetConfig(unet=TINY, motion=MotionModuleConfig(num_attention_heads=4))
    den = seeded(unet.DenoisingUNet(den_cfg), 1)
    enc, dec = seeded(vae.Encoder(TINY_VAE), 2), seeded(vae.Decoder(TINY_VAE), 3)
    port = video.VideoPipeline(video.ModelBundle(guide, den, enc, dec), CONFIG, device="cpu")
    jbundle = jvideo.ModelBundle(
        junet.GuidanceUNet(GuidanceUNetConfig(unet=TINY, use_man=True)),
        {"params": jconvert.convert_unet(guide.state_dict(), with_man=True,
                                         with_conv_out=False)},
        junet.DenoisingUNet(den_cfg),
        {"params": jconvert.convert_unet(den.state_dict(), with_motion=True)},
        jvae.Encoder(TINY_VAE), {"params": jconvert.convert_vae_encoder(enc.state_dict())},
        jvae.Decoder(TINY_VAE), {"params": jconvert.convert_vae_decoder(dec.state_dict())},
    )
    return port, jvideo.VideoPipeline(jbundle, CONFIG)


def inputs(seed):
    """uint8 media with all-black face and hand streams, scene motion, CLIP
    tokens and the initial noise."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
            rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
            rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8),
            np.zeros((T, H, W, 3), np.uint8),
            np.zeros((T, H, W, 3), np.uint8),
            rng.normal(0, 0.1, (T, H // 8, W // 8, 2)).astype(np.float32),
            rng.normal(0, 1, (1, 5, 768)).astype(np.float32),
            rng.normal(0, 1, (T, H // 8, W // 8, 4)).astype(np.float32))


# ------------------------------------------------ the pipeline's phases vs JAX

def test_phases_match_jax_and_a_timer_changes_no_bit(pipes):
    """The latents with a Timer: the JAX phase names in the JAX order, the
    same bits as without one, within 1e-3 of the JAX latents."""
    port, jpipe = pipes
    args = inputs(0)
    jt, pt = jprofiling.Timer(), pf.Timer(torch.device("cpu"))
    want = np.asarray(jpipe(*args, decode=False, timer=jt))
    got = port(*args, decode=False, timer=pt)
    assert list(jt.phases) == PHASES
    assert list(pt.phases) == list(jt.phases)
    assert all(v >= 0 for v in pt.phases.values())
    assert torch.equal(got, port(*args, decode=False))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("to_host, last", [(True, "decode_d2h"), (False, "decode")])
def test_decoded_phases_match_jax(pipes, to_host, last):
    """Decoded to the host or on the device: the JAX phase list, and the
    same frames with and without a timer."""
    port, jpipe = pipes
    args = inputs(1)
    jt, pt = jprofiling.Timer(), pf.Timer()
    jpipe(*args, to_host=to_host, timer=jt)
    frames = port(*args, to_host=to_host, timer=pt)
    assert list(pt.phases) == list(jt.phases) == PHASES + [last]
    plain = port(*args, to_host=to_host)
    assert np.array_equal(np.asarray(frames), np.asarray(plain))


def test_streamed_tier_phases(pipes):
    """Per-step banks (the JAX ``denoise_streamed`` branch): no bank phase,
    the streamed denoise after the encode."""
    port, _ = pipes
    pipe = video.VideoPipeline(port.bundle, PipelineConfig(
        width=W, height=H, num_inference_steps=1, guidance_scale=3.5,
        context=ContextConfig(frames=3, overlap=1), bank_mode="per_step"), device="cpu")
    timer = pf.Timer()
    pipe(*inputs(2), decode=False, timer=timer)
    assert list(timer.phases) == ["h2d_normalize", "vae_encode", "denoise_streamed"]


# --------------------------------------------------------- profile_pipeline

def test_profile_pipeline_on_the_cpu(pipes, tmp_path):
    """The script's body on a tiny CPU pipeline: steady state, phases from
    h2d_normalize, a traced call with categories and depth-3 rows (each
    category the sum of its rows), the busy share, the per-step difference,
    the launches of the counters it was given, and its report."""
    port, _ = pipes
    counter = SimpleNamespace(name="K0 nothing", launches=7)
    res = pp.profile_pipeline(port, inputs(3), 2, logdir=str(tmp_path), per_step=3,
                              kernels=[counter])
    assert res["clock"] == "cpu" and res["device"] == "cpu" and res["steps"] == 2
    assert res["steady_s"] > 0 and res["peaks_gib"] == {}
    assert list(res["phases"]) == PHASES + ["decode_d2h"]
    assert abs(sum(res["phases"].values()) - res["phase_wall_s"]) < 0.05 * res["phase_wall_s"]
    assert 0 < res["busy"] <= 1 and res["launches"] == {"K0 nothing": 0}
    assert res["kernels_by_key"] == []
    rows = res["rows"]
    assert rows == sorted(rows, reverse=True) and all(len(r) == 4 for r in rows)
    for cat, (ms, n) in res["categories"].items():
        mine = [r for r in rows if r[2] == cat]
        assert abs(sum(r[0] for r in mine) - ms) <= 1e-9 * max(ms, 1.0)
        assert sum(r[1] for r in mine) == n
    assert abs(sum(v[0] for v in res["categories"].values()) - res["total_ms"]) < 1e-6
    assert {"GEMM (cuBLAS)", pf.ELEMENTWISE} <= set(res["categories"])
    assert any(name.startswith("aten::mm (f32 (") for _, _, _, name in rows)
    trace = json.loads(open(res["trace"]).read())
    assert trace["traceEvents"]
    ps = res["per_step"]
    assert ps["steps"] == 3 and abs(sum(ps["categories"].values()) - ps["total_ms"]) < 1e-6
    spans = res["spans"]
    assert [s.name for s in spans if s.parent is None] == ["clip"]
    assert [s.name for s in spans].count("denoise_step") == 2
    assert sum(res["idle_by_span"].values()) <= res["wall_s"]
    text = pp.profile_report(res, top=5)
    assert text.startswith("steady-state: ") and "h2d_normalize" in text
    assert "the program's spans" in text and "  denoise_step x2 " in text
    assert "per denoise step ((3-step - 2-step) / 1)" in text


def test_profile_pipeline_refuses_a_per_step_of_two(pipes):
    port, _ = pipes
    with pytest.raises(ValueError, match="per_step"):
        pp.profile_pipeline(port, inputs(4), 1, per_step=2)


def test_profile_script_needs_the_card():
    """The command runs on the card: without one it raises, as every entry
    point of the port does when ``device`` is None."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pp.main(["--steps", "1"])


# ------------------------------------------------------- fixed profiler keys

K1_40 = ("void (anonymous namespace)::anchor_wg_kernel<40, 1, false>(CUtensorMap_st, "
         "CUtensorMap_st, void const*, void*, int, int, float)")
KEYS = {
    K1_40: ("K1 hd 40 (S=9216 self)", "anchor_wg_kernel"),
    "void (anonymous namespace)::anchor_wg_kernel<(int)80, (int)1, (bool)0>(CUtensorMap_st)":
        ("K1 hd 80 (S=2304 self)", "anchor_wg_kernel"),
    "void (anonymous namespace)::anchor_wg_kernel<80, 10, false>(CUtensorMap_st)":
        ("K10 anchored attention", "anchor_wg_kernel"),
    "void (anonymous namespace)::anchor_wg_kernel<40, 11, true>(CUtensorMap_st)":
        ("K11 anchored attention", "anchor_wg_kernel"),
    "void (anonymous namespace)::anchor_wg_kernel<160, 12, false>(CUtensorMap_st)":
        ("K12 anchored attention, bf16 anchor", "anchor_wg_kernel"),
    "void (anonymous namespace)::short_attention_kernel<3, 40, 16>(__nv_bfloat16 const*)":
        ("K3 temporal attention", "short_attention_kernel"),
    "void (anonymous namespace)::short_attention_kernel<13, 80, 32>(__nv_bfloat16 const*)":
        ("K13 small-sequence attention", "short_attention_kernel"),
    "void fft2d_r2c_32x32<float, false, 1u, false>(float2*, float const*, int, int, int)":
        ("FFT convolution (cuDNN)", "fft2d_r2c_32x32"),
    "void gn_stream_stats_kernel<__nv_bfloat16>(__nv_bfloat16 const*, float*, long long)":
        ("K5 GroupNorm (resident; streamed statistics, apply)", "gn_stream_stats_kernel"),
    "Memcpy HtoD (Pageable -> Device)":
        ("host-device copies (memcpy, memset)", "Memcpy HtoD (Pageable -> Device)"),
    "nvjet_tst_128x256_64x4_2x1_v_bz_coopB_NNT": ("GEMM (cuBLAS)",
                                                  "nvjet_tst_128x256_64x4_2x1_v_bz_coopB_NNT"),
    "void (anonymous namespace)::flash_cross_kernel<80>(__nv_bfloat16 const*)":
        ("K2 hd 80 (S=2304 cross)", "flash_cross_kernel"),
}
ADD = ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add"
       "<c10::BFloat16>, std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add"
       "<c10::BFloat16>, std::array<char*, 3ul>)")
CAST = ("void at::native::vectorized_elementwise_kernel<4, at::native::bfloat16_copy_kernel_"
        "cuda(at::TensorIteratorBase&)::{lambda(float)#1}, std::array<char*, 2ul> >(int, "
        "at::native::bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1}, "
        "std::array<char*, 2ul>)")
CAT = ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous "
       "namespace)::OpaqueType<2u>, unsigned int, 4, 128, 1>(at::native::(anonymous namespace)"
       "::OpaqueType<2u>*, unsigned int)")
GEMM = "nvjet_tst_128x256_64x4_2x1_v_bz_coopB_NNT"
SPIN = "at::cuda::(anonymous namespace)::spin_kernel(long)"
MUL = ("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<c10::"
       "BFloat16, c10::BFloat16, c10::BFloat16, at::native::binary_internal::MulFunctor<float> "
       ">, std::array<char*, 2ul> >(int)")


@pytest.mark.parametrize("key", list(KEYS))
def test_kernel_name_and_category(key):
    cat, name = KEYS[key]
    assert pf.category(key) == cat
    assert pf.kernel_name(key) == name


@pytest.mark.parametrize("key, named", [
    (ADD, "vectorized_elementwise_kernel [CUDAFunctor_add]"),
    (CAST, "vectorized_elementwise_kernel [bfloat16_copy_kernel_cuda]"),
    (CAT, "CatArrayBatchedCopy"),
    (MUL, "vectorized_elementwise_kernel [MulFunctor]")])
def test_a_kernel_no_op_launched_keeps_its_name_and_functor(key, named):
    assert pf.category(key) == pf.ELEMENTWISE
    assert pf.unattached_name(key) == named


def device_event(key, us):
    return SimpleNamespace(name=key, device_type=pf.DeviceType.CUDA, is_async=False,
                           is_user_annotation=False, kernels=[],
                           time_range=SimpleNamespace(elapsed_us=lambda: us))


def op_event(op_id, name, kernels, shapes, dtypes, cpu_us=1.0, span_us=10.0):
    """A CPU op; ``dtypes`` None: a torch whose events do not keep them."""
    event = SimpleNamespace(id=op_id, name=name, device_type=pf.DeviceType.CPU, is_async=False,
                            kernels=[SimpleNamespace(name=k, duration=us) for k, us in kernels],
                            input_shapes=shapes, self_cpu_time_total=cpu_us,
                            time_range=SimpleNamespace(elapsed_us=lambda: span_us))
    if dtypes is not None:
        event.input_dtypes = dtypes
    return event


BIG = [32, 9216, 320]


def made_up_profile(with_dtypes=True):
    """A request's worth of device events on a made-up profiler: two adds of
    one op, a cast, a raw copy no op launched (attached to its runtime
    call), K1 from the ctypes entry (no op), a cuBLAS product under
    ``aten::mm``, CUPTI's "Command Buffer Full" span inside the second
    add's launch, which carries its kernel too, and three kernels of the
    run-in (the rest dropped).
    Without dtypes on the events, the raw events have them."""
    bf16, cast = ["c10::BFloat16", "c10::BFloat16", "Scalar"], ["c10::BFloat16", "float", "Scalar"]
    mm = ["c10::BFloat16", "c10::BFloat16"]
    keep = (lambda d: d) if with_dtypes else (lambda d: None)
    ops = [op_event(1, "aten::add", [(ADD, 100.0)], [BIG, BIG, []], keep(bf16)),
           op_event(2, "aten::add", [(ADD, 110.0)], [BIG, BIG, []], keep(bf16)),
           op_event(2, "Command Buffer Full", [(ADD, 110.0)], [], keep([]), span_us=2.0),
           op_event(3, "aten::copy_", [(CAST, 40.0)], [BIG, BIG, []], keep(cast)),
           op_event(4, "aten::mm", [(GEMM, 300.0)], [[294912, 320], [320, 320]], keep(mm)),
           op_event(5, "cudaLaunchKernel", [(CAT, 25.0)], [], keep([])),
           op_event(6, "cudaLaunchKernel", [(SPIN, 1.0)], [], keep([]))]
    devices = [device_event(ADD, 100.0), device_event(ADD, 110.0), device_event(CAST, 40.0),
               device_event(CAT, 25.0), device_event(K1_40, 500.0),
               device_event(GEMM, 300.0)] + [device_event(SPIN, 1.0)] * 3
    raw = [SimpleNamespace(correlation_id=lambda i=i: i, name=lambda n=n: n,
                           dtypes=lambda d=d: d, device_type=lambda: pf.DeviceType.CPU)
           for i, n, d in ((1, "aten::add", bf16), (2, "aten::add", bf16),
                           (3, "aten::copy_", cast), (4, "aten::mm", mm))]
    return SimpleNamespace(events=lambda: ops + devices, profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: raw)))


@pytest.mark.parametrize("with_dtypes", [True, False])
def test_device_rows_by_launching_op(with_dtypes):
    """Depth 3 on a device profile: the elementwise rows named by the ATen op
    that launched them, with dtypes and shapes; a kernel without an op by
    its name and functor; a kernel counted once; each category the sum of
    its rows."""
    prof = made_up_profile(with_dtypes)
    rows = pf.op_profile_rows(prof, depth=3)
    assert rows[0] == (0.5, 1, "K1 hd 40 (S=9216 self)", "anchor_wg_kernel")
    named = {name: (ms, n, cat) for ms, n, cat, name in rows}
    add = "aten::add (bf16 (32, 9216, 320), bf16 (32, 9216, 320))"
    assert named[add] == (pytest.approx(0.21), 2, pf.ELEMENTWISE)
    assert named["aten::copy_ (bf16 (32, 9216, 320), f32 (32, 9216, 320))"][2] == pf.ELEMENTWISE
    assert named["CatArrayBatchedCopy"] == (0.025, 1, pf.ELEMENTWISE)
    assert named["aten::mm (bf16 (294912, 320), bf16 (320, 320))"][2] == "GEMM (cuBLAS)"
    cats = {cat: (ms, n) for ms, n, cat, _ in pf.op_profile_rows(prof, depth=2)}
    assert cats[pf.ELEMENTWISE] == (pytest.approx(0.275), 4)
    assert sum(ms for ms, _ in cats.values()) == pytest.approx(1.075)
    assert pf.op_profile_summary(prof, top=1) == [(0.5, "K1 hd 40 (S=9216 self)")]
    assert pf.clock_of(prof) == "device" and pf.run_in_lost(prof) == pf.RUN_IN - 3
    assert not any("spin" in name for *_, name in rows)
    host = pf.op_profile_rows(prof, depth=3, host=True)
    assert sum(n for _, n, _, _ in host) == 6 and {r[3].split(" ")[0] for r in host} == {
        "aten::add", "aten::copy_", "aten::mm", "Command", "cudaLaunchKernel"}


def test_kernel_calls_and_the_control_without_k1():
    """The profiler's calls of each kernel's device symbols by the category
    tags; K5's statistics launch is not a launch; a table without K1's tags
    counts no K1."""
    gn_apply = "void gn_stream_apply_kernel<__nv_bfloat16, float, true>(__nv_bfloat16 const*)"
    gn_stats = "void gn_stream_stats_kernel<__nv_bfloat16>(__nv_bfloat16 const*)"
    k1_80 = "void (anonymous namespace)::anchor_wg_kernel<80, 1, false>(CUtensorMap_st)"
    by_key = [(9.0, 10, K1_40), (1.0, 4, k1_80), (2.0, 3, gn_apply), (1.0, 3, gn_stats),
              (1.0, 50, ADD)]
    assert pf.kernel_calls(by_key) == {"K1": 14, "K5": 3}
    control = [c for c in pf.PROFILE_CATEGORIES if not c[0].startswith("K1 ")]
    assert pf.kernel_calls(by_key, control) == {"K5": 3}


# ------------------------------------------------------------ the utilities

def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with pf.trace(str(tmp_path / "t"), device="cpu") as prof:
        (x @ x).relu_()
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "t")
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert pf.clock_of(prof) == "cpu"
    with pf.trace(None, device="cpu") as prof:
        x.sum()
    assert prof.trace_path is None and not os.listdir(tmp_path / "t")[1:]


def test_timer_phase_report_and_force_as_the_jax_ones():
    """``mark`` charges the time since the previous mark (or ``start``) to a
    name, adding up over the marks of one name, in the order first marked;
    ``force`` returns the first leaf's sum."""
    timer = pf.Timer()
    timer.start()
    for _ in range(2):
        time.sleep(0.01)
        timer.mark("sleep")
    timer.mark("mark")
    assert list(timer.phases) == ["sleep", "mark"] and timer.phases["sleep"] >= 0.02
    assert 0 <= timer.phases["mark"] < timer.phases["sleep"]
    assert not hasattr(timer, "phase") and not hasattr(timer, "report")
    assert pf.force(({"x": torch.full((2, 2), 0.5)}, torch.ones(1))) == 2.0
    assert pf.force([]) == 0.0


def test_synthetic_inputs_and_seeded_modules():
    """The smoke's request inputs: uint8 media, black absent streams, zero
    motion, seeded; seeded modules in bf16 with no all-zero tensor."""
    a, b = _synthetic.make_inputs(3, 2, 16, 24), _synthetic.make_inputs(3, 2, 16, 24)
    assert [x.shape for x in a] == [(16, 24, 3), (16, 24, 3), (2, 16, 24, 3), (2, 16, 24, 3),
                                    (2, 16, 24, 3), (2, 2, 3, 2), (1, 257, 768), (2, 2, 3, 4)]
    assert all(np.array_equal(x, y) for x, y in zip(a, b)) and not a[3].any()
    (lin,) = _synthetic.seeded_modules(5, "cpu", lambda: [torch.nn.Linear(4, 3)])
    assert lin.weight.dtype == torch.bfloat16 and lin.bias.any()


@pytest.mark.parametrize("what", ["the port's new modules", "chip_smoke.py"])
def test_no_jax_import(what):
    """The profiling module, the profile script, the synthetic bundle and the
    smoke import neither JAX nor the JAX package."""
    mods = ("mikudance_tpu_torch.utils.profiling, mikudance_tpu_torch.scripts.profile_pipeline,"
            " mikudance_tpu_torch.scripts._synthetic" if what != "chip_smoke.py" else "chip_smoke")
    code = (f"import sys; sys.path.insert(0, {REPO!r}); import {mods}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'mikudance_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr


# ------------------------------------------------------- the program's spans

@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder in place of the process's one."""
    fresh = pf.Recorder()
    monkeypatch.setattr(pf, "RECORDER", fresh)
    return fresh


def cpu_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def test_span_sites_with_no_profiler_record_nothing(recorder, monkeypatch):
    """With no profiler session a span site is the shared no-op context: it
    reads no clock, makes no event, records nothing and keeps no memory."""
    assert pf.span("clip") is pf.span("denoise_step")

    def boom(*_a, **_k):
        raise AssertionError("a span site read a clock or made an event")

    import tracemalloc

    def sites(n):
        for _ in range(n):
            with pf.span("train_step"):
                with pf.span("forward"):
                    pf.count(pf.HOST_SYNCS)

    with monkeypatch.context() as patched:
        patched.setattr(time, "time_ns", boom)
        patched.setattr(time, "perf_counter", boom)
        patched.setattr(torch.cuda, "Event", boom)
        sites(10)
        mine = [tracemalloc.Filter(True, pf.__file__)]
        rises = []
        tracemalloc.start()
        try:
            kept = tracemalloc.take_snapshot().filter_traces(mine)
            for _ in range(3):  # the least of three: another thread may allocate meanwhile
                before = tracemalloc.get_traced_memory()[0]
                tracemalloc.reset_peak()
                sites(10000)
                rises.append(tracemalloc.get_traced_memory()[1] - before)
            grown = tracemalloc.take_snapshot().filter_traces(mine).compare_to(kept, "lineno")
        finally:
            tracemalloc.stop()
    assert [d for d in grown if d.size_diff > 0] == [] and min(rises) < 1024, (grown, rises)
    assert pf.recorded() == [] and recorder.session is None and recorder.open == []


def test_spans_nest_with_parents_requests_counters_and_self_time(recorder):
    """Under a profiler on the CPU: parents, request ids, counters and self
    time; no device times without a card; a second session drops the first
    session's spans, whether it is read between the two or ``trace`` opens
    the second."""
    with cpu_profile():
        with pf.span("r"):
            with pf.span("a"):
                time.sleep(0.002)
                pf.count("n", 2)
                pf.count("n")
            with pf.span("b"):
                with pf.span("c"):
                    time.sleep(0.001)
                pf.count("m")
        with pf.span("r"):
            pf.count("n")
    spans = pf.recorded()
    assert [s.name for s in spans] == ["r", "a", "b", "c", "r"]
    assert [s.parent for s in spans] == [None, 0, 0, 2, None]
    assert [s.request for s in spans] == [0, 0, 0, 0, 1]
    assert [s.counters for s in spans] == [{}, {"n": 3}, {"m": 1}, {}, {"n": 1}]
    assert all(s.device_ns is None and s.device_ms is None for s in spans)
    r, a, b, c = spans[:4]
    assert r.host_ns[0] <= a.host_ns[0] <= a.host_ns[1] <= b.host_ns[0] <= c.host_ns[0] \
        <= c.host_ns[1] <= b.host_ns[1] <= r.host_ns[1]
    own = pf.self_ns(spans)
    length = {s.index: s.host_ns[1] - s.host_ns[0] for s in spans}
    assert own[0] == length[0] - length[1] - length[2] >= 0
    assert own[2] == length[2] - length[3] and own[3] == length[3] and own[4] == length[4]
    assert a.host_ms >= 2.0 and pf.self_ns(spans, device=True) == {}
    lines = pf.span_tree(spans)
    assert lines[1].split()[:2] == ["r", "x2"] and lines[2].split()[0] == "a"
    assert lines[4].startswith("    c ") and lines[1].split()[-1] == "0"
    assert pf.recorded() == spans  # read again: the same session
    with cpu_profile():
        with pf.span("z"):
            pass
    assert [(s.name, s.request, s.parent) for s in pf.recorded()] == [("z", 0, None)]
    with pf.trace(None, device="cpu"):
        with pf.span("y"):
            pass
    with pf.trace(None, device="cpu"):
        with pf.span("x"):
            pass
    assert [s.name for s in pf.recorded()] == ["x"]
    pf.count("n")  # no session open: nothing to charge, nothing raised
    assert recorder.open == []


def test_busy_is_the_union_of_overlapping_records():
    """Overlapping records count once: busy never passes the window, where
    their summed durations do; the idle gaps are named by the innermost span
    they began in."""
    recs = [(0, 10, "k"), (5, 15, "k"), (20, 30, "k"), (25, 26, "k"), (40, 45, "k")]
    assert sum(e - s for s, e, _ in recs) > 30
    assert pf.union(recs) == [(0, 15), (20, 30), (40, 45)]
    assert pf.busy_ns(recs[:4], 0, 30) == 25 <= 30
    assert pf.busy_ns(recs, 2, 42) == 13 + 10 + 2
    assert pf.gaps(recs, 0, 50) == [(15, 20), (30, 40), (45, 50)]

    def rec(name, index, parent, lo, hi):
        return pf.SpanRecord(name, index, parent, 0, (lo, hi), None, {})

    spans = [rec("clip", 0, None, 0, 44), rec("denoise", 1, 0, 10, 35),
             rec("denoise_step", 2, 1, 12, 18), rec("denoise_step", 3, 1, 18, 28)]
    named = pf.idle_by_span(pf.gaps(recs, 0, 50), spans)
    assert named == pytest.approx({"denoise_step": 5e-9, "denoise": 10e-9,
                                   "between spans": 5e-9})


def test_profile_text_reads_busy_as_the_union():
    res = (2.0, {"denoise": 1.5}, {"GEMM (cuBLAS)": 1500.0, pf.ELEMENTWISE: 900.0}, [], 1.8)
    text = pf.profile_text("request A", 20, res)
    assert "kernel time 2.400 s (busy 90.0%)" in text


def test_pipeline_spans_and_the_same_frames_traced_or_not(pipes):
    """The tiny CPU pipeline under a profiler: one ``clip`` with its phases,
    the projection and one ``denoise_step`` a step under ``denoise``; the
    frames bit for bit the same with the profiler on and off, with a Timer
    and without."""
    port, _ = pipes
    args = inputs(5)
    plain = port(*args, to_host=True)
    with cpu_profile():
        traced = port(*args, to_host=True)
    spans = pf.recorded()
    with cpu_profile():
        timed = port(*args, to_host=True, timer=pf.Timer())
    assert [s.name for s in pf.recorded()] == [s.name for s in spans]
    assert np.array_equal(plain, traced) and np.array_equal(plain, timed)
    assert np.array_equal(plain, port(*args, to_host=True, timer=pf.Timer()))
    (clip,) = [s for s in spans if s.parent is None]
    children = [s for s in spans if s.parent == clip.index]
    assert clip.name == "clip" and {s.request for s in spans} == {0}
    assert [s.name for s in children] == PHASES + ["decode_d2h"]
    denoise = children[3]
    inner = [s.name for s in spans if s.parent == denoise.index]
    assert inner == ["bank_kv"] + ["denoise_step"] * CONFIG.num_inference_steps
    assert all(s.parent in (clip.index, denoise.index) for s in spans[1:])


def test_streamed_tier_spans(pipes):
    """Per-step banks: ``denoise_step`` spans under ``denoise_streamed``."""
    port, _ = pipes
    pipe = video.VideoPipeline(port.bundle, PipelineConfig(
        width=W, height=H, num_inference_steps=2, guidance_scale=3.5,
        context=ContextConfig(frames=3, overlap=1), bank_mode="per_step"), device="cpu")
    with cpu_profile():
        pipe(*inputs(2), decode=False)
    spans = pf.recorded()
    assert [s.name for s in spans] == ["clip", "h2d_normalize", "vae_encode", "denoise_streamed",
                                       "denoise_step", "denoise_step"]
    assert [s.parent for s in spans[4:]] == [3, 3]


def tiny_train(seed=0):
    """A stage-2 train step on tiny seeded UNets and its state."""
    from mikudance_tpu_torch.core import configs as pcfg
    from mikudance_tpu_torch.diffusion import ddim
    from mikudance_tpu_torch.train import steps

    u = pcfg.UNetConfig(block_out_channels=(32, 64), layers_per_block=1, attention_heads=4)
    torch.manual_seed(seed)
    guide = seeded(unet.GuidanceUNet(pcfg.GuidanceUNetConfig(unet=u, use_man=True)), seed)
    den = seeded(unet.DenoisingUNet(pcfg.DenoisingUNetConfig(
        unet=u, motion=pcfg.MotionModuleConfig(num_attention_heads=4))), seed + 1)
    cfg = steps.TrainConfig(learning_rate=1e-3, trainable_substrings=("motion", "man_"))
    state = steps.init_train_state(cfg, guide.train(), den.train())
    schedule = ddim.DDIMSchedule.create(beta_schedule="scaled_linear")
    return steps.make_train_step(cfg, schedule, state), state


def train_batch(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"latents": (1, 2, 8, 8, 4), "cond20": (1, 2, 8, 8, 20), "motion": (1, 2, 8, 8, 2),
              "clip_ctx": (1, 5, 768)}
    batch = {k: torch.from_numpy(rng.normal(size=v).astype(np.float32))
             for k, v in shapes.items()}
    batch["uncond"] = torch.zeros(1)
    return batch


def test_train_step_spans_and_the_same_step_traced_or_not():
    """The tiny train step under a profiler: ``forward``, ``backward``,
    ``gradients`` and ``optimizer`` under ``train_step``, one request a step;
    loss, gradient norm and parameters bit for bit the same on and off."""
    (plain, plain_state), (traced, traced_state) = tiny_train(), tiny_train()
    for i in range(2):
        batch = train_batch(i)
        want = plain(batch, torch.Generator().manual_seed(i))
        with cpu_profile():
            got = traced(batch, torch.Generator().manual_seed(i))
        assert torch.equal(want["loss"], got["loss"]) and want["grad_norm"] == got["grad_norm"]
        spans = pf.recorded()
        assert [(s.name, s.parent) for s in spans] == [
            ("train_step", None), ("forward", 0), ("backward", 0), ("gradients", 0),
            ("optimizer", 0)]
    want_p, got_p = plain_state.trainable, traced_state.trainable
    assert list(want_p) == list(got_p)
    assert all(torch.equal(want_p[k], got_p[k]) for k in want_p)
    assert plain_state.step == traced_state.step == 2
