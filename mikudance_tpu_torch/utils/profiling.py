"""Tracing and profiling for the port, the counterpart of
``mikudance_tpu/utils/profiling.py``.

- ``trace(log_dir, device)``: torch.profiler around a block, writing a Chrome
  trace into ``log_dir`` (it opens in Perfetto, ui.perfetto.dev); yields the
  profiler so that the summaries below read it without the file.
- ``force(x)``: synchronise a tensor's device and return a float.
- ``Timer``: wall time per named phase, ``mark`` (the pipelines) and
  ``phase`` / ``report`` (the JAX Timer's); ``PeakTimer`` adds each phase's
  peak device memory.
- ``op_profile_rows`` / ``op_profile_summary``: time by category (depth 2) and
  per op (depth 3) of a profiler run, device time where the run has any, else
  CPU time. ``PROFILE_CATEGORIES`` gives a kernel's category by its name.
- ``device_ms``, ``profile_request``, ``profile_text``, ``host_and_kernels_ms``,
  ``kernel_calls``: the readings ``chip_smoke.py`` and
  ``scripts/profile_pipeline.py`` print and check.
"""

from __future__ import annotations

import contextlib
import os
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType

# kernel-name (and, for a run on the CPU, ATen-op-name) substrings ->
# category, first match wins. Keys and tags are compared without spaces,
# namespaces' "(anonymous namespace)::" or casts such as "(int)", so a tag
# "anchor_wg_kernel<40, 1," matches "anchor_wg_kernel<40, 1, false>(...)".
PROFILE_CATEGORIES = [
    # K1, K10, K11 and K12 are one kernel (template <HD, tag, fp32>), K4 and K9
    # another; the tag in the template arguments parts them
    ("K1 hd 40 (S=9216 self)", ("anchor_wg_kernel<40, 1,",)),
    ("K1 hd 80 (S=2304 self)", ("anchor_wg_kernel<80, 1,",)),
    ("K1 hd 160 (S=1024 self)", ("anchor_wg_kernel<160, 1,",)),
    ("K1 hd 32 (the tiny VAE)", ("anchor_wg_kernel<32, 1,",)),
    ("K2 hd 40 (S=9216 cross)", ("flash_cross_kernel<40>",)),
    ("K2 hd 80 (S=2304 cross)", ("flash_cross_kernel<80>",)),
    ("K2 hd 160 (S=1024 cross)", ("flash_cross_kernel<160>",)),
    ("K4 hd 512 (VAE)", ("flash_wide_kernel<4>",)),
    ("K9 hd 512 (VAE under 512^2)", ("flash_wide_kernel<9>",)),
    # K3 and K13 are one kernel; the tag (3 or 13) leads its template arguments
    ("K3 temporal attention", ("short_attention_kernel<3,",)),
    ("K13 small-sequence attention", ("short_attention_kernel<13,",)),
    ("K5 GroupNorm (resident; streamed statistics, apply)", ("gn_resident_kernel",
                                                             "gn_stream_stats_kernel",
                                                             "gn_stream_apply_kernel")),
    ("K6 LayerNorm", ("ln_kernel",)),
    ("K7 linear (the chain's products)", ("linear_kernel",)),
    ("K8 conv3x3", ("conv3x3_kernel",)),
    ("K12 anchored attention, bf16 anchor", ("anchor_wg_kernel<40, 12,",
                                             "anchor_wg_kernel<80, 12,",
                                             "anchor_wg_kernel<160, 12,")),
    ("K14 mega-block", ("mega_kernel",)),
    ("K10 anchored attention", ("anchor_wg_kernel<40, 10,", "anchor_wg_kernel<80, 10,",
                                "anchor_wg_kernel<160, 10,")),
    ("K11 anchored attention", ("anchor_wg_kernel<40, 11,", "anchor_wg_kernel<80, 11,",
                                "anchor_wg_kernel<160, 11,")),
    # cuDNN's FFT algorithm (its transforms and gemvx products) before the
    # other convolutions, whose names it shares
    ("FFT convolution (cuDNN)", ("fft", "gemvx", "region_transform")),
    ("conv (cuDNN)", ("fprop", "conv", "implicit_gemm", "cudnn", "nhwc")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "Kernel2", "sm90_xmma", "dot",
                       "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")),
    ("deformable sampling (grid_sample)", ("grid_sampler",)),
    ("softmax", ("softmax",)),
    ("norms (LayerNorm, GroupNorm)", ("layer_norm", "group_norm", "LayerNorm", "GroupNorm")),
    ("sort (top-k)", ("sort", "Sort", "radix", "topk")),
    ("reduce (norm statistics, sums)", ("reduce_kernel", "aten::sum", "aten::mean",
                                        "aten::var", "aten::std", "aten::amax")),
    ("host-device copies (memcpy, memset)", ("Memcpy", "Memset")),
    ("elementwise / copies", ("elementwise", "vectorized", "copy", "Cat", "index", "fill",
                              "gather", "roll", "where", "upsample", "aten::")),
]
# The profiler can drop the first device records of a session in a process
# that has profiled before: on an H100, 0 to ~45 records of a 2-step request
# (its frames' copy first), 1.5 to 11 minutes into a process; never in the
# first session of a fresh one; an idle wait of 0.5 s after the start did not
# help. So ``trace`` opens with a run-in of RUN_IN empty spin kernels on the
# card, which the loss eats first and which every reading leaves out.
RUN_IN = 1024
RUN_IN_KERNEL = "spin_kernel("
# Device symbols that a C entry point launches beside its one counted kernel:
# K5's streamed variant launches statistics, then apply (counted).
SECOND_LAUNCHES = ("gn_stream_stats_kernel",)
ELEMENTWISE = "elementwise / copies"

_CASTS = re.compile(r"\((?:unsigned |signed )?(?:int|bool|long|char|short|long long)\)")
_SKIP_IDS = {"at", "native", "c10", "std", "void", "const", "operator", "lambda", "array",
             "char", "int", "unsigned", "long", "float", "double", "bool", "BFloat16", "Half",
             "anonymous", "namespace", "memory", "detail", "TensorIteratorBase"}
# generic wrappers around the functor that names the operation
_WRAPPERS = ("gpu_kernel", "BinaryFunctor", "AUnaryFunctor", "BUnaryFunctor", "UnaryFunctor",
             "ReduceOp")
_FUNCTOR = re.compile(r"Functor|functor|Kernel|kernel|_cuda$|Ops?$")
_DTYPES = {"c10::BFloat16": "bf16", "float": "f32", "c10::Half": "f16", "double": "f64",
           "unsigned char": "u8", "signed char": "i8", "long int": "i64", "long": "i64",
           "int": "i32", "bool": "bool", "short int": "i16"}


def _plain(text: str) -> str:
    return re.sub(r"\s+", "", _CASTS.sub("", text.replace("(anonymous namespace)::", "")))


def categoriser(categories=PROFILE_CATEGORIES):
    """``category`` for one table, its tags prepared once and its answers
    kept: a profile holds a kernel name many times."""
    tags = [(c, tuple(_plain(t) for t in ts)) for c, ts in categories]
    known: Dict[str, str] = {}

    def of(key: str) -> str:
        if key not in known:
            k = _plain(key)
            known[key] = next((c for c, ts in tags if any(t in k for t in ts)), "other")
        return known[key]
    return of


def category(key: str, categories=PROFILE_CATEGORIES) -> str:
    """The category of a kernel (or, in a run on the CPU, an op) name."""
    return categoriser(categories)(key)


def kernel_name(key: str) -> str:
    """A profiler key's kernel name without its namespaces, template and
    function arguments ("void (anonymous namespace)::gn_kernel<8>(...)" ->
    "gn_kernel"); a key that is no function's (a copy) as it is."""
    if key.startswith(("Memcpy", "Memset")):
        return key
    found = re.search(r"(\w+)\s*[<(]", key.replace("(anonymous namespace)::", ""))
    return found.group(1) if found else key


def functor(key: str) -> Optional[str]:
    """The functor named in a kernel's template arguments, which says what an
    ATen elementwise kernel computes ("CUDAFunctor_add",
    "bfloat16_copy_kernel_cuda", "MulFunctor"), or None."""
    name = kernel_name(key)
    at = key.find(name + "<")
    if at < 0:
        return None
    found = [s for s in re.findall(r"[A-Za-z_]\w*", key[at + len(name):])
             if s not in _SKIP_IDS and s != name and _FUNCTOR.search(s)]
    plain = [s for s in found if not s.startswith(_WRAPPERS)]
    return (plain or found or [None])[0]


def unattached_name(key: str) -> str:
    """A row's name for a kernel that no ATen op launched: its kernel name,
    with the functor from its template arguments where there is one."""
    f = functor(key)
    return kernel_name(key) + (f" [{f}]" if f else "")


def op_label(event, dtypes=None) -> str:
    """An op with its tensor inputs' dtypes and shapes, as the profiler
    recorded them ("aten::add (bf16 (32, 9216, 320), bf16 (32, 9216, 320))");
    ``dtypes`` ({(id, name): dtypes}, ``input_dtypes``) where the event does
    not carry them."""
    shapes = getattr(event, "input_shapes", None) or []
    dtypes = (getattr(event, "input_dtypes", None) or (dtypes or {}).get((event.id, event.name))
              or [""] * len(shapes))
    parts = []
    for shape, dt in zip(shapes, dtypes):
        if not isinstance(shape, (list, tuple)) or (dt and dt not in _DTYPES):
            continue
        if not shape and not dt:
            continue
        dims = tuple(int(s) for s in shape if isinstance(s, int))
        parts.append(f"{_DTYPES.get(dt, '?')} {dims}")
    return event.name + (f" ({', '.join(parts)})" if parts else "")


def input_dtypes(prof) -> dict:
    """{(id, name): input dtypes} of the CPU ops, from the profiler's raw
    events: a torch whose ``FunctionEvent`` does not keep the dtypes it
    recorded still has them there."""
    try:
        return {(e.correlation_id(), e.name()): list(e.dtypes())
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CPU}
    except AttributeError:
        return {}


def _is_device(event) -> bool:
    """A kernel, copy or memset on the card (not a user annotation's span nor
    the run-in)."""
    return (event.device_type == DeviceType.CUDA and not event.is_async
            and not getattr(event, "is_user_annotation", False)
            and RUN_IN_KERNEL not in (getattr(event, "name", None) or event.key))


def _is_run_in(event) -> bool:
    """A run-in spin kernel, or the runtime call that launched it."""
    if event.device_type == DeviceType.CUDA:
        return RUN_IN_KERNEL in event.name
    return bool(event.kernels) and all(RUN_IN_KERNEL in k.name for k in event.kernels)


def run_in_lost(prof) -> int:
    """How many of ``trace``'s run-in kernels the profiler dropped: where it
    is under RUN_IN, the records it drops come from the run-in alone."""
    return RUN_IN - sum(1 for e in prof.events()
                        if e.device_type == DeviceType.CUDA and RUN_IN_KERNEL in e.name)


# ------------------------------------------------------------------ tracing
@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None):
    """torch.profiler around the block: CPU activity always, CUDA activity
    where ``device`` is the card (``None`` means the card; then the block
    follows the run-in, RUN_IN), input shapes recorded. Yields the profiler;
    on the way out writes its Chrome trace to ``<log_dir>/trace-<ns>.json``
    (``prof.trace_path``) unless ``log_dir`` is None."""
    from torch.profiler import ProfilerActivity, profile

    from ..core.params import resolve_device

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, record_shapes=True) as prof:
        if cuda:  # the run-in (RUN_IN)
            with torch.cuda.device(dev):
                for _ in range(RUN_IN):
                    torch.cuda._sleep(0)
                torch.cuda.synchronize(dev)
        yield prof
    prof.trace_path = None
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.trace_path = os.path.join(log_dir, f"trace-{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_path)


def _leaves(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return []


def force(x) -> float:
    """Synchronise by reading a scalar back: the sum of the first tensor in
    ``x`` (a tensor or a nest of lists, tuples and dicts), after everything
    queued on its device (returns the value)."""
    leaves = _leaves(x)
    if not leaves:
        return 0.0
    value = float(leaves[0].float().sum())
    if leaves[0].device.type == "cuda":
        torch.cuda.synchronize(leaves[0].device)
    return value


class Timer:
    """Wall time per named phase. ``mark(name)`` synchronises the device
    (so the phase's queued kernels are inside it), then charges the time since
    the previous mark to ``name``; ``phase(name)`` charges a block's time."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device(device) if device is not None else None
        self.phases: Dict[str, float] = {}
        self._t0 = time.perf_counter()

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def mark(self, name: str) -> None:
        self._sync()
        now = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + now - self._t0
        self._t0 = now

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        """Charge the block's wall time to ``name``, after ``force(sync_on)``
        and the timer's device have synchronised."""
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            force(sync_on)
        self._sync()
        self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{k}: {v:.3f}s ({100*v/max(total,1e-9):.0f}%)" for k, v in self.phases.items()]
        return " | ".join(lines) + f" | total {total:.3f}s"

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class PeakTimer(Timer):
    """A ``Timer`` on the card that also keeps each phase's peak device
    memory in GiB (``max_memory_allocated``, reset at every mark) in
    ``peaks``."""

    peaks: Dict[str, float]

    def start(self) -> None:
        super().start()
        self.peaks = {}
        torch.cuda.reset_peak_memory_stats(self.device)

    def mark(self, name: str) -> None:
        super().mark(name)
        peak = torch.cuda.max_memory_allocated(self.device) / 2**30
        self.peaks[name] = max(self.peaks.get(name, 0.0), peak)
        torch.cuda.reset_peak_memory_stats(self.device)


# ----------------------------------------------------------- the summaries
def _op_rows(prof, host: bool) -> Tuple[Dict[Tuple[str, str], List[float]], str]:
    """{(category, name): [us, calls]} of a profiler run and the clock read
    ("device" or "cpu"). Device time: every kernel's time goes to the ATen op
    that launched it (its name, dtypes and shapes), a kernel no op launched
    to a row of its kernel name; the kernel's name gives the category. CPU
    time (a run without device activity, or ``host``): each op's self time,
    its name giving the category."""
    events, of = prof.events(), categoriser()
    device = [e for e in events if _is_device(e)] if not host else []
    cpu = [e for e in events if e.device_type != DeviceType.CUDA and not e.is_async
           and not _is_run_in(e)]
    dtypes = input_dtypes(prof) if cpu and not hasattr(cpu[0], "input_dtypes") else None
    rows: Dict[Tuple[str, str], List[float]] = defaultdict(lambda: [0.0, 0])
    if not device:
        for e in cpu:
            if e.self_cpu_time_total > 0:
                row = rows[(of(e.name), op_label(e, dtypes))]
                row[0] += e.self_cpu_time_total
                row[1] += 1
        return rows, "cpu"
    total, attached = defaultdict(lambda: [0.0, 0]), defaultdict(lambda: [0.0, 0])
    for e in device:
        t = total[e.name]
        t[0] += e.time_range.elapsed_us()
        t[1] += 1
    # a kernel is attached to every CPU event of its op's id (CUPTI's "Command
    # Buffer Full" span inside the launch has it too): the op is the longest.
    # One launched from no op is attached to its runtime call (cudaLaunchKernel),
    # which is no op: it keeps its kernel's name
    launcher = {}
    for e in cpu:
        if e.kernels and not e.name.startswith("cu") and (
                e.id not in launcher
                or e.time_range.elapsed_us() > launcher[e.id].time_range.elapsed_us()):
            launcher[e.id] = e
    for e in launcher.values():
        for k in e.kernels:
            row, seen = rows[(of(k.name), op_label(e, dtypes))], attached[k.name]
            row[0] += k.duration
            row[1] += 1
            seen[0] += k.duration
            seen[1] += 1
    for key, (us, n) in total.items():
        seen_us, seen_n = attached[key]
        if n > seen_n:
            row = rows[(of(key), unattached_name(key))]
            row[0] += us - seen_us
            row[1] += n - seen_n
    return rows, "device"


def category_totals(rows) -> Dict[str, List[float]]:
    """{category: [ms, calls]} of (ms, calls, category, name) rows."""
    cats: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for ms, n, cat, _ in rows:
        cats[cat][0] += ms
        cats[cat][1] += n
    return dict(cats)


def op_profile_rows(prof, depth: int = 3, host: bool = False) -> List[tuple]:
    """Rows (ms, calls, category, name) of a torch.profiler run, sorted by
    time, descending. depth=2 sums each category (name ""); depth=3 gives
    one row per op: the ATen op that launched a kernel, with its inputs'
    dtypes and shapes, or the kernel's name where no op launched it. Device
    time where the run has device activity, else (or with ``host``) each op's
    self CPU time. The rows of a category add up to its depth-2 row."""
    rows = sorted(((us / 1e3, n, cat, name) for (cat, name), (us, n) in
                   _op_rows(prof, host)[0].items()), reverse=True)
    if depth == 2:
        rows = sorted(((ms, n, cat, "") for cat, (ms, n) in category_totals(rows).items()),
                      reverse=True)
    return rows


def op_profile_summary(prof, top: int = 12) -> List[Tuple[float, str]]:
    """The top categories by time: [(ms, category)]."""
    return [(ms, cat) for ms, _, cat, _ in op_profile_rows(prof, depth=2)[:top]]


def clock_of(prof) -> str:
    """"device" where the run has device activity, else "cpu"."""
    return "device" if any(_is_device(e) for e in prof.events()) else "cpu"


def device_ms(prof, categories=PROFILE_CATEGORIES):
    """A torch.profiler run's device milliseconds by category and
    [(ms, calls, kernel key)] sorted by time."""
    sums, top, of = defaultdict(float), [], categoriser(categories)
    for e in prof.key_averages():
        if not _is_device(e) or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        sums[of(e.key)] += ms
        top.append((ms, e.count, e.key))
    return sums, sorted(top, reverse=True)


def kernel_calls(by_key, categories=PROFILE_CATEGORIES) -> Dict[str, int]:
    """Launches of the port's kernels by the profiler's count of their
    device symbols: {"K1": calls, ...} from [(ms, calls, key)], a kernel's
    categories being those whose label starts with its name. A symbol that an
    entry point launches beside its counted one (``SECOND_LAUNCHES``) is left
    out, so each count can be held to ``CudaKernel.launches``."""
    calls: Dict[str, int] = defaultdict(int)
    of = categoriser(categories)
    for _ms, n, key in by_key:
        found = re.match(r"(K\d+) ", of(key))
        if found and not any(s in key for s in SECOND_LAUNCHES):
            calls[found.group(1)] += n
    return dict(calls)


def profile_request(run, steps: int, device=None):
    """``run(steps)`` (one request, returning its Timer) under the profiler:
    (wall s, phases, ms by category, [(ms, calls, kernel key)] sorted by time)."""
    with trace(None, device) as prof:
        t0 = time.perf_counter()
        timer = run(steps)
        wall = time.perf_counter() - t0
    return (wall, timer.phases) + device_ms(prof)


def profile_text(name: str, steps: int, res) -> str:
    """``profile_request``'s result as lines: wall, kernel time, busy share,
    phases, then ms by category."""
    wall, phases, sums, _ = res
    busy = sum(sums.values())
    lines = [f"profile: {name}, {steps} steps: wall {wall:.3f} s, kernel time "
             f"{busy / 1e3:.3f} s (busy {busy / 1e3 / wall:.1%}), phases "
             + " ".join(f"{k} {v:.3f}s" for k, v in phases.items())]
    lines += [f"   {cat:44s} {ms:10.1f} ms  {ms / busy:6.1%}"
              for cat, ms in sorted(sums.items(), key=lambda kv: -kv[1])]
    return "\n".join(lines)


def host_and_kernels_ms(fn, reps: int = 100) -> Tuple[float, dict]:
    """``fn``'s host time a call (wall clock over ``reps`` calls with no
    synchronisation between them) and its device time a call split by kernel
    name (the name up to its template arguments), in ms."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    with trace(None) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_kernel: Dict[str, float] = defaultdict(float)
    for e in prof.key_averages():
        if _is_device(e):
            by_kernel[kernel_name(e.key)] += e.self_device_time_total / reps / 1e3
    return host, dict(by_kernel)
