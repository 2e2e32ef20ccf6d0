"""Tracing and profiling for the port, the counterpart of
``mikudance_tpu/utils/profiling.py``.

- ``trace(log_dir, device)``: torch.profiler around a block, writing a Chrome
  trace into ``log_dir`` (it opens in Perfetto, ui.perfetto.dev); yields the
  profiler so that the summaries below read it without the file.
- ``span(name)`` / ``count(name, n)`` / ``recorded()``: the program's own
  spans and counters, recorded while a profiler session is open (and only
  then), on the clock of the profiler's device records; see "The program's
  spans" below.
- ``force(x)``: synchronise a tensor's device and return a float.
- ``Timer``: wall time per named phase, ``mark`` (the pipelines);
  ``PeakTimer`` adds each phase's peak device memory.
- ``op_profile_rows`` / ``op_profile_summary``: time by category (depth 2) and
  per op (depth 3) of a profiler run, device time where the run has any, else
  CPU time. ``PROFILE_CATEGORIES`` gives a kernel's category by its name.
- ``records``, ``union``, ``busy_ns``, ``gaps``, ``idle_by_span``: a
  profiler run's records as intervals on ``time.time_ns``, and the busy and
  idle time they leave, each idle gap named by the program span it began in.
- ``device_ms``, ``profile_request``, ``profile_text``, ``host_and_kernels_ms``,
  ``kernel_calls``: the readings ``chip_smoke.py`` and
  ``scripts/profile_pipeline.py`` print and check.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import os
import re
import time
import warnings
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
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
    ("K1 hd 64 (SDXL, S=4096 and 1024 self)", ("anchor_wg_kernel<64, 1,",)),
    ("K1 hd 32 (the tiny VAE)", ("anchor_wg_kernel<32, 1,",)),
    ("K2 hd 40 (S=9216 cross)", ("flash_cross_kernel<40>",)),
    ("K2 hd 80 (S=2304 cross)", ("flash_cross_kernel<80>",)),
    ("K2 hd 160 (S=1024 cross)", ("flash_cross_kernel<160>",)),
    ("K2 hd 64 (SDXL cross)", ("flash_cross_kernel<64>",)),
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
                                             "anchor_wg_kernel<160, 12,",
                                             "anchor_wg_kernel<64, 12,")),
    ("K14 mega-block", ("mega_kernel",)),
    ("K15 GEGLU", ("geglu_kernel",)),
    ("K10 anchored attention", ("anchor_wg_kernel<40, 10,", "anchor_wg_kernel<80, 10,",
                                "anchor_wg_kernel<160, 10,", "anchor_wg_kernel<64, 10,")),
    ("K11 anchored attention", ("anchor_wg_kernel<40, 11,", "anchor_wg_kernel<80, 11,",
                                "anchor_wg_kernel<160, 11,", "anchor_wg_kernel<64, 11,")),
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
    RECORDER.close()  # the program's spans of this session start a new list
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


# ------------------------------------------------------ the program's spans
# The program opens a span at its layers' boundaries (a clip and its phases,
# a denoise step, a train step and its phases) and charges counters to the
# innermost open one. The recorder is on exactly while a torch.profiler
# session is open (the profiler's own flag, ``_is_profiler_enabled``, set
# whatever activities it records); off, a span site is one check of that flag
# and the shared no-op context ``_OFF``, and reads no clock.
#
# A span keeps its host start and end on ``time.time_ns``, the clock of the
# profiler's records, and a CUDA event at each end on the current stream.
# The first request span of a session anchors the events to that clock: it
# synchronises the card once and times one event against the host clock. No
# span synchronises the card after that; the events are read when the spans
# are (``recorded()``), after the caller's own synchronisation.
#
# While a request span is open on the card, every synchronisation the host
# waits on (a blocking copy either way, ``.item()`` or ``float()`` of a card
# tensor, ``nonzero``) counts as HOST_SYNCS on the innermost open span:
# PyTorch's sync debug mode "warn", set for that time only, reports each as a
# warning, which the recorder counts and does not show.
HOST_SYNCS = "host_syncs"
SYNC_WARNING = "called a synchronizing CUDA operation"
_OFF = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """A closed span: its ``index`` in the session's list (spans in the order
    they opened), its ``parent``'s index (None for a request span), its
    ``request`` (the session's request spans counted from 0; every span
    inside one shares it), host and device (start, end) in ns on
    ``time.time_ns`` (device None where the session had no card), and the
    counters charged to it."""

    name: str
    index: int
    parent: Optional[int]
    request: int
    host_ns: Tuple[int, int]
    device_ns: Optional[Tuple[int, int]]
    counters: Dict[str, int]

    @property
    def host_ms(self) -> float:
        return (self.host_ns[1] - self.host_ns[0]) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        return None if self.device_ns is None else (self.device_ns[1] - self.device_ns[0]) / 1e6


class _Session:
    """The spans of one profiler session, and the anchor of their events:
    where the card is in use, one event recorded on the drained stream and
    waited for, the host clock read once it is seen done. A device time
    therefore reads late by at most that wait's wake-up, never early."""

    def __init__(self):
        self.spans: List[_Span] = []
        self.requests = 0
        self.closed = False
        self.anchor = None  # (host ns, CUDA event)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            event.synchronize()
            self.anchor = (time.time_ns(), event)

    def device_ns(self, event) -> int:
        host, anchor = self.anchor
        return host + round(anchor.elapsed_time(event) * 1e6)


class _Span:
    """An open span (``Recorder`` fills it in)."""

    __slots__ = ("recorder", "name", "index", "parent", "request", "host", "events", "device",
                 "counters")

    def __init__(self, recorder: "Recorder", name: str):
        self.recorder, self.name = recorder, name

    def __enter__(self):
        self.recorder.enter(self)
        return self

    def __exit__(self, *exc):
        self.recorder.exit(self)
        return False


class Recorder:
    """The program's spans and counters: the newest profiler session's
    spans, and the spans open now, innermost last (one per process,
    ``RECORDER``)."""

    def __init__(self):
        self.session: Optional[_Session] = None
        self.open: List[_Span] = []
        self._restore = None  # what an open request span changed: (sync mode, warnings)

    def close(self) -> None:
        """End the session: the next request span starts a new one."""
        if self.session is not None:
            self.session.closed = True

    def enter(self, sp: _Span) -> None:
        if self.open:
            sp.parent, sp.request = self.open[-1].index, self.open[-1].request
        else:
            if self.session is None or self.session.closed:
                self.session = _Session()
            sp.parent, sp.request = None, self.session.requests
            self.session.requests += 1
            if self.session.anchor is not None:
                self._count_syncs()
        sess = self.session
        sp.index, sp.counters, sp.device, sp.events = len(sess.spans), {}, None, None
        sess.spans.append(sp)
        self.open.append(sp)
        sp.host = [time.time_ns(), None]
        if sess.anchor is not None:
            sp.events = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            sp.events[0].record()

    def exit(self, sp: _Span) -> None:
        if sp.events is not None:
            sp.events[1].record()
        sp.host[1] = time.time_ns()
        self.open.pop()
        if not self.open and self._restore is not None:
            mode, caught = self._restore
            self._restore = None
            torch.cuda.set_sync_debug_mode(mode)
            caught.__exit__(None, None, None)

    def _count_syncs(self) -> None:
        """Until the request span closes: sync debug mode "warn", its warnings
        counted as HOST_SYNCS, every one, and not shown."""
        caught = warnings.catch_warnings()
        caught.__enter__()
        warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                count(HOST_SYNCS)
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        self._restore = (torch.cuda.get_sync_debug_mode(), caught)
        torch.cuda.set_sync_debug_mode("warn")

    def recorded(self) -> List[SpanRecord]:
        """The closed spans of the newest session. Read with the profiler off,
        the session ends (``close``). Device times need the spans' work done:
        a span's end event is waited for."""
        sess = self.session
        if sess is None:
            return []
        if not _autograd_profiler._is_profiler_enabled:
            sess.closed = True
        out = []
        for sp in sess.spans:
            if sp.host[1] is None:
                continue
            if sp.events is not None:
                sp.events[1].synchronize()
                sp.device = (sess.device_ns(sp.events[0]), sess.device_ns(sp.events[1]))
                sp.events = None
            out.append(SpanRecord(sp.name, sp.index, sp.parent, sp.request, tuple(sp.host),
                                  sp.device, dict(sp.counters)))
        return out


RECORDER = Recorder()


def span(name: str):
    """The program's span ``name`` as a context manager: recorded while a
    profiler session is open, else the shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(RECORDER, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span (while a
    profiler session is open)."""
    if _autograd_profiler._is_profiler_enabled and RECORDER.open:
        counters = RECORDER.open[-1].counters
        counters[name] = counters.get(name, 0) + n


def recorded() -> List[SpanRecord]:
    """The closed spans of the newest profiler session (``Recorder.recorded``)."""
    return RECORDER.recorded()


def self_ns(spans: List[SpanRecord], device: bool = False) -> Dict[int, int]:
    """Each span's self time by index: its duration less its children's, on
    the host clock or (``device``) the card's; spans without device times
    are left out of the latter."""
    length = {s.index: ends[1] - ends[0] for s in spans
              for ends in [s.device_ns if device else s.host_ns] if ends is not None}
    out = dict(length)
    for s in spans:
        if s.parent in out and s.index in length:
            out[s.parent] -= length[s.index]
    return out


def span_tree(spans: List[SpanRecord]) -> List[str]:
    """The spans as a tree, one line per path from a request span (repeats
    summed, their count after the name): host ms, device ms, self host ms,
    self device ms and host syncs."""
    by_index = {s.index: s for s in spans}
    paths: Dict[int, tuple] = {}

    def path(s):
        if s.index not in paths:
            up = by_index.get(s.parent)
            paths[s.index] = (path(up) if up is not None else ()) + (s.name,)
        return paths[s.index]

    own_host, own_dev = self_ns(spans), self_ns(spans, device=True)
    rows: Dict[tuple, List[float]] = {}
    for s in spans:
        row = rows.setdefault(path(s), [0, 0.0, None, 0.0, None, 0])
        row[0] += 1
        row[1] += s.host_ms
        row[3] += own_host[s.index] / 1e6
        if s.device_ns is not None:
            row[2] = (row[2] or 0.0) + s.device_ms
            row[4] = (row[4] or 0.0) + own_dev[s.index] / 1e6
        row[5] += s.counters.get(HOST_SYNCS, 0)

    def ms(v):
        return f"{v:12.1f}" if v is not None else f"{'-':>12s}"

    lines = [f"{'span':40s} {'host ms':>12s} {'device ms':>12s} {'self host':>12s} "
             f"{'self device':>12s} {'syncs':>7s}"]
    for p, (n, host, dev, self_host, self_dev, syncs) in rows.items():
        name = "  " * (len(p) - 1) + p[-1] + (f" x{n}" if n > 1 else "")
        lines.append(f"{name:40s} {ms(host)} {ms(dev)} {ms(self_host)} {ms(self_dev)} "
                     f"{syncs:7d}")
    return lines


# ------------------------------------------------ records on the spans' clock
def records(prof, device: bool = True) -> List[Tuple[int, int, str]]:
    """(start ns, end ns, name) of a profiler run's records on
    ``time.time_ns``, the clock of the program's spans: every kernel, copy
    and memset on the card (the run-in left out) or, with ``device`` False,
    every CPU op."""
    want = DeviceType.CUDA if device else DeviceType.CPU
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != want or e.is_async() or e.is_user_annotation() \
                or RUN_IN_KERNEL in e.name():
            continue
        s = e.start_ns()
        out.append((s, s + e.duration_ns(), e.name()))
    return out


def union(intervals) -> List[Tuple[int, int]]:
    """Merged [start, end) intervals of (start, end, ...) tuples."""
    merged: List[List[int]] = []
    for s, e, *_ in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_ns(intervals, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) covered by at least one interval: overlapping
    records count once, so this never passes hi - lo."""
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in union(intervals))


def gaps(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The idle [start, end) intervals of [lo, hi)."""
    out, at = [], lo
    for s, e in union(intervals):
        if e <= lo or s >= hi:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def idle_by_span(gap_list, spans: List[SpanRecord]) -> Dict[str, float]:
    """Idle seconds by the innermost program span (by its host interval)
    that each gap began in; "between spans" where none."""
    points: List[Tuple[int, Optional[str]]] = []  # (ns, innermost span's name from then)
    stack: List[SpanRecord] = []

    def pop_until(t):
        while stack and stack[-1].host_ns[1] <= t:
            end = stack.pop().host_ns[1]
            points.append((end, stack[-1].name if stack else None))

    for s in sorted(spans, key=lambda s: (s.host_ns[0], -s.host_ns[1])):
        pop_until(s.host_ns[0])
        stack.append(s)
        points.append((s.host_ns[0], s.name))
    pop_until(float("inf"))
    times = [t for t, _ in points]
    out: Dict[str, float] = defaultdict(float)
    for a, b in gap_list:
        at = bisect.bisect_right(times, a) - 1
        out[(points[at][1] if at >= 0 else None) or "between spans"] += (b - a) / 1e9
    return dict(out)


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
    the previous mark to ``name``."""

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
    (wall s, phases, ms by category, [(ms, calls, kernel key)] sorted by time,
    busy s: the union of the device records' intervals over the call)."""
    with trace(None, device) as prof:
        lo = time.time_ns()
        timer = run(steps)
        hi = time.time_ns()
    busy = busy_ns(records(prof), lo, hi) / 1e9
    return ((hi - lo) / 1e9, timer.phases) + device_ms(prof) + (busy,)


def profile_text(name: str, steps: int, res) -> str:
    """``profile_request``'s result as lines: wall, kernel time, busy share
    (the union of the device records over the wall), phases, then ms by
    category."""
    wall, phases, sums, _, busy = res
    total = sum(sums.values())
    lines = [f"profile: {name}, {steps} steps: wall {wall:.3f} s, kernel time "
             f"{total / 1e3:.3f} s (busy {busy / wall:.1%}), phases "
             + " ".join(f"{k} {v:.3f}s" for k, v in phases.items())]
    lines += [f"   {cat:44s} {ms:10.1f} ms  {ms / total:6.1%}"
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
