"""The device trace of a traced run, and the arithmetic on it.

``DeviceTrace`` runs torch.profiler (device activity only) over the
measured window. On the card it opens with a run-in of ``RUN_IN`` empty
spin kernels: a process can lose the first device records of a profiler
session, and the loss then falls on the run-in, which every reading leaves
out. From the raw records it keeps each kernel, copy and memset on the card
as (start ns, end ns, name), on the profiler's clock, which is the host's
``time.time_ns``.

- ``union``: the merged busy intervals, so that overlapping kernels count
  once (a sum of kernel times can pass the wall);
- ``gaps``: the idle intervals inside a window, each named by the host span
  it began in;
- ``categorise``: device seconds by category, the categories read from
  ``categories/*.json`` (a name, a ``group`` and kernel-name patterns, matched
  in ``order``; first match wins; names are compared without spaces or
  casts, as the port's own profiler table does).
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

RUN_IN = 1024
RUN_IN_KERNEL = "spin_kernel"
OTHER = "other"

_CASTS = re.compile(r"\((?:unsigned |signed )?(?:int|bool|long|char|short|long long)\)")


def plain(text: str) -> str:
    return re.sub(r"\s+", "", _CASTS.sub("", text.replace("(anonymous namespace)::", "")))


def load_categories(folder: Path) -> List[dict]:
    """Every ``*.json`` of ``folder``, in ``order`` then name: {"name",
    "group", "order", "patterns"}."""
    cats = []
    for f in sorted(folder.glob("*.json")):
        c = json.loads(f.read_text())
        c["name"] = f.stem
        cats.append(c)
    return sorted(cats, key=lambda c: (c["order"], c["name"]))


class Categoriser:
    def __init__(self, cats: List[dict]):
        self.cats = [(c["name"], tuple(plain(p) for p in c["patterns"])) for c in cats]
        self.group = {c["name"]: c.get("group", c["name"]) for c in cats}
        self._known: Dict[str, str] = {}

    def __call__(self, kernel: str) -> str:
        if kernel not in self._known:
            k = plain(kernel)
            self._known[kernel] = next((n for n, ps in self.cats if any(p in k for p in ps)),
                                       OTHER)
        return self._known[kernel]


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
    """Nanoseconds of [lo, hi) covered by at least one interval."""
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


def name_gaps(gap_list, spans) -> Dict[str, float]:
    """Idle seconds by the host span (name, start ns, end ns) each gap began
    in ("host, between spans" where none)."""
    spans = sorted(spans, key=lambda s: s[1])
    out: Dict[str, float] = defaultdict(float)
    for a, b in gap_list:
        name = next((n for n, s, e in spans if s <= a < e), "host, between spans")
        out[name] += (b - a) / 1e9
    return dict(out)


class DeviceTrace:
    """torch.profiler over a block on ``device``; after the block,
    ``kernels`` holds (start ns, end ns, name) of every device record but the
    run-in's, and ``run_in_lost`` how many run-in kernels were lost."""

    def __init__(self, device: torch.device):
        self.device = device
        self.kernels: List[Tuple[int, int, str]] = []
        self.run_in_lost = 0
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        # device activity alone: recording every host op would slow the host
        # side of the window (the spans come from the benchmark's own clock)
        self._prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        self._prof.__enter__()
        if cuda:
            for _ in range(RUN_IN):
                torch.cuda._sleep(0)
            torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        spins = 0
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_async() \
                    or e.is_user_annotation():
                continue
            name = e.name()
            if RUN_IN_KERNEL in name:
                spins += 1
                continue
            s = e.start_ns()
            self.kernels.append((s, s + e.duration_ns(), name))
        self.run_in_lost = RUN_IN - spins if self.device.type == "cuda" else 0
        self._prof = None
        return False


def categorise(kernels, cats: Categoriser, lo: Optional[int] = None,
               hi: Optional[int] = None) -> Dict[str, float]:
    """Device seconds by category of the kernels that start in [lo, hi)."""
    out: Dict[str, float] = defaultdict(float)
    for s, e, name in kernels:
        if (lo is None or s >= lo) and (hi is None or s < hi):
            out[cats(name)] += (e - s) / 1e9
    return dict(out)


def uncategorised(kernels, cats: Categoriser, n: int = 5) -> List[Tuple[str, float]]:
    """The ``n`` kernel names with the most device seconds that no category
    names."""
    out: Dict[str, float] = defaultdict(float)
    for s, e, name in kernels:
        if cats(name) == OTHER:
            out[name] += (e - s) / 1e9
    return sorted(out.items(), key=lambda kv: -kv[1])[:n]
