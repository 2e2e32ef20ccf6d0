"""One run of one benchmark cell of the PyTorch port, on the card.

    python3 -m port_bench.run --workload serve-768-16f --seed 7 --seconds 45 --trace 0

From the root of a checkout. The cell's files are found by its name
(``manifest.py``). Set-up makes the weights on the card from the seed, builds
the program through its own loaders and warms up the cell's shapes; the
window then runs whole requests (clips, optimizer steps) back to back until
``--seconds`` have passed; the program is freed and a plain fp32 reference
checks a sample of what the window produced. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, read from a device trace of the window), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit, which also close standard error.

It exits non-zero, printing no result, where there is no CUDA card or fewer
than the cell asks for, where the program cannot be imported, and where the
JAX package, JAX or flax was loaded into the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mikudance_tpu")
ROOT = Path(__file__).resolve().parent.parent


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own library is built into ``build/kernels``); nothing loads JAX."""
    cache = root / "build" / "port_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Top-level names of loaded modules that no run may hold, compared whole
    (``mikudance_tpu_torch`` is not ``mikudance_tpu``)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def _top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Set-up, window, check of one cell on ``device``; the result object."""
    import torch

    from . import devtrace
    from .devtrace import DeviceTrace
    from .manifest import peaks

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    drv = cell.driver().Driver(cell, seed, device)
    t_driver = time.perf_counter()
    drv.setup()
    sync()
    print("setup: " + " ".join(f"{k} {v:.3f}s" for k, v in
                               [("process to driver", t_driver - t_start)]
                               + list(drv.setup_phases.items())), file=sys.stderr)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    results, failed = [], 0
    tracer = DeviceTrace(device) if trace else contextlib.nullcontext()
    with tracer:
        lo = time.time_ns()
        t_first = time.perf_counter()
        i = 0
        while True:
            try:
                results.append(drv.request(i, traced=trace))
            except Exception:  # a request that fails counts against the run
                failed += 1
                traceback.print_exc()
            i += 1
            if time.perf_counter() - t_first >= seconds:
                break
        sync()
        hi = time.time_ns()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    out = {"attempted": i, "failed": failed}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    breakdown = None
    if not trace:
        readings = drv.end_to_end(results) if results else {}
        readings.update(setup_s=setup_s, peak_gib=peak / 2**30)
        metrics = {m["name"]: {"value": readings[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in readings}
    else:
        rec = drv.record(results, tracer, lo, hi) if results else {}
        rec["peaks"] = peaks(kind)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(rec) if results else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        dev.update(busy_s=rec.get("busy_s", 0.0), window_s=(hi - lo) / 1e9)
        breakdown = {"device_ops": _top(rec.get("categories", {})),
                     "idle_gaps": _top(rec.get("idle_by_span", {}))}
        cats = rec.get("categoriser")
        print(f"trace: {len(tracer.kernels)} device records, run-in lost "
              f"{tracer.run_in_lost} of its records; uncategorised: "
              f"{devtrace.uncategorised(tracer.kernels, cats) if cats else []}", file=sys.stderr)
    print("requests: " + " ".join(f"{r['t1'] - r['t0']:.3f}s" for r in results), file=sys.stderr)
    drv.release()
    checks = drv.check(results) if results else []
    correct = bool(results) and failed == 0 and len(checks) > 0 and \
        all(c["value"] <= c["limit"] for c in checks)
    out.update(correct=correct, metrics=metrics, device=dev)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env(ROOT)

    from .manifest import load

    cell = load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                   T_START)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the run: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
