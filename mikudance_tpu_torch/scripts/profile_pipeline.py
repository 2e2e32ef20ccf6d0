"""Op-level profile of the headline pipeline on the card.

The counterpart of the JAX package's ``scripts/profile_pipeline.py``: one
``VideoPipeline`` at bench.py's geometry (16 uint8 frames at 768^2, SD1.5
widths, context 30/8, CFG 3.5, bf16; seeded random weights, as
``chip_smoke.py`` builds them), and in order:

1. a warm-up call, then the steady-state seconds of one call;
2. the phases of one call with a ``Timer`` (h2d_normalize, vae_encode,
   guidance_banks, denoise, decode_d2h), each with its peak device memory;
3. one call under ``utils.profiling.trace`` (a Chrome trace in ``--logdir``;
   open it in Perfetto, ui.perfetto.dev): the top categories of device time,
   then the top ``--top`` rows by op (an ATen op with its inputs' dtypes and
   shapes, or the kernel's name where no op launched it);
4. the busy share: the union of the device records' intervals over the
   traced call's wall;
5. the program's spans of the traced call (``utils.profiling.span``) as a
   tree, host and device ms, self time and host syncs of each, and the
   device's idle gaps, each named by the innermost span it began in;
6. with ``--per-step N``: the device time of one denoise step, (N-step -
   2-step) / (N - 2), by category and by op.

    python -m mikudance_tpu_torch.scripts.profile_pipeline [--steps 20] \\
        [--logdir build/mdtrace] [--top 20] [--per-step N]

Runs on the card; ``profile_pipeline`` (the body) also takes a pipeline on
the CPU, where it reads each op's CPU time instead.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import torch

from ..utils.profiling import (PeakTimer, Timer, busy_ns, category_totals, clock_of, device_ms,
                               gaps, idle_by_span, op_profile_rows, recorded, records,
                               run_in_lost, span_tree, trace)
from .psnr_sd_width import card_name

# bench.py's geometry
T, H, W = 16, 768, 768
DEFAULT_LOGDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "mdtrace")


def profile_pipeline(pipe, inputs, steps: int, logdir: Optional[str] = None,
                     per_step: int = 0, kernels=()) -> dict:
    """Profile ``pipe(*inputs)`` at ``steps`` DDIM steps, decoded to the host:
    a warm-up call, a timed call (``steady_s``; ``device``: the card's name
    and power limit, or "cpu"), a call with a ``Timer``
    (``phases``, ``peaks_gib`` on the card, ``phase_wall_s``), then a call
    under ``trace`` (a Chrome trace in ``logdir`` unless None): its wall
    (``wall_s``), the clock read (``clock``: "device" on the card, "cpu"
    on the CPU), ``total_ms``, ``busy`` (the union of the records' intervals,
    device records on the card and CPU ops on the CPU, over the wall),
    ``spans`` (the program's, ``recorded()``), ``idle_by_span`` {span: idle
    s} of the device records (the CPU ops on the CPU), ``categories``
    {category: [ms, calls]}, depth-3 ``rows`` [(ms, calls, category, name)],
    ``kernels_by_key`` [(ms, calls, kernel key)] and the ``launches`` of
    ``kernels`` (objects with ``name`` and ``launches``, set to 0 just before
    the traced call and read just after), and ``run_in_lost``, the records of
    ``trace``'s run-in that the profiler dropped (0 on the CPU). With ``per_step`` N > 2, also
    ``per_step``: the N-step call's readings less the 2-step call's, over
    N - 2."""
    dev = pipe.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def call(n, timer=None):
        return pipe(*inputs, num_inference_steps=n, to_host=True, timer=timer)

    def traced(n, log_dir):
        for k in kernels:
            k.launches = 0
        with trace(log_dir, dev) as prof:
            sync()
            lo = time.time_ns()
            call(n)
            sync()
            hi = time.time_ns()
        rows = op_profile_rows(prof, depth=3)
        total = sum(r[0] for r in rows)
        recs, spans = records(prof, device=cuda), recorded()
        return {"wall_s": (hi - lo) / 1e9, "clock": clock_of(prof), "total_ms": total,
                "run_in_lost": run_in_lost(prof) if cuda else 0,
                "busy": busy_ns(recs, lo, hi) / (hi - lo), "spans": spans,
                "idle_by_span": idle_by_span(gaps(recs, lo, hi), spans),
                "categories": category_totals(rows), "rows": rows,
                "kernels_by_key": device_ms(prof)[1] if cuda else [],
                "launches": {k.name: k.launches for k in kernels}, "trace": prof.trace_path}

    call(steps)  # warm-up
    sync()
    t0 = time.perf_counter()
    call(steps)
    sync()
    res = {"device": card_name(dev), "steps": steps, "steady_s": time.perf_counter() - t0}
    timer = PeakTimer(dev) if cuda else Timer(dev)
    t0 = time.perf_counter()
    call(steps, timer)
    res.update(phase_wall_s=time.perf_counter() - t0, phases=dict(timer.phases),
               peaks_gib=dict(getattr(timer, "peaks", {})))
    res.update(traced(steps, logdir))
    if per_step:
        if per_step <= 2:
            raise ValueError(f"per_step must pass 2, got {per_step}")
        runs = {steps: res}
        for n in (2, per_step):
            if n not in runs:
                runs[n] = traced(n, None)
        few, many = runs[2], runs[per_step]

        def less(a, b):
            return {k: (a.get(k, 0.0) - b.get(k, 0.0)) / (per_step - 2) for k in set(a) | set(b)}

        cats = less({c: v[0] for c, v in many["categories"].items()},
                    {c: v[0] for c, v in few["categories"].items()})
        rows = less({(c, name): ms for ms, _, c, name in many["rows"]},
                    {(c, name): ms for ms, _, c, name in few["rows"]})
        res["per_step"] = {"steps": per_step, "total_ms": sum(cats.values()),
                           "categories": cats,
                           "rows": sorted(((ms, c, name) for (c, name), ms in rows.items()),
                                          reverse=True)}
    return res


def profile_report(res: dict, top: int = 20) -> str:
    """``profile_pipeline``'s result as the JAX script prints it: steady
    state, phases, the traced call's categories and top rows, busy share;
    then the per-step difference."""
    clock = res["clock"]
    peaks = res["peaks_gib"]
    lines = [f"steady-state: {res['steady_s']:.2f}s for {res['steps']} steps ({res['device']})",
             f"phases ({res['phase_wall_s']:.3f}s wall): " + " | ".join(
                 f"{k} {v:.3f}s" + (f" ({peaks[k]:.2f} GiB)" if k in peaks else "")
                 for k, v in res["phases"].items())
             + f" | total {sum(res['phases'].values()):.3f}s"]
    lines.append(f"traced call: wall {res['wall_s']:.3f}s, {clock} time "
                 f"{res['total_ms'] / 1e3:.3f}s, busy {res['busy']:.1%}, run-in records "
                 f"dropped {res['run_in_lost']}" + (f"; trace {res['trace']}" if res["trace"] else ""))
    lines.append(f"top categories ({clock} ms, calls, share):")
    for cat, (ms, n) in sorted(res["categories"].items(), key=lambda kv: -kv[1][0]):
        lines.append(f"{ms:14.1f} {n:7d}  {ms / res['total_ms']:6.1%}  {cat}")
    lines.append(f"top {top} ops ({clock} ms, calls, category, op or kernel):")
    for ms, n, cat, name in res["rows"][:top]:
        lines.append(f"{ms:14.1f} {n:7d}  {cat[:24]:24s}  {name[:140]}")
    lines.append("the program's spans, traced call (ms; self: less the children):")
    lines += span_tree(res["spans"])
    lines.append(f"idle ({clock} records), by the span it began in:")
    for name, sec in sorted(res["idle_by_span"].items(), key=lambda kv: -kv[1]):
        lines.append(f"{sec * 1e3:14.1f} ms  {name}")
    if "per_step" in res:
        ps = res["per_step"]
        tot = ps["total_ms"]
        lines.append(f"per denoise step (({ps['steps']}-step - 2-step) / {ps['steps'] - 2}): "
                     f"{tot:.1f} ms ({clock})")
        for cat, ms in sorted(ps["categories"].items(), key=lambda kv: -kv[1]):
            lines.append(f"{ms:14.2f}  {ms / tot:6.1%}  {cat}")
        lines.append(f"per denoise step, top {top} ops:")
        for ms, cat, name in ps["rows"][:top]:
            lines.append(f"{ms:14.3f}  {ms / tot:6.1%}  {cat[:24]:24s}  {name[:140]}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--logdir", default=DEFAULT_LOGDIR)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--per-step", type=int, default=0, metavar="N",
                    help="add one denoise step's device time, (N-step - 2-step) / (N - 2)")
    args = ap.parse_args(argv)

    from ..core.configs import ContextConfig, PipelineConfig
    from ..core.params import resolve_device
    from ..pipelines.video import VideoPipeline
    from ._synthetic import build_bundle, make_inputs

    dev = resolve_device(None)
    cfg = PipelineConfig(width=W, height=H, num_inference_steps=args.steps, guidance_scale=3.5,
                         context=ContextConfig(frames=30, overlap=8))
    pipe = VideoPipeline(build_bundle(0, dev), cfg, device=dev)
    res = profile_pipeline(pipe, make_inputs(0, T, H, W), args.steps, logdir=args.logdir,
                           per_step=args.per_step)
    print(profile_report(res, args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
