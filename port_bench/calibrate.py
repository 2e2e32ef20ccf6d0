"""Readings for a cell's correctness limits, on the card, in one process:
for each seed the program's comparison with the reference, and for the
control seeds the control's (the reference in the next precision below the
configuration's, put in the program's place) and those of the program with
each of ``--faults`` planted (``faults.py``). One JSON line a seed.

    python3 -m port_bench.calibrate --workload serve-768-16f --seeds 1,2,3 --control 1,2,3
    python3 -m port_bench.calibrate --workload train-s2-576-20f --seeds 1 --control 1 \
        --faults half_batch,answer_altered
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .manifest import load
from .run import ROOT, cache_env


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", default="", help="seeds that also read the control")
    p.add_argument("--faults", default="", help="faults (faults.py) read on the control seeds")
    args = p.parse_args(argv)
    cache_env(ROOT)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = load(args.workload)
    control = {int(s) for s in args.control.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")] + \
        sorted(control - {int(s) for s in args.seeds.split(",")})
    dev = torch.device("cuda", 0)
    for seed in seeds:
        planted = [f for f in args.faults.split(",") if f] if seed in control else []
        out = cell.driver().readings(cell, seed, dev, seed in control, planted)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
