"""What a run needs, found by the names in ``BENCHMARK.json``.

A cell's entry there names its configuration and traffic mix; the harness
reads

- ``configs/<config>.json``: the configuration as it is run (widths,
  schedule, precision, source, ``assumed``, ``reduced``);
- ``traffic/<traffic>.json``: the mix's parameters, read by ``traffic.py``;
- ``workloads/<cell>.json``: the cell's driver (``drivers/<driver>.py``),
  its set-up (warm-up) and the limits of its correctness check;
- ``metrics/<metric>.py``: one reader per per-layer metric, ``read(record)``
  returning the number or None;
- ``categories/*.json``: the device-time categories (``devtrace.py``).

A later change adds a cell, a configuration, a mix, a metric or a category
as new files and a new entry in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports
    here: Path  # the benchmark's folder

    def driver(self):
        return importlib.import_module(f"{__package__}.drivers.{self.workload['driver']}")

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        path = self.here / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its files read from
    ``here`` (the benchmark's folder)."""
    bench = _json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def mine(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if mine(m) and m["moves"] in reported]
    return Cell(name=name, chips=int(entry["chips"]),
                config=_json(here / "configs" / f"{entry['config']}.json"),
                traffic=_json(here / "traffic" / f"{entry['traffic']}.json"),
                workload=_json(here / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer, here=here)


def peaks(device_name: str, here: Path = HERE) -> Optional[Dict[str, float]]:
    """The published peaks of the card named ``device_name``, or None."""
    return _json(here / "peaks.json").get(device_name)
