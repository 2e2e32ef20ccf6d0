"""The systems under test: one module per kind of cell, named by a
workload's ``driver``. A driver's ``Driver(cell, seed, device)`` has
``setup()`` (which leaves ``setup_phases``), ``request(i, traced)``, ``end_to_end(results)``,
``record(results, trace, lo, hi)``, ``release()`` and ``check(results)``."""

from __future__ import annotations

import contextlib
import time

import torch

from .. import devtrace

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_configs(config: dict):
    """The port's (UNetConfig, MotionModuleConfig, VAEConfig) of a
    configuration file."""
    from mikudance_tpu_torch.core.configs import MotionModuleConfig, UNetConfig, VAEConfig

    u, m, v = config["unet"], config["motion"], config["vae"]
    return (UNetConfig(block_out_channels=tuple(u["block_out_channels"]),
                       layers_per_block=u["layers_per_block"],
                       cross_attention_dim=u["cross_attention_dim"],
                       attention_heads=u["attention_heads"],
                       norm_num_groups=u["norm_num_groups"], norm_eps=u["norm_eps"]),
            MotionModuleConfig(num_attention_heads=m["num_attention_heads"],
                               num_transformer_blocks=m["num_transformer_blocks"],
                               attention_layers_per_block=m["attention_layers_per_block"],
                               temporal_position_encoding_max_len=m[
                                   "temporal_position_encoding_max_len"],
                               resolutions=tuple(m["resolutions"]), mid_block=m["mid_block"]),
            VAEConfig(block_out_channels=tuple(v["block_out_channels"]),
                      layers_per_block=v["layers_per_block"],
                      norm_num_groups=v["norm_num_groups"], scaling_factor=v["scaling_factor"]))


def trace_record(cell, results, tracer, lo: int, hi: int, between: str) -> dict:
    """The device side of a traced window: busy seconds (the union of the
    device records), device seconds by category and by group, the idle
    seconds by the host span they began in (the requests' own spans, and
    ``between`` for the host's time between requests)."""
    cats = devtrace.Categoriser(devtrace.load_categories(cell.here / "categories"))
    by_cat = devtrace.categorise(tracer.kernels, cats, lo, hi)
    groups: dict = {}
    for c, sec in by_cat.items():
        g = cats.group.get(c, c)
        groups[g] = groups.get(g, 0.0) + sec
    spans = [sp for r in results for sp in r["spans"]]
    spans += [(between, a["ns"][1], b["ns"][0]) for a, b in zip(results, results[1:])]
    return {
        "requests": len(results),
        "phases": [{n: (e - st) / 1e9 for n, st, e in r["spans"]} for r in results],
        "walls": [r["t1"] - r["t0"] for r in results],
        "window_s": (hi - lo) / 1e9,
        "busy_s": devtrace.busy_ns(tracer.kernels, lo, hi) / 1e9,
        "categories": by_cat,
        "groups": groups,
        "categoriser": cats,
        "idle_by_span": devtrace.name_gaps(devtrace.gaps(tracer.kernels, lo, hi), spans),
    }


class Stopwatch:
    """Seconds of each named part of a set-up, the device synchronised at
    each lap (``laps``)."""

    def __init__(self, device: torch.device):
        self.device, self.laps = device, {}
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.laps[name] = now - self._t
        self._t = now


@contextlib.contextmanager
def tf32_off():
    """fp32 products in fp32: TF32 off for matmuls and cuDNN, as it was after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
