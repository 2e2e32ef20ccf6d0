"""A serving cell: whole video clips through ``VideoPipeline.__call__`` of the
port, decoded to the host as uint8, one client in a closed loop.

Set-up makes the three networks' weights from the seed (``weights.py``),
loads them through the port's loaders in the configuration's type and warms
up with one clip of ``warmup_steps`` steps at the cell's shapes (every shape
a clip uses; the step count changes no shape). Request i's media and noise
come from (seed, i). The check runs the plain reference (``reference/``) in
fp32 on a clip drawn from the seed among those the window finished and
compares its frames with the ones the program served.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import traffic, weights, work
from ..faults import planted
from ..reference import serve as ref_serve
from ..reference import twins
from . import DTYPES, Stopwatch, program_configs, tf32_off, trace_record

PARTS = ("vae", "guide", "den")
WARMUP_INDEX = 1 << 40  # the warm-up clip's inputs, never a window request's
CHECK_STREAM = 3


class SpanTimer:
    """The pipeline's timer protocol (``start``, ``mark``): each phase as
    (name, start ns, end ns) on ``time.time_ns``, which is the profiler's
    clock; the device is synchronised at every mark."""

    def __init__(self, device: torch.device):
        self.device, self.spans = device, []
        self._t = time.time_ns()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self._t = time.time_ns()

    def mark(self, name: str):
        self._sync()
        now = time.time_ns()
        self.spans.append((name, self._t, now))
        self._t = now


def build_program(config: dict, traffic_: dict, nets: dict, device):
    """The port's ``VideoPipeline`` on the given weights ({part: {name:
    tensor}}), loaded through ``core/loaders.py`` in the configuration's
    type."""
    from mikudance_tpu_torch.core import loaders
    from mikudance_tpu_torch.core.configs import ContextConfig, PipelineConfig, SchedulerConfig
    from mikudance_tpu_torch.pipelines.video import ModelBundle, VideoPipeline

    dt = DTYPES[config["dtype"]]
    ucfg, mcfg, vcfg = program_configs(config)
    guide = loaders.load_guidance(nets["guide"], use_man=True, dtype=dt, device=device,
                                  unet_config=ucfg)
    den = loaders.load_denoising(nets["den"], dtype=dt, device=device, unet_config=ucfg,
                                 motion_config=mcfg)
    enc, dec = loaders.load_vae(nets["vae"], dtype=dt, device=device, config=vcfg)
    c = config["context"]
    pcfg = PipelineConfig(width=traffic_["width"], height=traffic_["height"],
                          num_inference_steps=traffic_["steps"],
                          guidance_scale=traffic_["guidance_scale"],
                          context=ContextConfig(frames=c["frames"], overlap=c["overlap"],
                                                stride=c.get("stride", 1)),
                          scheduler=SchedulerConfig(**config["scheduler"]),
                          guidance_clip_mode=config["guidance_clip_mode"])
    return VideoPipeline(ModelBundle(guide, den, enc, dec), pcfg, device=device)


def reference_nets(config: dict, seed: int, device, control: bool = False) -> dict:
    """The reference networks in fp32 on the same weights (made again from
    the seed in the served type); ``control``: rounded through fp8."""
    made = weights.make(config, PARTS, seed, device, DTYPES[config["dtype"]])
    with torch.device(device):
        nets = weights.reference_nets(config, PARTS)
    for p, net in nets.items():
        net.load_state_dict({k: v.float() for k, v in made[p].items()}, strict=True)
        if control:
            twins.fp8_products(net)
    del made
    return nets


def frame_rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root mean square difference of two uint8 videos, in levels."""
    return float(np.sqrt(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)))


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.traffic, self.wl = cell.config, cell.traffic, cell.workload
        self.pipe = None

    def setup(self):
        clock = Stopwatch(self.device)
        nets = weights.make(self.cfg, PARTS, self.seed, self.device, DTYPES[self.cfg["dtype"]])
        clock.lap("weights")
        self.pipe = build_program(self.cfg, self.traffic, nets, self.device)
        del nets
        clock.lap("program")
        self.pipe(*traffic.serve_request(self.traffic, self.seed, WARMUP_INDEX),
                  num_inference_steps=self.wl["warmup_steps"], to_host=True)
        clock.lap("warm-up")
        self.setup_phases = clock.laps

    def request(self, i: int, traced: bool = False) -> dict:
        inputs = traffic.serve_request(self.traffic, self.seed, i)
        timer = SpanTimer(self.device) if traced else None
        t0, n0 = time.perf_counter(), time.time_ns()
        frames = self.pipe(*inputs, to_host=True, timer=timer)
        t1, n1 = time.perf_counter(), time.time_ns()
        return {"index": i, "t0": t0, "t1": t1, "ns": (n0, n1), "frames": frames,
                "spans": timer.spans if timer else []}

    def end_to_end(self, results) -> dict:
        n = sum(r["frames"].shape[0] for r in results)
        return {"frames_per_s": n / (results[-1]["t1"] - results[0]["t0"])}

    def record(self, results, tracer, lo: int, hi: int) -> dict:
        """What the per-layer readers read, from the traced window."""
        rec = trace_record(self.cell, results, tracer, lo, hi, "between clips (host)")
        rec.update(kind="serve", steps=self.traffic["steps"],
                   model_flops=work.serve_model_flops(self.cfg, self.traffic),
                   attention_calls=work.serve_attention_calls(self.cfg, self.traffic))
        return rec

    def release(self):
        self.pipe = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self, results) -> dict:
        """The clip the check reads: drawn from the seed among those finished."""
        r = traffic.rng(self.seed, CHECK_STREAM, 0)
        return results[int(r.integers(len(results)))]

    def check(self, results) -> list:
        """The served frames of a sampled clip against the fp32 reference's."""
        got = self.sample(results)
        want = reference_frames(self.cfg, self.traffic, self.seed, got["index"], self.device)
        return [{"name": "frame_rmse", "value": frame_rmse(got["frames"], want),
                 "limit": self.wl["limits"]["frame_rmse"]}]


def reference_frames(config, traffic_, seed: int, index: int, device,
                     control: bool = False) -> np.ndarray:
    """The reference's frames of request ``index`` (TF32 off)."""
    with tf32_off(), torch.no_grad():
        nets = reference_nets(config, seed, device, control)
        out = ref_serve.sample(nets, traffic.serve_request(traffic_, seed, index), traffic_,
                               config, device)
    del nets
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def readings(cell, seed: int, device, control: bool, faults=()) -> dict:
    """One seed's readings for setting the limits: the program's clip 0
    against the reference; with ``control`` the reference in fp8 in the
    program's place; for each of ``faults`` (``faults.py``) the program with
    that fault planted."""
    drv = Driver(cell, seed, device)
    drv.setup()
    t0 = time.perf_counter()
    got = {"": drv.request(0)["frames"]}
    for fault in faults:
        with planted("serve", fault):
            got[fault] = drv.request(0)["frames"]
    drv.release()
    t1 = time.perf_counter()
    want = reference_frames(cell.config, cell.traffic, seed, 0, device)
    t2 = time.perf_counter()
    out = {"frame_rmse": frame_rmse(got[""], want), "program_s": t1 - t0,
           "reference_s": t2 - t1}
    out.update({f"{f}_frame_rmse": frame_rmse(got[f], want) for f in faults})
    if control:
        ctl = reference_frames(cell.config, cell.traffic, seed, 0, device, control=True)
        out["control_frame_rmse"] = frame_rmse(ctl, want)
        out["control_s"] = time.perf_counter() - t2
    return out
