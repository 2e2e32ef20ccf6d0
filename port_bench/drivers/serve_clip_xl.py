"""A serving cell at SDXL's widths (``configs/mikudance-sdxl-video.json``):
whole clips through ``VideoPipeline.__call__`` of the port, as
``serve_clip.py`` serves them, with SDXL's added conditioning (the
configuration's time ids and a pooled vector drawn per request).

``serve_clip.py``'s generator, weights and work are SD1.5's, so this driver
makes its own from the same rules:

- weights: ``weights.py``'s rule (``derive``, ``_rule``) over the tensors of
  the SDXL-geometry twins (``reference/twins_xl.py``) and the VAE, one
  buffer of seeded draws on the card;
- requests: ``traffic.py``'s serving request with the CLIP tokens at the
  UNet's context width (2048) and a pooled vector N(0, 1) (1, 1280), drawn
  from (seed, index) on a stream of their own;
- work: the clip's model operations (the twins on the meta device under
  PyTorch's FLOP counter, as ``work.py`` counts them) and the attention the
  port's kernels compute, as (operations, bytes, calls), all of it and the
  hd-64 self- and cross-attention apart (``hd64_attention``, read by
  ``k01_hd64_roofline.serve`` and ``k02_hd64_roofline.serve``).

The check compares a sampled clip's frames with the fp32 reference's
(``reference/serve_xl.py`` on the twins, TF32 off), as ``serve_clip.py``.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import traffic, weights
from ..faults import planted
from ..reference import schedule as sch
from ..reference import serve_xl, twins, twins_xl
from . import DTYPES, Stopwatch, tf32_off, trace_record
from .serve_clip import PARTS, WARMUP_INDEX, SpanTimer, frame_rmse
from .serve_clip import Driver as ServeDriver

XL_SERVE = 4  # the requests' stream key (traffic.py uses 1 and 2, the check 3)
FLASH_MIN_TOKENS = 1024  # the kernels' threshold for self- and cross-attention
BF16 = 2


def program_configs(config: dict):
    """The port's (UNetConfig, MotionModuleConfig, VAEConfig) of the
    configuration file, SDXL's fields included."""
    from mikudance_tpu_torch.core.configs import MotionModuleConfig, UNetConfig, VAEConfig

    u, m, v = config["unet"], config["motion"], config["vae"]
    return (UNetConfig(block_out_channels=tuple(u["block_out_channels"]),
                       layers_per_block=u["layers_per_block"],
                       cross_attention_dim=u["cross_attention_dim"],
                       level_heads=tuple(u["level_heads"]),
                       attention_levels=tuple(u["attention_levels"]),
                       transformer_layers=tuple(u["transformer_layers"]),
                       use_linear_projection=u["use_linear_projection"],
                       addition_embed_type=u["addition_embed_type"],
                       addition_time_embed_dim=u["addition_time_embed_dim"],
                       projection_class_embeddings_input_dim=u[
                           "projection_class_embeddings_input_dim"],
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


def reference_nets(config: dict, parts) -> Dict[str, torch.nn.Module]:
    """The reference networks named in ``parts`` on the current default device."""
    v = config["vae"]
    make = {"vae": lambda: twins.TAutoencoderKL(tuple(v["block_out_channels"]),
                                                v["norm_num_groups"], v["layers_per_block"]),
            "guide": lambda: twins_xl.unet_twin(config, "guide"),
            "den": lambda: twins_xl.unet_twin(config, "den")}
    return {p: make[p]().eval() for p in parts}


def make_weights(config: dict, parts, seed: int, device, dtype):
    """{part: {name: tensor}}: ``weights.make``'s draws (one seeded buffer of
    uniform draws in [-1, 1), ``weights._rule``'s scale and offset a tensor)
    over these networks. Each tensor is scaled in place: ``weights.make``'s
    one scaling of the whole buffer indexes it in int64, 41 GiB at 5.4 G
    weights."""
    with torch.device("meta"):
        nets = reference_nets(config, parts)
    items = [(p, n, tuple(t.shape)) for p in parts for n, t in nets[p].state_dict().items()]
    sizes = [math.prod(s) for _, _, s in items]
    g = torch.Generator(device=device).manual_seed(weights.derive(seed, 0))
    buf = torch.rand(sum(sizes), generator=g, device=device, dtype=dtype)
    buf.mul_(2).sub_(1)
    out: Dict[str, Dict[str, torch.Tensor]] = {p: {} for p in parts}
    for (p, n, s), piece in zip(items, buf.split(sizes)):
        scale, offset = weights._rule(n, s)
        out[p][n] = piece.mul_(scale).add_(offset).view(s)
    return out


def serve_request(traffic_: dict, seed: int, index: int):
    """(the positional inputs of ``VideoPipeline.__call__``, the pooled
    vector (1, pooled_dim)) of request ``index``."""
    r = traffic.rng(seed, XL_SERVE, index)
    T, H, W = traffic_["frames"], traffic_["height"], traffic_["width"]
    h, w = H // 8, W // 8

    def pictures(n):
        return r.integers(0, 256, (n, H, W, 3), dtype=np.uint8)

    ref, skel, pose = pictures(1)[0], pictures(1)[0], pictures(T)
    face = pictures(T) if traffic_["face"] == "drawn" else None
    hand = pictures(T) if traffic_["hand"] == "drawn" else None
    motion = (r.normal(0, 0.1, (T, h, w, 2)).astype(np.float32)
              if traffic_["scene_motion"] == "drawn" else np.zeros((T, h, w, 2), np.float32))
    ctx = r.standard_normal((1, traffic_["clip_tokens"], traffic_["context_dim"]),
                            dtype=np.float32)
    noise = r.standard_normal((T, h, w, 4), dtype=np.float32)
    pooled = r.standard_normal((1, traffic_["pooled_dim"]), dtype=np.float32)
    return (ref, skel, pose, face, hand, motion, ctx, noise), pooled


def time_ids(config: dict) -> np.ndarray:
    return np.asarray(config["conditioning"]["time_ids"], np.float32)


def build_program(config: dict, traffic_: dict, nets: dict, device):
    """The port's ``VideoPipeline`` on the given weights, loaded through
    ``core/loaders.py`` in the configuration's type."""
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


def _geometry(config: dict, traffic_: dict):
    T = traffic_["frames"]
    c = config["context"]
    wins = sch.windows(T, c["frames"], c["overlap"], c.get("stride", 1))
    return T, len(wins), len(wins[0]), traffic_["height"] // 8, traffic_["width"] // 8


def _pictures(traffic_: dict) -> int:
    """Pictures a clip encodes: reference, skeleton, the poses, and each of
    face and hand (one black frame where absent)."""
    T = traffic_["frames"]
    return 2 + T + (T if traffic_["face"] == "drawn" else 1) + \
        (T if traffic_["hand"] == "drawn" else 1)


def model_flops(config: dict, traffic_: dict) -> int:
    """Operations of one clip: the encodes, the guidance UNet once over every
    (window, position), the denoiser over the CFG batch of every window at
    every step, the decode of every frame (``work.py``'s count)."""
    T, nw, wf, h, w = _geometry(config, traffic_)
    H, Wd = traffic_["height"], traffic_["width"]
    tokens, ctx_dim = traffic_["clip_tokens"], config["unet"]["cross_attention_dim"]
    n_ids, pooled = len(time_ids(config)), traffic_["pooled_dim"]
    cin = config["guidance"]["cond_channels"]

    def count(fn) -> int:
        with FlopCounterMode(display=False) as fc:
            fn()
        return int(fc.get_total_flops())

    with torch.device("meta"), torch.no_grad():
        nets = reference_nets(config, PARTS)
        vae, guide, den = nets["vae"], nets["guide"], nets["den"]
        enc = count(lambda: vae.quant_conv(vae.encoder(torch.empty(1, 3, H, Wd))))
        dec = count(lambda: vae.decoder(vae.post_quant_conv(torch.empty(1, 4, h, w))))
        P = nw * wf
        g = count(lambda: guide(torch.empty(P, cin, h, w), torch.zeros(P),
                                torch.empty(P, tokens, ctx_dim),
                                motion_map=torch.empty(P, 2, h, w), write=True,
                                added=(torch.empty(P, n_ids), torch.empty(P, pooled))))
        d = count(lambda: den(torch.empty(wf, 4, h, w), torch.zeros(1),
                              torch.empty(1, tokens, ctx_dim), T=wf,
                              added=(torch.empty(1, n_ids), torch.empty(1, pooled))))
    return _pictures(traffic_) * enc + g + traffic_["steps"] * 2 * nw * d + T * dec


Calls = List[Tuple[int, int, int]]


def attention_calls(config: dict, traffic_: dict) -> Tuple[Calls, Dict[str, Calls]]:
    """(operations, bytes, calls) of a clip's kernel-computed attention
    (``work.py``'s rule: self-attention from 1024 tokens, cross-attention of
    1024 queries and more against the CLIP tokens, every temporal attention,
    the VAE mid blocks from 1024 tokens; 4 B Sq Skv C operations; q, k, v and
    o once in bf16), and the hd-64 ones apart: {"self": ..., "cross": ...}."""
    T, nw, wf, h, w = _geometry(config, traffic_)
    u, m = config["unet"], config["motion"]
    ch, layers, n = u["block_out_channels"], u["layers_per_block"], len(u["block_out_channels"])
    tokens, steps = traffic_["clip_tokens"], traffic_["steps"]
    out: Calls = []
    hd64: Dict[str, Calls] = {"self": [], "cross": []}

    def attn(B, sq, skv, C, calls, kind=None, hd=None):
        call = (4 * B * sq * skv * C, BF16 * B * (2 * sq * C + 2 * skv * C), calls)
        out.append(call)
        if kind is not None and hd == 64:
            hd64[kind].append(call)

    for lv in range(n):
        S, C = (h >> lv) * (w >> lv), ch[lv]
        # transformer blocks a UNet forward holds at this level: down, up, mid
        blocks = 0
        if lv in u["attention_levels"]:
            blocks += (2 * layers + 1) * u["transformer_layers"][lv]
        if lv == n - 1:
            blocks += u["mid_transformer_layers"]
        hd = C // u["level_heads"][lv]
        for B, calls in ((nw * wf, 1), (2 * nw * wf, steps)):  # guidance once; denoiser
            if blocks and S >= FLASH_MIN_TOKENS:
                attn(B, S, S, C, blocks * calls, "self", hd)
                attn(B, S, tokens, C, blocks * calls, "cross", hd)
        if (1 << lv) in m["resolutions"]:  # two temporal attentions a motion module
            modules = 2 * layers + 1 + (1 if lv == n - 1 and m["mid_block"] else 0)
            seqs = 2 * nw * S
            out.append((4 * seqs * wf * wf * C, BF16 * 4 * seqs * wf * C, 2 * modules * steps))
    vae_c = config["vae"]["block_out_channels"][-1]
    if h * w >= FLASH_MIN_TOKENS:
        attn(_pictures(traffic_) + T, h * w, h * w, vae_c, 1)
    return out, hd64


class Driver(ServeDriver):
    def setup(self):
        clock = Stopwatch(self.device)
        program_configs(self.cfg)  # a program without SDXL's fields fails here, at once
        nets = make_weights(self.cfg, PARTS, self.seed, self.device, DTYPES[self.cfg["dtype"]])
        clock.lap("weights")
        self.pipe = build_program(self.cfg, self.traffic, nets, self.device)
        del nets
        clock.lap("program")
        inputs, pooled = serve_request(self.traffic, self.seed, WARMUP_INDEX)
        self.pipe(*inputs, num_inference_steps=self.wl["warmup_steps"], to_host=True,
                  time_ids=time_ids(self.cfg), pooled=pooled)
        clock.lap("warm-up")
        self.setup_phases = clock.laps

    def request(self, i: int, traced: bool = False) -> dict:
        inputs, pooled = serve_request(self.traffic, self.seed, i)
        timer = SpanTimer(self.device) if traced else None
        t0, n0 = time.perf_counter(), time.time_ns()
        frames = self.pipe(*inputs, to_host=True, timer=timer, time_ids=time_ids(self.cfg),
                           pooled=pooled)
        t1, n1 = time.perf_counter(), time.time_ns()
        return {"index": i, "t0": t0, "t1": t1, "ns": (n0, n1), "frames": frames,
                "spans": timer.spans if timer else []}

    def record(self, results, tracer, lo: int, hi: int) -> dict:
        rec = trace_record(self.cell, results, tracer, lo, hi, "between clips (host)")
        calls, hd64 = attention_calls(self.cfg, self.traffic)
        rec.update(kind="serve", steps=self.traffic["steps"],
                   model_flops=model_flops(self.cfg, self.traffic), attention_calls=calls,
                   hd64_attention=hd64)
        return rec

    def check(self, results) -> list:
        got = self.sample(results)
        want = reference_frames(self.cfg, self.traffic, self.seed, got["index"], self.device)
        return [{"name": "frame_rmse", "value": frame_rmse(got["frames"], want),
                 "limit": self.wl["limits"]["frame_rmse"]}]


def reference_frames(config, traffic_, seed: int, index: int, device,
                     control: bool = False) -> np.ndarray:
    """The reference's frames of request ``index`` (TF32 off); ``control``:
    every product's operands rounded through fp8."""
    made = make_weights(config, PARTS, seed, device, DTYPES[config["dtype"]])
    with tf32_off(), torch.no_grad():
        with torch.device(device):
            nets = reference_nets(config, PARTS)
        for p, net in nets.items():
            net.load_state_dict({k: v.float() for k, v in made[p].items()}, strict=True)
            if control:
                twins.fp8_products(net)
        del made
        inputs, pooled = serve_request(traffic_, seed, index)
        out = serve_xl.sample(nets, inputs, (time_ids(config), pooled), traffic_, config,
                              device)
    del nets
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def saturated(frames: np.ndarray) -> float:
    """Share of the values at 0 or 255."""
    return float(np.mean((frames == 0) | (frames == 255)))


def readings(cell, seed: int, device, control: bool, faults=()) -> dict:
    """``serve_clip.readings`` for this cell, with the reference's share of
    saturated values (0 or 255) beside it."""
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
           "reference_s": t2 - t1, "saturated_share": saturated(want)}
    out.update({f"{f}_frame_rmse": frame_rmse(got[f], want) for f in faults})
    if control:
        ctl = reference_frames(cell.config, cell.traffic, seed, 0, device, control=True)
        out["control_frame_rmse"] = frame_rmse(ctl, want)
        out["control_s"] = time.perf_counter() - t2
    return out
