"""A training cell: stage-2 optimizer steps of the port, each the trainer's
batch preparation (``train/runner.py::make_encoder_fns``, wired as
``scripts/train_stage2.py`` wires it) and then ``make_train_step``'s step
(``diffusion_loss``, backward, ``Optimizer.update``).

Set-up makes the weights of both UNets, the VAE and the CLIP tower from the
seed, loads them through the port's loaders as the trainer does (the UNets
in fp32, whose values become the optimizer's fp32 masters, then the frozen
weights cast to the compute type; the encoders in it), draws
``distinct_batches`` host batches with their condition drops and noise
draws, and takes the first ``checked_steps`` steps through the window's own
call on batches that all differ: they are the warm-up, and what the check
holds to the reference. The window's steps go on cycling through the
batches.

The check follows the same steps with the plain reference
(``reference/train.py``: fp32 arithmetic on the masters rounded to the
configuration's type) and compares each checked step's loss and, leaf by
leaf, the first gradient as the optimizer received it (its first moment
after one step over 1 - b1) and the parameters' change after the checked
steps. The window's later steps are the same call on the same state and are
not compared.
"""

from __future__ import annotations

import time
import types
from typing import Optional

import numpy as np
import torch

from .. import traffic, weights, work
from ..faults import planted
from ..reference import train as ref_train
from . import DTYPES, Stopwatch, program_configs, tf32_off, trace_record

PARTS = ("vae", "guide", "den", "clip")
ENCODER_STREAM = 4
CHECK_RULE = 1e-3  # leaves whose reference gradient is under this share of the median leaf's


def build_program(config: dict, nets: dict, device):
    """(train step, state, encoder fns, schedule, train config) of the port
    on the given weights, as ``scripts/train_stage2.py`` builds them."""
    from mikudance_tpu_torch.core import loaders
    from mikudance_tpu_torch.core.configs import CLIPVisionConfig
    from mikudance_tpu_torch.diffusion.ddim import DDIMSchedule
    from mikudance_tpu_torch.train.runner import make_encoder_fns
    from mikudance_tpu_torch.train.steps import TrainConfig, init_train_state, make_train_step

    dt = DTYPES[config["dtype"]]
    tr = config["train"]
    ucfg, mcfg, vcfg = program_configs(config)
    remat = bool(tr["gradient_checkpointing"])
    guide = loaders.load_guidance(nets["guide"], use_man=True, device=device, unet_config=ucfg,
                                  remat=remat)
    den = loaders.load_denoising(nets["den"], device=device, unet_config=ucfg,
                                 motion_config=mcfg, remat=remat)
    enc, _dec = loaders.load_vae(nets["vae"], dtype=dt, device=device, config=vcfg)
    del _dec
    c = config["clip"]
    clip = loaders.load_clip(None, dtype=dt, device=device, config=CLIPVisionConfig(
        image_size=c["image_size"], patch_size=c["patch"], hidden_size=c["dim"],
        intermediate_size=c["inner"], num_layers=c["layers"], num_heads=c["heads"],
        projection_dim=c["projection"], layer_norm_eps=c["eps"]))
    clip.load_state_dict(nets["clip"], strict=True)
    sc = config["scheduler"]
    schedule = DDIMSchedule.create(
        num_train_timesteps=sc["num_train_timesteps"], beta_start=sc["beta_start"],
        beta_end=sc["beta_end"], beta_schedule=sc["beta_schedule"],
        prediction_type=sc["prediction_type"],
        rescale_betas_zero_snr=sc["rescale_betas_zero_snr"])
    tcfg = TrainConfig(learning_rate=tr["learning_rate"], adam_b1=tr["adam_b1"],
                       adam_b2=tr["adam_b2"], adam_eps=tr["adam_eps"],
                       weight_decay=tr["weight_decay"], max_grad_norm=tr["max_grad_norm"],
                       uncond_ratio=tr["uncond_ratio"], noise_offset=tr["noise_offset"],
                       snr_gamma=tr["snr_gamma"], prediction_type=sc["prediction_type"],
                       trainable_substrings=tuple(tr["trainable"]))
    state = init_train_state(tcfg, guide, den, frozen_dtype=dt)
    return make_train_step(tcfg, schedule, state), state, make_encoder_fns(enc, clip)


def prepare_batch(enc, gen: torch.Generator, host: dict, device, dtype) -> dict:
    """The trainer's batch preparation (``scripts/train_stage2.py``), with
    the host batch's own condition drop."""
    batch = host["batch"]
    B, T = batch["tgt_vdo"].shape[:2]

    def dev(x):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    def flat(x):
        a = dev(x)
        return a.reshape((-1,) + tuple(a.shape[2:]))

    def unflat(x):
        return x.reshape((B, T) + tuple(x.shape[1:]))

    lat = enc.vae_encode_sample(gen, flat(batch["tgt_vdo"]))
    pose_l, face_l, hand_l = (enc.vae_encode_mean(flat(batch[k]))
                              for k in ("tgt_pose", "tgt_face", "tgt_hand"))
    rs = enc.vae_encode_mean(torch.cat([dev(batch["ref_img"]), dev(batch["ref_skel_img"])]))
    ref_rep = rs[:B, None].expand((B, T) + tuple(rs.shape[1:]))
    skel_rep = rs[B:, None].expand((B, T) + tuple(rs.shape[1:]))
    cond20 = torch.cat([ref_rep, skel_rep, unflat(pose_l), unflat(face_l), unflat(hand_l)],
                       dim=-1)
    ctx = enc.clip_encode(dev(batch["clip_img"]))
    return {
        "latents": unflat(lat).float(),
        "cond20": cond20.float(),
        "motion": torch.as_tensor(batch["scene_motion"]).to(device=device, dtype=torch.float32),
        "clip_ctx": ctx.float(),
        "uncond": torch.full((B,), host["uncond"], device=device),
    }


def leaf_gaps(got: dict, want: dict, grad: Optional[dict] = None) -> dict:
    """|norm(got) - norm(want)| of each leaf over the larger of its reference
    norm and the median leaf's; with ``grad`` (the reference's first
    gradient), only the leaves whose gradient is at least CHECK_RULE of the
    median leaf's (the others move under Adam by round-off alone)."""
    med = float(np.median(list(want.values())))
    keep = set(want)
    if grad is not None:
        gmed = float(np.median(list(grad.values())))
        keep = {k for k in want if grad[k] >= CHECK_RULE * gmed}
    return {k: abs(got[k] - w) / max(w, med) for k, w in want.items() if k in keep}


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.traffic, self.wl = cell.config, cell.traffic, cell.workload
        self.dt = DTYPES[self.cfg["dtype"]]
        self.step = self.state = self.enc = None

    def setup(self):
        clock = Stopwatch(self.device)
        nets = weights.make(self.cfg, PARTS, self.seed, self.device, self.dt)
        clock.lap("weights")
        self.step, self.state, self.enc = build_program(self.cfg, nets, self.device)
        del nets
        clock.lap("program")
        n = self.traffic["distinct_batches"]
        self.host = [traffic.train_batch(self.traffic, self.seed, j) for j in range(n)]
        self.draws = [{k: torch.as_tensor(v, device=self.device) for k, v in h["draws"].items()}
                      for h in self.host]
        clock.lap("batches")
        self.gen = torch.Generator(device=self.device).manual_seed(
            weights.derive(self.seed, ENCODER_STREAM))
        self.gen_state0 = self.gen.get_state()
        self.losses, self.first_grad, self.change, self.first_batch = [], None, None, None
        opt = self.state.optimizer
        master0 = {k: v.clone() for k, v in opt.master.items()}
        for j in range(self.wl["checked_steps"]):
            r = self.request(j)
            self.losses.append(r["loss"])
            if j == 0:  # the gradient as the optimizer got it: mu / (1 - b1)
                self.first_grad = {k: float(v.norm()) / (1.0 - opt.cfg.adam_b1)
                                   for k, v in opt.mu.items()}
        self.change = {k: float((opt.master[k] - master0[k]).norm()) for k in master0}
        del master0
        clock.lap("checked steps")
        self.setup_phases = clock.laps

    def request(self, i: int, traced: bool = False) -> dict:
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda d=None: None)
        host = self.host[i % len(self.host)]
        t0, n0 = time.perf_counter(), time.time_ns()
        batch = prepare_batch(self.enc, self.gen, host, self.device, self.dt)
        if traced:
            sync(self.device)
        n_mid = time.time_ns()
        metrics = self.step(batch, draws=self.draws[i % len(self.host)])
        loss = float(metrics["loss"])
        sync(self.device)
        t1, n1 = time.perf_counter(), time.time_ns()
        spans = [("batch preparation", n0, n_mid), ("train step", n_mid, n1)] if traced else []
        return {"index": i, "t0": t0, "t1": t1, "ns": (n0, n1), "loss": loss, "spans": spans,
                "frames": self.traffic["batch"] * self.traffic["frames"]}

    def end_to_end(self, results) -> dict:
        n = sum(r["frames"] for r in results)
        return {"train_frames_per_s": n / (results[-1]["t1"] - results[0]["t0"])}

    def record(self, results, tracer, lo: int, hi: int) -> dict:
        """What the per-layer readers read, from the traced window."""
        rec = trace_record(self.cell, results, tracer, lo, hi, "between steps (host)")
        rec.update(kind="train", model_flops=work.train_model_flops(
            self.cfg, self.traffic, tuple(self.cfg["train"]["trainable"])))
        return rec

    def release(self):
        self.step = self.state = self.enc = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, results) -> list:
        """The checked steps against the reference."""
        lim = self.wl["limits"]
        want = reference_steps(self.cfg, self.traffic, self.seed, self.wl["checked_steps"],
                               self.gen_state0, self.device)
        return [{"name": k, "value": v, "limit": lim[k]}
                for k, v in compare(self, want).items()]


def loss_gaps(got: list, want: list) -> list:
    """|loss - reference loss| / |reference loss| of each checked step."""
    return [abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want)]


def compare(got, want: dict) -> dict:
    """The numbers the check holds: the worst checked step's loss gap, and
    the worst leaf's gap of the first gradient's norm and of the norm of its
    change over the checked steps."""
    grad = leaf_gaps(got.first_grad, want["first_grad"])
    change = leaf_gaps(got.change, want["change"], want["first_grad"])
    return {"loss_gap": max(loss_gaps(got.losses, want["losses"])),
            "grad_norm_gap": max(grad.values()), "change_norm_gap": max(change.values())}


def diagnostics(got, want: dict) -> dict:
    """What the limits' readings are read beside: every step's loss gap, the
    worst leaves, the median leaf's gaps, the leaves the rule keeps."""
    grad = leaf_gaps(got.first_grad, want["first_grad"])
    change = leaf_gaps(got.change, want["change"], want["first_grad"])
    gmed = float(np.median(list(want["first_grad"].values())))
    worst = sorted(change, key=change.get)[-3:]
    return {
        "losses": got.losses, "reference_losses": want["losses"],
        "loss_rel_steps": loss_gaps(got.losses, want["losses"]),
        "grad_gap_median_leaf": float(np.median(list(grad.values()))),
        "change_gap_median_leaf": float(np.median(list(change.values()))),
        "leaves": len(want["first_grad"]), "leaves_kept": len(change),
        "worst_change_leaves": [[k, change[k], want["first_grad"][k] / gmed] for k in worst],
        "worst_grad_leaf": max(grad, key=grad.get),
    }


def reference_steps(config, traffic_, seed: int, steps: int, gen_state, device,
                    control: bool = False) -> dict:
    """The reference's ``steps`` optimizer steps from the same weights,
    batches, draws and encoder noise (fp32, TF32 off)."""
    with tf32_off():
        out = ref_train.run(config, traffic_, seed, steps, gen_state, device, control)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def readings(cell, seed: int, device, control: bool, faults=()) -> dict:
    """One seed's readings for setting the limits: the program's checked
    steps against the reference; with ``control`` the reference in fp8 in
    the program's place; for each of ``faults`` (``faults.py``) the program
    with that fault planted."""
    drv = Driver(cell, seed, device)
    t0 = time.perf_counter()
    drv.setup()
    drv.release()
    t1 = time.perf_counter()
    want = reference_steps(cell.config, cell.traffic, seed, cell.workload["checked_steps"],
                           drv.gen_state0, device)
    t2 = time.perf_counter()
    out = {**compare(drv, want), **diagnostics(drv, want), "program_setup_s": t1 - t0,
           "reference_s": t2 - t1}
    if control:
        ctl = reference_steps(cell.config, cell.traffic, seed, cell.workload["checked_steps"],
                              drv.gen_state0, device, control=True)
        got = types.SimpleNamespace(losses=ctl["losses"], first_grad=ctl["first_grad"],
                                    change=ctl["change"])
        out.update({f"control_{k}": v for k, v in compare(got, want).items()})
        out["control_diagnostics"] = diagnostics(got, want)
        out["control_s"] = time.perf_counter() - t2
    for fault in faults:
        with planted("train", fault):
            bad = Driver(cell, seed, device)
            bad.setup()
            bad.release()
        out.update({f"{fault}_{k}": v for k, v in compare(bad, want).items()})
        out[f"{fault}_diagnostics"] = diagnostics(bad, want)
    return out
