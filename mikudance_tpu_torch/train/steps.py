"""Training steps for the two MikuDance stages, on one device.

Port of ``mikudance_tpu/train/steps.py`` without its meshes:

- condition dropout by scaling: an uncond sample zeroes its CLIP tokens and
  its banks ("skip the reference UNet" == "banks are zero"), so the graph is
  the same for every batch and the guidance UNet simply receives no gradient
  from that sample;
- stage 1 trains both UNets (no motion modules); stage 2 freezes everything
  except the motion modules and the MAN blocks, expressed as substrings of the
  parameter names (``trainable_mask``);
- v-prediction targets on a zero-terminal-SNR schedule, min-SNR-gamma
  weighting, noise offset.

Where flax keeps fp32 parameters and casts them at use, a port module holds one
dtype (bf16 on the card: the kernels take bf16 weights). The optimizer
therefore keeps an fp32 master copy of every trainable tensor, updates it in
fp32 and writes the rounded value back into the module after each optimizer
step. Frozen tensors have ``requires_grad`` off: they get no gradient buffer,
no master copy and no optimizer state.

The optimizer reproduces ``optax.chain(clip_by_global_norm, adamw)`` under
``optax.MultiSteps`` for accumulation, with optax's formulas (the clip divides
by the norm itself, the learning rate is read at the count before the step).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..diffusion.ddim import DDIMSchedule, min_snr_loss_weight
from ..models.unet import DenoisingUNet, GuidanceUNet


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 1e-2
    max_grad_norm: float = 1.0
    uncond_ratio: float = 0.1
    noise_offset: float = 0.05
    snr_gamma: float = 5.0
    prediction_type: str = "v_prediction"
    # stage 2 trains only the parameters whose name contains one of these;
    # stage 1 (None) trains all. ("motion", "man_") names the same tensors in
    # the port's names (``motion_modules``, ``man_blocks``) as in the JAX tree.
    trainable_substrings: Optional[Tuple[str, ...]] = None
    # diffusers ``get_scheduler`` semantics; the shipped configs use 'constant'
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    max_train_steps: int = 0  # decay horizon for 'linear' / 'cosine'
    # gradients averaged over k micro-steps, one optimizer step per k
    gradient_accumulation_steps: int = 1


def named_parameters(guide: nn.Module, den: nn.Module) -> Dict[str, nn.Parameter]:
    """Both UNets' parameters under ``guide.<name>`` / ``den.<name>``."""
    out = {f"guide.{k}": p for k, p in guide.named_parameters()}
    out.update({f"den.{k}": p for k, p in den.named_parameters()})
    return out


def trainable_mask(names, substrings: Optional[Tuple[str, ...]]) -> Dict[str, bool]:
    """{name: whether it contains any of the substrings}; all True for None."""
    return {n: substrings is None or any(s in n for s in substrings) for n in names}


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """count -> learning rate. 'constant' ignores warmup entirely; the others
    warm up linearly from 0 over ``lr_warmup_steps`` then hold / decay to 0 at
    ``max_train_steps``."""
    base, warm = cfg.learning_rate, cfg.lr_warmup_steps
    total = max(cfg.max_train_steps, warm + 1)
    kind = cfg.lr_scheduler

    def linear(init, end, steps):
        return lambda c: init + (end - init) * min(max(c / steps, 0.0), 1.0)

    def join(first, second, boundary):
        return lambda c: first(c) if c < boundary else second(c - boundary)

    if kind == "constant":
        return lambda c: base
    if kind == "constant_with_warmup":
        return join(linear(0.0, base, max(warm, 1)), lambda c: base, warm)
    span = max(total - warm, 1)
    if kind == "linear":
        decay = linear(base, 0.0, span)
    elif kind == "cosine":
        def decay(c):
            return base * 0.5 * (1.0 + math.cos(math.pi * min(c, span) / span))
    else:
        raise ValueError(f"unsupported lr_scheduler {kind!r}")
    if warm == 0:
        return decay
    return join(linear(0.0, base, warm), decay, warm)


class Optimizer:
    """AdamW with a global-norm clip and micro-step accumulation over a dict
    of parameters, all of which it trains. ``master`` holds their fp32 values;
    ``update`` writes the new values into the parameters (rounded to their
    dtype). State: ``master``, ``mu``, ``nu``, ``count`` (optimizer steps),
    and for accumulation ``acc`` (running mean) and ``mini_step``."""

    def __init__(self, cfg: TrainConfig, params: Mapping[str, torch.Tensor],
                 master: Optional[Mapping[str, torch.Tensor]] = None):
        self.cfg = cfg
        self.params = dict(params)
        self.names = list(self.params)
        self.lr = make_lr_schedule(cfg)
        self.every = max(1, cfg.gradient_accumulation_steps)
        src = self.params if master is None else master
        self.master = {n: src[n].detach().float().clone() for n in self.names}
        self.mu = {n: torch.zeros_like(m) for n, m in self.master.items()}
        self.nu = {n: torch.zeros_like(m) for n, m in self.master.items()}
        self.acc = ({n: torch.zeros_like(m) for n, m in self.master.items()}
                    if self.every > 1 else None)
        self.count = 0
        self.mini_step = 0
        self.last_grad_norm = float("nan")

    def _lists(self, *dicts):
        return [[d[n] for n in self.names] for d in dicts]

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor]) -> bool:
        """One micro-step with these gradients; True where it was an optimizer
        step (every ``gradient_accumulation_steps``-th call)."""
        g = [grads[n].detach().float() for n in self.names]
        if self.every > 1:
            (acc,) = self._lists(self.acc)
            # running mean over the micro-steps: acc += (g - acc) / (i + 1)
            torch._foreach_add_(acc, torch._foreach_sub(g, acc),
                                alpha=1.0 / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.every:
                return False
            g = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
            self.mini_step = 0
        cfg = self.cfg
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        self.last_grad_norm = float(norm)
        if not self.last_grad_norm < cfg.max_grad_norm:  # optax: unchanged while norm < max
            g = torch._foreach_mul(g, cfg.max_grad_norm / self.last_grad_norm)
        master, mu, nu, params = self._lists(self.master, self.mu, self.nu, self.params)
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        lr = self.lr(self.count)
        self.count += 1
        denom = torch._foreach_div(nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.adam_eps)
        upd = torch._foreach_div(mu, 1.0 - b1 ** self.count)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, master, alpha=cfg.weight_decay)
        torch._foreach_add_(master, upd, alpha=-lr)
        for p, m in zip(params, master):
            p.copy_(m)
        return True

    def state_dict(self) -> dict:
        out = {"count": self.count, "mini_step": self.mini_step,
               "master": self.master, "mu": self.mu, "nu": self.nu}
        if self.acc is not None:
            out["acc"] = self.acc
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for field in ("master", "mu", "nu") + (("acc",) if self.acc is not None else ()):
            mine = getattr(self, field)
            for n in self.names:
                mine[n].copy_(state[field][n])
        for n in self.names:
            self.params[n].copy_(self.master[n])


def make_optimizer(cfg: TrainConfig, params: Mapping[str, torch.Tensor],
                   master: Optional[Mapping[str, torch.Tensor]] = None) -> Optimizer:
    """The optimizer over the trainable partition only: frozen tensors are
    never shown to it."""
    return Optimizer(cfg, params, master)


@dataclasses.dataclass
class TrainState:
    guide: GuidanceUNet
    den: DenoisingUNet
    optimizer: Optimizer
    step: int = 0  # micro-steps taken

    @property
    def trainable(self) -> Dict[str, nn.Parameter]:
        return self.optimizer.params


def init_train_state(cfg: TrainConfig, guide: GuidanceUNet, den: DenoisingUNet,
                     frozen_dtype: Optional[torch.dtype] = None) -> TrainState:
    """Mark the trainable partition (``requires_grad``), take its fp32 master
    copies from the modules as they are, then cast both modules to
    ``frozen_dtype`` where one is given (bf16 at stage 2: the frozen SD
    weights are stored in it, and the trainable ones computed in it)."""
    named = named_parameters(guide, den)
    mask = trainable_mask(named, cfg.trainable_substrings)
    for n, p in named.items():
        p.requires_grad_(mask[n])
    master = {n: p.detach().float().clone() for n, p in named.items() if mask[n]}
    if frozen_dtype is not None:
        guide.to(dtype=frozen_dtype)
        den.to(dtype=frozen_dtype)
    params = {n: p for n, p in named.items() if mask[n]}  # .to() keeps the Parameter objects
    return TrainState(guide, den, make_optimizer(cfg, params, master))


def _models_forward(guide: GuidanceUNet, den: DenoisingUNet, noisy: torch.Tensor,
                    t: torch.Tensor, ctx: torch.Tensor, cond20: torch.Tensor,
                    motion: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
    """Guidance banks + denoising prediction. noisy (B, T, h, w, 4); t (B,);
    ctx (B, S, 768); cond20 (B, T, h, w, 20); motion (B, T, h, w, 2); uncond
    (B,). The guidance UNet runs per frame at t = 0; an uncond sample's banks
    are zeroed."""
    B, T = noisy.shape[:2]
    cdtype = den.conv_in.weight.dtype
    cond_f = cond20.reshape((B * T,) + cond20.shape[2:])
    motion_f = motion.reshape((B * T,) + motion.shape[2:])
    ctx_f = ctx.repeat_interleave(T, dim=0)
    banks = guide(cond_f.to(cdtype), motion_f.to(cdtype),
                  torch.zeros(B * T, dtype=torch.int32, device=noisy.device), ctx_f.to(cdtype))
    keep = (1.0 - uncond).repeat_interleave(T, dim=0)[:, None, None].to(cdtype)
    banks = {k: v * keep for k, v in banks.items()}
    return den(noisy.to(cdtype), t, ctx.to(cdtype), banks=banks).float()


def draw_noise(cfg: TrainConfig, schedule: DDIMSchedule, shape, device,
               generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
    """The random draws of one loss evaluation: ``noise`` (B, T, h, w, C),
    ``offset`` (B, 1, 1, 1, C) and the timesteps ``t`` (B,)."""
    B, C = shape[0], shape[-1]
    return {
        "noise": torch.randn(shape, generator=generator, device=device, dtype=torch.float32),
        "offset": torch.randn((B, 1, 1, 1, C), generator=generator, device=device,
                              dtype=torch.float32),
        "t": torch.randint(0, schedule.num_train_timesteps, (B,), generator=generator,
                           device=device),
    }


def diffusion_loss(cfg: TrainConfig, schedule: DDIMSchedule, guide: GuidanceUNet,
                   den: DenoisingUNet, batch: Mapping[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Mapping[str, torch.Tensor]] = None):
    """One loss evaluation; returns (loss, metrics).

    batch:
      latents      (B, T, h, w, 4)  clean target latents (pre-scaled)
      cond20       (B, T, h, w, 20) guidance stack
      motion       (B, T, h, w, 2)  scene-motion map (zeros for stage 1)
      clip_ctx     (B, S, 768)      CLIP image tokens
      uncond       (B,)             1.0 where this sample drops conditioning

    The noise, the noise offset and the timesteps come from ``draws``
    (``draw_noise``'s keys) where given, else from ``generator``."""
    latents = batch["latents"].float()
    B = latents.shape[0]
    if draws is None:
        draws = draw_noise(cfg, schedule, latents.shape, latents.device, generator)
    noise = draws["noise"].float()
    if cfg.noise_offset > 0:
        noise = noise + cfg.noise_offset * draws["offset"].float()
    t = draws["t"]
    noisy = schedule.add_noise(latents, noise, t)
    target = schedule.get_velocity(latents, noise, t) \
        if cfg.prediction_type == "v_prediction" else noise

    uncond = batch["uncond"].float()
    ctx = batch["clip_ctx"] * (1.0 - uncond)[:, None, None]
    pred = _models_forward(guide, den, noisy, t, ctx, batch["cond20"], batch["motion"], uncond)

    per_sample = (pred - target.float()).square().reshape(B, -1).mean(dim=1)
    if cfg.snr_gamma > 0:
        per_sample = per_sample * min_snr_loss_weight(schedule, t, cfg.snr_gamma,
                                                      cfg.prediction_type)
    loss = per_sample.mean()
    return loss, {"loss": loss.detach(), "t_mean": t.float().mean()}


def make_train_step(cfg: TrainConfig, schedule: DDIMSchedule, state: TrainState):
    """Returns ``step(batch, generator=None, draws=None) -> metrics``: one
    micro-step on ``state``. Gradients exist only for the trainable partition
    and the optimizer sees only that partition. ``metrics`` carries the loss,
    the mean timestep and, after an optimizer step, ``grad_norm`` (the global
    norm before the clip)."""

    def step(batch, generator: Optional[torch.Generator] = None, draws=None):
        params = state.trainable
        for p in params.values():
            p.grad = None
        loss, metrics = diffusion_loss(cfg, schedule, state.guide, state.den, batch,
                                       generator, draws)
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        if state.optimizer.update(grads):
            metrics["grad_norm"] = state.optimizer.last_grad_norm
        for p in params.values():
            p.grad = None
        state.step += 1
        return metrics

    return step
