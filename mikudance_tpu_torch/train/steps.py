"""Training steps for the two MikuDance stages, on one device or on a mesh.

Port of ``mikudance_tpu/train/steps.py``:

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

On a mesh (``core.mesh``: a 1-D 'data' mesh, or ('data', 'frame') for
sequence parallelism) every rank holds its slice of the global batch
(``mesh.shard_train_batch``) and the whole module weights:

- every rank draws the noise, the offset and the timesteps at the global
  shape from the same seeded generator and keeps its slice, so a sample's
  draws agree on all of its frame ranks and the step equals the one-rank
  step;
- a rank's loss is its share of the global mean (its squared errors over the
  per-sample element count, weighted, over the global batch), so the
  gradients are summed over the whole grid, 'frame' included (a mean, as
  DDP takes, would be wrong whenever 'frame' > 1), in fp32 buffers of
  many gradients each (``sum_gradients``): an ``all_reduce`` of each, or
  under ZeRO a ``reduce_scatter`` over 'data' that leaves each rank only
  its shards of the sum;
- with 'frame' > 1 the denoiser's motion modules reshard through the mesh's
  collectives, whose backward is their transpose (``core.mesh``);
- ZeRO (``Optimizer(zero_mesh=...)``): ``master``, ``mu``, ``nu`` and ``acc``
  hold this rank's shard of each leaf (``mesh.zero_shard_plan``) over
  'data'; the clip's norm sums the shards' squares over the axis, the
  updated shards are gathered into the whole parameters, and a checkpoint
  gathers the whole state to the axis's first rank. The JAX package shards
  the parameters too and lets XLA gather them; the numbers are the same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..core import mesh as mesh_lib
from ..diffusion.ddim import DDIMSchedule, min_snr_loss_weight
from ..models.unet import DenoisingUNet, GuidanceUNet
from ..utils.profiling import span

# Elements of one group of the optimizer's update (the clip, the moments and
# the step run a group of leaves at a time, so their temporaries stay this
# size whatever the partition holds)
UPDATE_GROUP_ELEMENTS = 1 << 26
# Elements of one buffer of summed gradients, one collective each (bounds
# the buffer and the host staging of a collective on gloo)
ALL_REDUCE_ELEMENTS = 1 << 26


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


def _batches(names, sizes, limit: int):
    """``names`` in consecutive runs whose sizes sum to at most ``limit``
    (a larger one alone)."""
    run, total = [], 0
    for n, size in zip(names, sizes):
        if run and total + size > limit:
            yield run
            run, total = [], 0
        run.append(n)
        total += size
    if run:
        yield run


class Optimizer:
    """AdamW with a global-norm clip and micro-step accumulation over a dict
    of parameters, all of which it trains. ``master`` holds their fp32 values;
    ``update`` writes the new values into the parameters (rounded to their
    dtype). State: ``master``, ``mu``, ``nu``, ``count`` (optimizer steps),
    and for accumulation ``acc`` (running mean) and ``mini_step``.

    ``zero_mesh``: a mesh whose 'data' axis (> 1 rank) shards the state
    (ZeRO): each of ``master``, ``mu``, ``nu``, ``acc`` holds this rank's
    part of every leaf ``zero_shard_plan`` shards, and the whole of the
    others. ``update`` takes this rank's part of each summed gradient
    (``sum_gradients``); ``state_dict`` gathers the whole state to the
    axis's first rank (collective) and ``load_state_dict`` takes a whole
    one, so ZeRO and one-rank checkpoints resume each other."""

    def __init__(self, cfg: TrainConfig, params: Mapping[str, torch.Tensor],
                 master: Optional[Mapping[str, torch.Tensor]] = None,
                 zero_mesh: Optional[mesh_lib.Mesh] = None):
        self.cfg = cfg
        self.params = dict(params)
        self.names = list(self.params)
        self.lr = make_lr_schedule(cfg)
        self.every = max(1, cfg.gradient_accumulation_steps)
        n = 1 if zero_mesh is None else zero_mesh.shape.get(mesh_lib.DATA_AXIS, 1)
        self.mesh = zero_mesh if n > 1 else None
        self.plan = mesh_lib.zero_shard_plan(self.params, n)
        src = self.params if master is None else master
        src = {k: src[k].detach() for k in self.names}
        if self.mesh is not None:
            src = mesh_lib.zero_shard_state(src, self.mesh)
        self.master = {k: v.float().clone() for k, v in src.items()}
        self.mu = {n: torch.zeros_like(m) for n, m in self.master.items()}
        self.nu = {n: torch.zeros_like(m) for n, m in self.master.items()}
        self.acc = ({n: torch.zeros_like(m) for n, m in self.master.items()}
                    if self.every > 1 else None)
        self.count = 0
        self.mini_step = 0
        self.last_grad_norm = float("nan")
        # groups of leaves for the update, each under UPDATE_GROUP_ELEMENTS
        self._groups = list(_batches(range(len(self.names)),
                                     [self.master[k].numel() for k in self.names],
                                     UPDATE_GROUP_ELEMENTS))

    def shard_dim(self, name: str) -> Optional[int]:
        """The dimension along which this optimizer shards leaf ``name``
        (None: it holds the whole leaf)."""
        return None if self.mesh is None else self.plan[name]

    def shard(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor ``x`` of leaf ``name`` (all of
        it where the leaf is replicated)."""
        d = self.shard_dim(name)
        if d is None:
            return x
        return mesh_lib.shard_slice(x, self.mesh, mesh_lib.DATA_AXIS, d)

    @property
    def state_bytes(self) -> int:
        """Bytes of ``master``, ``mu``, ``nu`` (and ``acc``) on this rank."""
        fields = (self.master, self.mu, self.nu) + ((self.acc,) if self.acc is not None else ())
        return sum(t.numel() * t.element_size() for f in fields for t in f.values())

    def _lists(self, *dicts):
        return [[d[n] for n in self.names] for d in dicts]

    def sum_over_shards(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ZeRO axis (a ``psum``)."""
        return x if self.mesh is None else self.mesh.psum(x, mesh_lib.DATA_AXIS)

    def _global_norm(self, g) -> float:
        """The norm of the whole gradient from this rank's shards: the
        sharded leaves' squares summed over the axis, the replicated ones
        counted once."""
        norms = torch.stack(torch._foreach_norm(g))
        if self.mesh is None:
            return float(torch.linalg.vector_norm(norms))
        sharded = torch.tensor([self.plan[k] is not None for k in self.names],
                               device=norms.device)
        squares = norms.square()
        total = self.sum_over_shards(squares[sharded].sum()) + squares[~sharded].sum()
        return float(total.sqrt())

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor]) -> bool:
        """One micro-step with these gradients, this rank's part of each
        (``shard``; the whole leaf without ZeRO); True where it was an
        optimizer step (every ``gradient_accumulation_steps``-th call)."""
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
        self.last_grad_norm = self._global_norm(g)
        # optax: unchanged while norm < max
        clip = None if self.last_grad_norm < cfg.max_grad_norm else \
            cfg.max_grad_norm / self.last_grad_norm
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        lr = self.lr(self.count)
        self.count += 1
        for group in self._groups:
            names = [self.names[i] for i in group]
            gg = [g[i] for i in group]
            if clip is not None:
                gg = torch._foreach_mul(gg, clip)
            master, mu, nu = ([d[n] for n in names] for d in (self.master, self.mu, self.nu))
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, gg, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, gg, gg, value=1.0 - b2)
            del gg
            denom = torch._foreach_div(nu, 1.0 - b2 ** self.count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, cfg.adam_eps)
            upd = torch._foreach_div(mu, 1.0 - b1 ** self.count)
            torch._foreach_div_(upd, denom)
            del denom
            torch._foreach_add_(upd, master, alpha=cfg.weight_decay)
            torch._foreach_add_(master, upd, alpha=-lr)
        del g
        self._write_params()
        return True

    def _write_params(self) -> None:
        """The parameters from ``master``: replicated leaves here, sharded ones
        gathered (one buffer a parameter dtype, one collective each)."""
        by_dtype: Dict[torch.dtype, list] = {}
        for n in self.names:
            if self.mesh is None or self.plan[n] is None:
                self.params[n].copy_(self.master[n])
            else:
                by_dtype.setdefault(self.params[n].dtype, []).append(n)
        for dtype, names in by_dtype.items():
            mine = torch.cat([self.master[n].reshape(-1).to(dtype) for n in names])
            parts = self.mesh.gather_parts(mine, mesh_lib.DATA_AXIS)
            del mine
            at = 0
            for n in names:
                shape, size = self.master[n].shape, self.master[n].numel()
                whole = torch.cat([p[at:at + size].view(shape) for p in parts], dim=self.plan[n])
                self.params[n].copy_(whole)
                at += size

    def _whole(self, name: str, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The whole leaf from every rank's shard ``x`` in host memory, on the
        axis's first rank (None on the others; collective where sharded)."""
        d = self.plan[name]
        if d is None:
            return x.detach().cpu()
        parts = self.mesh.gather_first(x, mesh_lib.DATA_AXIS)
        return None if parts is None else torch.cat([p.cpu() for p in parts], dim=d)

    def state_dict(self) -> Optional[dict]:
        """The whole state. Under ZeRO every rank of the axis must call it:
        the shards are gathered to the axis's first rank, which alone gets
        the state (the others get None)."""
        out = {"count": self.count, "mini_step": self.mini_step}
        fields = ("master", "mu", "nu") + (("acc",) if self.acc is not None else ())
        for field in fields:
            mine = getattr(self, field)
            out[field] = {n: mine[n] if self.mesh is None else self._whole(n, mine[n])
                          for n in self.names}
        if self.mesh is not None and self.mesh.index(mesh_lib.DATA_AXIS) != 0:
            return None
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        """From a whole state (this rank keeps its shards)."""
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for field in ("master", "mu", "nu") + (("acc",) if self.acc is not None else ()):
            mine = getattr(self, field)
            for n in self.names:
                mine[n].copy_(self.shard(n, state[field][n]))
        for n in self.names:
            self.params[n].copy_(state["master"][n])


def make_optimizer(cfg: TrainConfig, params: Mapping[str, torch.Tensor],
                   master: Optional[Mapping[str, torch.Tensor]] = None,
                   zero_mesh: Optional[mesh_lib.Mesh] = None) -> Optimizer:
    """The optimizer over the trainable partition only: frozen tensors are
    never shown to it. ``zero_mesh``: shard its state over that mesh's
    'data' axis."""
    return Optimizer(cfg, params, master, zero_mesh)


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
                     frozen_dtype: Optional[torch.dtype] = None,
                     zero_mesh: Optional[mesh_lib.Mesh] = None) -> TrainState:
    """Mark the trainable partition (``requires_grad``), take its fp32 master
    copies from the modules as they are, then cast both modules to
    ``frozen_dtype`` where one is given (bf16 at stage 2: the frozen SD
    weights are stored in it, and the trainable ones computed in it).
    ``zero_mesh``: the optimizer state sharded over its 'data' axis."""
    named = named_parameters(guide, den)
    mask = trainable_mask(named, cfg.trainable_substrings)
    for n, p in named.items():
        p.requires_grad_(mask[n])
    # the values as they are; the optimizer copies its part of each in fp32
    # (a cast below gives the modules new tensors and leaves these)
    master = {n: p.detach() for n, p in named.items() if mask[n]}
    if frozen_dtype is not None:
        guide.to(dtype=frozen_dtype)
        den.to(dtype=frozen_dtype)
    params = {n: p for n, p in named.items() if mask[n]}  # .to() keeps the Parameter objects
    return TrainState(guide, den, make_optimizer(cfg, params, master, zero_mesh))


def _models_forward(guide: GuidanceUNet, den: DenoisingUNet, noisy: torch.Tensor,
                    t: torch.Tensor, ctx: torch.Tensor, cond20: torch.Tensor,
                    motion: torch.Tensor, uncond: torch.Tensor,
                    frame_axis: Optional[mesh_lib.Axis] = None) -> torch.Tensor:
    """Guidance banks + denoising prediction. noisy (B, T, h, w, 4); t (B,);
    ctx (B, S, 768); cond20 (B, T, h, w, 20); motion (B, T, h, w, 2); uncond
    (B,). The guidance UNet runs per frame at t = 0; an uncond sample's banks
    are zeroed. ``frame_axis``: the mesh axis over which T is this rank's
    share of the frames (the denoiser's motion modules reshard over it; all
    else here is frame-local)."""
    B, T = noisy.shape[:2]
    cdtype = den.conv_in.weight.dtype
    cond_f = cond20.reshape((B * T,) + cond20.shape[2:])
    motion_f = motion.reshape((B * T,) + motion.shape[2:])
    ctx_f = ctx.repeat_interleave(T, dim=0)
    banks = guide(cond_f.to(cdtype), motion_f.to(cdtype),
                  torch.zeros(B * T, dtype=torch.int32, device=noisy.device), ctx_f.to(cdtype))
    keep = (1.0 - uncond).repeat_interleave(T, dim=0)[:, None, None].to(cdtype)
    banks = {k: v * keep for k, v in banks.items()}
    return den(noisy.to(cdtype), t, ctx.to(cdtype), banks=banks, frame_axis=frame_axis).float()


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
                   draws: Optional[Mapping[str, torch.Tensor]] = None,
                   mesh: Optional[mesh_lib.Mesh] = None):
    """One loss evaluation; returns (loss, metrics).

    batch:
      latents      (B, T, h, w, 4)  clean target latents (pre-scaled)
      cond20       (B, T, h, w, 20) guidance stack
      motion       (B, T, h, w, 2)  scene-motion map (zeros for stage 1)
      clip_ctx     (B, S, 768)      CLIP image tokens
      uncond       (B,)             1.0 where this sample drops conditioning

    The noise, the noise offset and the timesteps come from ``draws``
    (``draw_noise``'s keys) where given, else from ``generator``; either way
    they are the global batch's.

    ``mesh`` (a 'data' or ('data', 'frame') mesh): ``batch`` is this rank's
    slice (``mesh.shard_train_batch``); the draws are made at the global
    shape and sliced alike; the returned loss is this rank's share of the
    global loss (summed over the grid it is the global loss, and so are the
    gradients); ``metrics["loss"]`` is the global loss on every rank."""
    latents = batch["latents"].float()
    B, T = latents.shape[:2]
    nd = 1 if mesh is None else mesh.shape.get(mesh_lib.DATA_AXIS, 1)
    nf = 1 if mesh is None else mesh.shape.get(mesh_lib.FRAME_AXIS, 1)
    if draws is None:
        draws = draw_noise(cfg, schedule, (B * nd, T * nf) + tuple(latents.shape[2:]),
                           latents.device, generator)
    t_all = draws["t"]
    if mesh is not None:
        draws = mesh_lib.shard_train_batch(
            {"latents": draws["noise"], "offset": draws["offset"], "t": t_all}, mesh)
        draws["noise"] = draws.pop("latents")  # the noise splits as the latents do
    noise = draws["noise"].float()
    if cfg.noise_offset > 0:
        noise = noise + cfg.noise_offset * draws["offset"].float()
    t = draws["t"]
    noisy = schedule.add_noise(latents, noise, t)
    target = schedule.get_velocity(latents, noise, t) \
        if cfg.prediction_type == "v_prediction" else noise

    uncond = batch["uncond"].float()
    ctx = batch["clip_ctx"] * (1.0 - uncond)[:, None, None]
    frame_axis = mesh_lib.Axis(mesh, mesh_lib.FRAME_AXIS) if nf > 1 else None
    pred = _models_forward(guide, den, noisy, t, ctx, batch["cond20"], batch["motion"], uncond,
                           frame_axis)

    se = (pred - target.float()).square().reshape(B, -1)
    if mesh is None:
        per_sample = se.mean(dim=1)
    else:  # a sample's squared errors over all of its elements, on every frame rank
        per_sample = se.sum(dim=1) / (se.shape[1] * nf)
    if cfg.snr_gamma > 0:
        per_sample = per_sample * min_snr_loss_weight(schedule, t, cfg.snr_gamma,
                                                      cfg.prediction_type)
    if mesh is None:
        loss = per_sample.mean()
        total = loss.detach()
    else:
        loss = per_sample.sum() / (B * nd)
        total = mesh.psum(loss.detach())
    return loss, {"loss": total, "t_mean": t_all.float().mean()}


def sum_gradients(grads: Mapping[str, torch.Tensor], mesh: mesh_lib.Mesh,
                  optimizer: Optimizer) -> Dict[str, torch.Tensor]:
    """The gradients summed over every rank of ``mesh``, as
    ``optimizer.update`` takes them: in fp32 (the optimizer reads fp32), in
    buffers of at most ``ALL_REDUCE_ELEMENTS``, one collective a buffer.
    A leaf the optimizer holds whole is all-reduced. A leaf it shards (ZeRO
    over ``mesh``'s 'data' axis) is laid out by shard, rank r's part of it
    in row r of its buffer, summed over 'frame' where that axis has more
    than one rank, and reduce-scattered over 'data': this rank receives its
    own shard of the sum and nothing more."""
    out: Dict[str, torch.Tensor] = {}
    dev = next(iter(grads.values())).device
    whole = [k for k in grads if optimizer.shard_dim(k) is None]
    for names in _batches(whole, [grads[k].numel() for k in whole], ALL_REDUCE_ELEMENTS):
        sizes = [grads[k].numel() for k in names]
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        for k, piece in zip(names, flat.split(sizes)):
            piece.copy_(grads[k].reshape(-1))
        mesh.all_reduce_(flat)
        out.update({k: piece.view(grads[k].shape) for k, piece in zip(names, flat.split(sizes))})
    sharded = [k for k in grads if k not in out]
    if not sharded:
        return out
    n = mesh.shape[mesh_lib.DATA_AXIS]
    sizes = {k: grads[k].numel() // n for k in sharded}
    mine = torch.empty(sum(sizes.values()), dtype=torch.float32, device=dev)
    at = 0
    for names in _batches(sharded, [grads[k].numel() for k in sharded], ALL_REDUCE_ELEMENTS):
        width = sum(sizes[k] for k in names)
        buf = torch.empty((n, width), dtype=torch.float32, device=dev)
        col = 0
        for k in names:
            shape, d = grads[k].shape, optimizer.shard_dim(k)
            pre, post = math.prod(shape[:d]), math.prod(shape[d + 1:])
            rows = buf[:, col:col + sizes[k]].view(n, pre, shape[d] // n, post)
            rows.copy_(grads[k].reshape(pre, n, shape[d] // n, post).transpose(0, 1))
            col += sizes[k]
        if mesh.shape.get(mesh_lib.FRAME_AXIS, 1) > 1:
            mesh.all_reduce_(buf, mesh_lib.FRAME_AXIS)
        mine[at:at + width].copy_(mesh.reduce_scatter(buf, mesh_lib.DATA_AXIS).reshape(-1))
        del buf
        for k in names:
            shape = list(grads[k].shape)
            shape[optimizer.shard_dim(k)] //= n
            out[k] = mine[at:at + sizes[k]].view(shape)
            at += sizes[k]
    return out


def make_train_step(cfg: TrainConfig, schedule: DDIMSchedule, state: TrainState,
                    mesh: Optional[mesh_lib.Mesh] = None):
    """Returns ``step(batch, generator=None, draws=None) -> metrics``: one
    micro-step on ``state``. Gradients exist only for the trainable partition
    and the optimizer sees only that partition. ``metrics`` carries the loss,
    the mean timestep and, after an optimizer step, ``grad_norm`` (the global
    norm before the clip).

    ``mesh``: a 'data' or ('data', 'frame') mesh of more than one rank
    (``core.mesh.choose_train_mesh``); ``batch`` is then this rank's slice,
    the draws the global batch's, and the gradients are summed over the whole
    grid before the optimizer step, which every rank takes alike."""

    def step(batch, generator: Optional[torch.Generator] = None, draws=None):
        with span("train_step"):
            params = state.trainable
            for p in params.values():
                p.grad = None
            with span("forward"):
                loss, metrics = diffusion_loss(cfg, schedule, state.guide, state.den, batch,
                                               generator, draws, mesh)
            with span("backward"):
                loss.backward()
            with span("gradients"):
                grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                         for n, p in params.items()}
                for p in params.values():
                    p.grad = None
                if mesh is not None:
                    grads = sum_gradients(grads, mesh, state.optimizer)
            with span("optimizer"):
                if state.optimizer.update(grads):
                    metrics["grad_norm"] = state.optimizer.last_grad_norm
            del grads
            state.step += 1
            return metrics

    return step
