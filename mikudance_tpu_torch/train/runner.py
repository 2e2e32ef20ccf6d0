"""Shared training-loop runner for both stages, on one device or on the
ranks of a process group.

Port of ``mikudance_tpu/train/runner.py`` without its donation: a JSONL
metrics log (mlflow attaches when importable), checkpoint cadence with
last-3 retention, resume from the newest checkpoint, deployable weight export
at step and epoch cadences, and the reference's counting rule: ``max_steps``
and every cadence count optimizer steps, not micro-batches.

Under a process group the mesh is the JAX package's: ``batch_size`` > 0
chooses a ('data', 'frame') mesh (``choose_train_mesh``), with sequence
parallelism where 'frame' > 1; otherwise a 1-D 'data' mesh over every rank.
``zero_shard`` shards the optimizer state over 'data', only without
sequence parallelism. Every rank materializes the same global batch (same
seeds) and keeps its slice; rank 0 alone logs, validates, exports and writes
the checkpoints, which hold the whole state.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..core import mesh as mesh_lib
from ..diffusion.ddim import DDIMSchedule
from ..models.vae import latent_mean, latent_sample
from ..pipelines.video import SD_LATENT_SCALE
from . import checkpoint as ckpt_lib
from .steps import TrainConfig, TrainState, init_train_state, make_train_step


class MetricsLogger:
    """JSONL + optional mlflow."""

    def __init__(self, out_dir: str, run_name: str):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._mlflow = None
        try:  # pragma: no cover - mlflow is optional
            import mlflow

            mlflow.start_run(run_name=run_name)
            self._mlflow = mlflow
        except Exception:
            pass

    def _append(self, rec: Dict[str, Any]) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self._append({"step": step, "time": time.time(), **metrics})
        if self._mlflow:
            self._mlflow.log_metrics(metrics, step=step)

    def log_artifact(self, step: int, path: str) -> None:
        """Validation media: an mlflow artifact when attached; the JSONL
        records the path either way."""
        self._append({"step": step, "time": time.time(), "artifact": path})
        if self._mlflow:
            try:
                self._mlflow.log_artifact(path, artifact_path=f"step_{step}")
            except Exception:
                pass


@dataclasses.dataclass
class EncoderFns:
    """Frozen encoders that prepare batches on the device. Their outputs are
    ordinary tensors made under ``no_grad``, which a training step can save."""

    vae_encode_sample: Callable  # (generator, imgs NHWC [-1,1]) -> scaled latents
    vae_encode_mean: Callable  # (imgs) -> scaled latents
    clip_encode: Callable  # (clip pixel values NHWC) -> (B, S, 768)


def make_encoder_fns(vae_enc, clip, chunk: int = 4) -> EncoderFns:
    """``chunk``: pictures per VAE encoder call (a memory knob; pictures are
    independent)."""

    def moments(imgs):
        return torch.cat([vae_enc(imgs[i:i + chunk]) for i in range(0, imgs.shape[0], chunk)])

    @torch.no_grad()
    def enc_sample(generator, imgs):
        return latent_sample(moments(imgs), generator) * SD_LATENT_SCALE

    @torch.no_grad()
    def enc_mean(imgs):
        return latent_mean(moments(imgs)) * SD_LATENT_SCALE

    @torch.no_grad()
    def clip_fn(px):
        return clip(px.to(clip.visual_projection.weight.dtype))

    return EncoderFns(enc_sample, enc_mean, clip_fn)


def train_loop(
    *,
    cfg: TrainConfig,
    schedule: DDIMSchedule,
    guide,
    den,
    batches: Any,  # Iterable (one pass) or re-iterable / zero-arg factory (epochs)
    prepare_batch: Callable[[Dict[str, Any], random.Random], Dict[str, torch.Tensor]],
    max_steps: int,
    output_dir: str,
    run_name: str,
    checkpointing_steps: int = 3000,
    log_every: int = 10,
    seed: int = 186,
    validation_fn: Optional[Callable[[int, TrainState], Optional[str]]] = None,
    validation_steps: int = 3000,
    export_fn: Optional[Callable[[int, TrainState], None]] = None,
    save_model_steps: int = 3000,
    save_model_epochs: int = 0,  # 0 = off
    batch_size: int = 0,
    clip_frames: int = 1,
    frozen_dtype: Optional[torch.dtype] = None,
    zero_shard: bool = False,
) -> TrainState:
    """Train ``guide`` and ``den`` where they are (the modules' device) until
    ``max_steps`` optimizer steps; returns the final ``TrainState``.
    ``prepare_batch`` gives the global batch; under a process group every
    rank calls this (module docstring)."""
    grouped = dist.is_available() and dist.is_initialized()
    rank, world = (dist.get_rank(), dist.get_world_size()) if grouped else (0, 1)
    # batch_size > 0 activates the ('data', 'frame') training mesh: frames of
    # one clip shard too (sequence parallelism), which is what lets stage 2
    # train 20-frame clips that one card cannot hold. 1-D data mesh otherwise.
    mesh = None
    if batch_size > 0:
        mesh = mesh_lib.choose_train_mesh(range(world), batch_size, clip_frames)
    sp = mesh is not None and mesh.shape.get(mesh_lib.FRAME_AXIS, 1) > 1
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    zero = zero_shard and not sp and mesh.shape.get(mesh_lib.DATA_AXIS, 1) > 1
    if rank == 0 and mesh.size > 1:
        print(f"training mesh: {mesh.shape}" + (" (sequence-parallel frames)" if sp else "")
              + (" (optimizer state sharded over 'data')" if zero else ""))
    state = init_train_state(cfg, guide, den, frozen_dtype=frozen_dtype,
                             zero_mesh=mesh if zero else None)
    if rank not in mesh:  # a subset of the ranks makes the mesh: this one idles
        print(f"rank {rank} is outside the training mesh {mesh}: no steps")
        return state
    mgr = ckpt_lib.make_manager(os.path.join(output_dir, "checkpoints"), keep=3)
    state, start_step = ckpt_lib.restore_state(mgr, state)
    if start_step and rank == 0:
        print(f"resumed from checkpoint step {start_step}")

    step_fn = make_train_step(cfg, schedule, state, mesh if mesh.size > 1 else None)
    logger = MetricsLogger(output_dir, run_name) if rank == 0 else None
    host_rng = random.Random(seed)
    device = den.conv_in.weight.device
    generator = torch.Generator(device=device).manual_seed(seed)

    step = start_step
    t0 = time.time()
    # `step`, max_steps and every cadence below count OPTIMIZER steps: with
    # gradient accumulation each counted step is `accum` micro-batches.
    accum = max(1, cfg.gradient_accumulation_steps)
    micro = 0
    # Epoch cycling: re-iterate `batches` until the step budget is spent. A
    # plain generator exhausts after one pass and ends the loop.
    epoch = 0
    while step < max_steps:
        epoch_iter = iter(batches() if callable(batches) else batches)
        saw_batch = False
        while step < max_steps:
            try:  # budget checked BEFORE the fetch: don't load a batch just to drop it
                batch = next(epoch_iter)
            except StopIteration:
                break
            saw_batch = True
            dev_batch = prepare_batch(batch, host_rng)
            if mesh.size > 1:
                dev_batch = mesh_lib.shard_train_batch(dev_batch, mesh)
            metrics = step_fn(dev_batch, generator)
            micro += 1
            if micro % accum:
                continue  # mid-accumulation: no optimizer step happened
            step += 1

            if step % log_every == 0 and logger is not None:
                loss = float(metrics["loss"])
                dt = (time.time() - t0) / log_every
                t0 = time.time()
                logger.log(step, {"train_loss": loss, "grad_norm": float(metrics["grad_norm"]),
                                  "sec_per_step": dt, "epoch": epoch})
                print(f"step {step}: loss={loss:.5f} ({dt:.2f}s/step)")
            if step % checkpointing_steps == 0:
                ckpt_lib.save_state(mgr, step, state, write=rank == 0)
            if validation_fn and step % validation_steps == 0 and rank == 0:
                artifact = validation_fn(step, state)
                if isinstance(artifact, str):
                    logger.log_artifact(step, artifact)
            if export_fn and step % save_model_steps == 0 and rank == 0:
                export_fn(step, state)
        if not saw_batch:
            break  # exhausted generator or empty dataset: no more data
        epoch += 1
        if export_fn and save_model_epochs and epoch % save_model_epochs == 0 and rank == 0:
            export_fn(step, state)
    return state
