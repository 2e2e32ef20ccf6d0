"""Rank bodies of the port's sharded training tests, run by ``core.mesh.spawn``.

Torch only: the spawned processes import this module, never a test file that
imports JAX. Weights, batches and draws arrive as numpy arrays; every body
returns numpy arrays.

Run as a script, it is one rank of the stage-2 trainer at tiny widths under
``torchrun`` and saves what that rank ends with to ``OUT_DIR/rank<RANK>.pt``:

    python -m torch.distributed.run --standalone --nproc-per-node N \
        tests/_torch_sharded_train_ranks.py OUT_DIR <train_stage2 arguments>
"""

import os
import sys

import numpy as np
import torch

from mikudance_tpu_torch.core import mesh as mesh_lib
from mikudance_tpu_torch.core.configs import (CLIPVisionConfig, DenoisingUNetConfig,
                                              GuidanceUNetConfig, MotionModuleConfig, UNetConfig,
                                              VAEConfig)
from mikudance_tpu_torch.diffusion import ddim
from mikudance_tpu_torch.models import motion_module, unet
from mikudance_tpu_torch.train import checkpoint as ckpt
from mikudance_tpu_torch.train import steps

TINY = UNetConfig(block_out_channels=(32, 64, 96, 96), attention_heads=4)
# the ZeRO tests' UNets (tests/test_zero_sharding.py's TINY)
ZERO_TINY = UNetConfig(block_out_channels=(32, 64), layers_per_block=1, attention_heads=4)
STAGE2 = ("motion", "man_")
TINY_VAE = VAEConfig(block_out_channels=(16, 32, 32, 32), norm_num_groups=8)
TINY_CLIP = CLIPVisionConfig(image_size=224, patch_size=56, hidden_size=64,
                             intermediate_size=128, num_layers=1, num_heads=4,
                             projection_dim=768)


def tiny_unets(states: dict, stage2: bool = True, remat: bool = False, u: UNetConfig = TINY):
    """The tiny guidance and denoising UNets with these weights, fp32."""
    guide = unet.GuidanceUNet(GuidanceUNetConfig(unet=u, use_man=stage2), remat=remat)
    den = unet.DenoisingUNet(DenoisingUNetConfig(
        unet=u, motion=MotionModuleConfig(enabled=stage2, num_attention_heads=4)),
        remat=remat)
    for module, state in ((guide, states["guide"]), (den, states["den"])):
        module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return guide, den


def numpy_params(state: steps.TrainState) -> dict:
    return {n: p.detach().float().cpu().numpy() for n, p in state.trainable.items()}


def torch_tree(tree: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def motion_module_grads(dim: int, heads: int, state: dict, inputs: list, cotangents: list,
                        remat: bool):
    """Each (B, T, H, W, C) input through the motion module with its frames
    split over a 1-D 'frame' mesh of every rank, and the backward of
    ``sum(out * cotangent)`` on the rank's frames: per input, (the rank's
    input gradient, its parameter gradients); then the same with the mesh's
    ``all_to_all`` and ``all_gather`` reduced to their forward (the control,
    no backward); and the gradient of ``sum(psum(x) * (rank + 1))`` for x
    of ones."""
    m = motion_module.MotionModule(dim, heads, remat=remat)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    mesh = mesh_lib.make_mesh(axis_name=mesh_lib.FRAME_AXIS)
    axis = mesh_lib.Axis(mesh, mesh_lib.FRAME_AXIS)

    def run():
        out = []
        for x, cot in zip(inputs, cotangents):
            per, i = x.shape[1] // mesh.size, mesh.index(mesh_lib.FRAME_AXIS)
            mine = torch.from_numpy(x[:, i * per:(i + 1) * per]).requires_grad_(True)
            m.zero_grad(set_to_none=True)
            y = m(mine, axis)
            (y * torch.from_numpy(cot[:, i * per:(i + 1) * per])).sum().backward()
            out.append((mine.grad.numpy(),
                        {n: (np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy())
                         for n, p in m.named_parameters()}))
        return out

    sharded = run()
    x = torch.ones(3, requires_grad=True)
    (mesh.psum(x, mesh_lib.FRAME_AXIS) * (mesh.rank + 1)).sum().backward()
    mesh.all_to_all = mesh.all_to_all_values
    mesh.all_gather = lambda x, axis=None, dim=0: torch.cat(mesh.gather_parts(x, axis), dim=dim)
    return sharded, run(), x.grad.numpy()


def train_step(states: dict, substrings, batch: dict, draws: dict, shape, remat: bool,
               lr: float = 1e-5):
    """One optimizer step of the tiny stage-2 UNets on a ('data', 'frame')
    mesh of ``shape`` over every rank (a world of one: no mesh), the global
    ``batch`` sliced to the rank, the global ``draws``: (the loss in the
    metrics, the trainable parameters after the step, the gradient norm,
    Adam's first moment after the step: (1 - b1) times the clipped summed
    gradient)."""
    guide, den = tiny_unets(states, remat=remat)
    cfg = steps.TrainConfig(trainable_substrings=substrings, learning_rate=lr)
    schedule = ddim.DDIMSchedule.create(beta_schedule="scaled_linear")
    state = steps.init_train_state(cfg, guide, den)
    batch = torch_tree(batch)
    mesh = None
    if mesh_lib.make_mesh().size > 1:
        ranks = np.arange(int(np.prod(shape))).reshape(shape)
        mesh = mesh_lib.Mesh(ranks, (mesh_lib.DATA_AXIS, mesh_lib.FRAME_AXIS))
        batch = mesh_lib.shard_train_batch(batch, mesh)
    metrics = steps.make_train_step(cfg, schedule, state, mesh)(batch, draws=torch_tree(draws))
    mu = {n: m.numpy().copy() for n, m in state.optimizer.mu.items()}
    return float(metrics["loss"]), numpy_params(state), metrics["grad_norm"], mu


def train_steps(states: dict, cases: list, batch: dict, draws: dict, shape, remat: bool) -> list:
    """``train_step`` for each trainable set of ``cases``, in one process."""
    return [train_step(states, substrings, batch, draws, shape, remat) for substrings in cases]


def zero_runs(states: dict, batch: dict, draws: dict, rep_dir: str, zero_dir: str) -> dict:
    """In one process: the replicated step saved to ``rep_dir``, the ZeRO
    step saved to ``zero_dir``, then the ZeRO resume from ``zero_dir``."""
    out = {"replicated": zero_step(states, batch, draws, False, rep_dir),
           "zero": zero_step(states, batch, draws, True, zero_dir)}
    torch.distributed.barrier()  # rank 0 has written
    out["resume"] = resume_step(states, zero_dir, batch, draws, True)
    return out


def zero_step(states: dict, batch: dict, draws: dict, zero: bool, ckpt_dir: str = "",
              accum: int = 1):
    """Stage-1 training of the ZeRO tests' UNets on a 1-D 'data' mesh of every rank:
    ``accum`` micro-steps of the global ``batch`` with the global ``draws``
    (one optimizer step), the optimizer state sharded over 'data' with
    ``zero``; with ``ckpt_dir``, the whole state saved there (rank 0 writes).
    Returns (the loss, the trainable parameters, the gradient norm, this
    rank's optimizer-state bytes, the ZeRO plan, each leaf's master shape)."""
    guide, den = tiny_unets(states, stage2=False, u=ZERO_TINY)
    cfg = steps.TrainConfig(learning_rate=1e-3, gradient_accumulation_steps=accum)
    schedule = ddim.DDIMSchedule.create(beta_schedule="scaled_linear")
    mesh = mesh_lib.make_mesh()
    state = steps.init_train_state(cfg, guide, den, zero_mesh=mesh if zero else None)
    step = steps.make_train_step(cfg, schedule, state, mesh if mesh.size > 1 else None)
    for _ in range(accum):
        metrics = step(mesh_lib.shard_train_batch(torch_tree(batch), mesh),
                       draws=torch_tree(draws))
    if ckpt_dir:
        ckpt.save_state(ckpt.make_manager(ckpt_dir), state.step, state, write=mesh.rank == 0)
    opt = state.optimizer
    return (float(metrics["loss"]), numpy_params(state), metrics["grad_norm"], opt.state_bytes,
            opt.plan, {n: tuple(m.shape) for n, m in opt.master.items()})


def resume_step(states: dict, ckpt_dir: str, batch: dict, draws: dict, zero: bool):
    """The ZeRO tests' stage-1 state restored from ``ckpt_dir`` on a 'data' mesh of
    every rank (ZeRO with ``zero``), then one more step: (the restored step
    count, the parameters after the step, the whole optimizer state as
    restored, which under ZeRO the first rank alone holds: None on the
    others)."""
    guide, den = tiny_unets(states, stage2=False, u=ZERO_TINY)
    cfg = steps.TrainConfig(learning_rate=1e-3)
    schedule = ddim.DDIMSchedule.create(beta_schedule="scaled_linear")
    mesh = mesh_lib.make_mesh()
    state = steps.init_train_state(cfg, guide, den, zero_mesh=mesh if zero else None)
    state, at = ckpt.restore_state(ckpt.make_manager(ckpt_dir), state)
    whole = state.optimizer.state_dict()
    restored = None if whole is None else {f: {n: v.numpy().copy() for n, v in whole[f].items()}
                                           for f in ("master", "mu", "nu")}
    steps.make_train_step(cfg, schedule, state, mesh if mesh.size > 1 else None)(
        mesh_lib.shard_train_batch(torch_tree(batch), mesh), draws=torch_tree(draws))
    return at, numpy_params(state), {"restored": restored}


def tiny_loaders(patch=setattr) -> None:
    """The trainers' loaders at tiny widths (every rank draws the same seeded
    weights): the VAE and CLIP tower cut to tiny widths, the UNets by the
    YAML's ``unet_overrides``. ``patch``: ``setattr`` or a test's
    ``monkeypatch.setattr``."""
    from mikudance_tpu_torch.core import loaders

    for name, cfg in (("load_vae", TINY_VAE), ("load_clip", TINY_CLIP)):
        real = getattr(loaders, name)
        patch(loaders, name, lambda p, _real=real, _cfg=cfg, **kw: _real(p, config=_cfg, **kw))


if __name__ == "__main__":
    from mikudance_tpu_torch.scripts import train_stage2

    torch.set_num_threads(1)  # the ranks share the host's cores
    tiny_loaders()
    state = train_stage2.main(sys.argv[2:])
    grouped = torch.distributed.is_initialized()
    torch.save((numpy_params(state), state.optimizer.count, grouped),
               os.path.join(sys.argv[1], f"rank{os.environ['RANK']}.pt"))
    if grouped:
        torch.distributed.destroy_process_group()
