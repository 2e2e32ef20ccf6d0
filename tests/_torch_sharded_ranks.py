"""Rank bodies of the port's sharded tests, run by ``core.mesh.spawn``.

Torch only: the spawned processes import this module, never a test file that
imports JAX. Weights and inputs arrive as numpy arrays; every body returns
numpy arrays (its rank's share, or the whole result every rank holds) and
the calls each collective of its mesh took.

Run as a script, it is one rank of the port's CLI at tiny widths under
``torchrun`` and saves what ``main`` returned to ``OUT_DIR/rank<RANK>.pt``:

    python -m torch.distributed.run --standalone --nproc-per-node N \
        tests/_torch_sharded_ranks.py OUT_DIR <inference_video arguments>
"""

import os
import sys
from collections import Counter

import numpy as np
import torch

from mikudance_tpu_torch.core import mesh as mesh_lib
from mikudance_tpu_torch.core.configs import (CLIPVisionConfig, DenoisingUNetConfig,
                                              GuidanceUNetConfig, MotionModuleConfig, UNetConfig,
                                              VAEConfig)
from mikudance_tpu_torch.models import motion_module, unet, vae, vae_temporal
from mikudance_tpu_torch.pipelines import video

TINY = UNetConfig(block_out_channels=(32, 64, 96, 96), attention_heads=4)
TINY_VAE = VAEConfig(block_out_channels=(16, 32, 32, 32), norm_num_groups=8)
TINY_GUIDE = GuidanceUNetConfig(unet=TINY, use_man=True)
TINY_DEN = DenoisingUNetConfig(unet=TINY, motion=MotionModuleConfig(num_attention_heads=4))
TINY_CLIP = CLIPVisionConfig(image_size=28, hidden_size=32, intermediate_size=64, num_layers=1,
                             num_heads=2)
# the CLI's loaders at tiny widths: keyword arguments each one is called with
LOADERS = {"load_guidance": {"unet_config": TINY},
           "load_denoising": {"unet_config": TINY,
                              "motion_config": MotionModuleConfig(num_attention_heads=4)},
           "load_vae": {"config": TINY_VAE}, "load_clip": {"config": TINY_CLIP}}


def numpy_state(module: torch.nn.Module) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def load(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return module.eval()


def counting(mesh: mesh_lib.Mesh) -> Counter:
    """Count the collectives ``mesh`` runs, by name."""
    calls = Counter()
    for name in ("all_gather", "all_to_all", "exchange", "psum", "halo", "broadcast"):
        def wrapped(*args, _fn=getattr(mesh, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        setattr(mesh, name, wrapped)
    return calls


@torch.no_grad()
def motion_module_shards(dim: int, heads: int, state: dict, inputs: list):
    """Each (B, T, H, W, C) input through the motion module with its frames
    split over a 1-D 'frame' mesh of every rank: (the rank's output frames
    per input, the collectives of each input)."""
    m = load(motion_module.MotionModule(dim, heads), state)
    mesh = mesh_lib.make_mesh(axis_name=mesh_lib.FRAME_AXIS)
    axis = mesh_lib.Axis(mesh, mesh_lib.FRAME_AXIS)
    outs, calls = [], []
    for x in inputs:
        per, i = x.shape[1] // mesh.size, mesh.index(mesh_lib.FRAME_AXIS)
        seen = counting(mesh)
        outs.append(m(torch.from_numpy(x[:, i * per:(i + 1) * per]), axis).numpy())
        calls.append(dict(seen))
    return outs, calls


@torch.no_grad()
def temporal_decoder_shards(state: dict, z: np.ndarray, scaled: list, chunk: int):
    """The temporal decoder on the rank's consecutive share of the chunk
    ``z`` (frames split over every rank: halos and summed moments), then
    ``decode_frames`` with a mesh on each scaled latent stack (whole chunks
    a rank, or a chunk's frames a rank with a remainder): (the rank's
    frames, the whole decodes, the collectives)."""
    dec = load(vae_temporal.TemporalDecoder(TINY_VAE), state)
    dec.decode_chunk = chunk
    mesh = mesh_lib.make_mesh()
    calls = counting(mesh)
    per, i = z.shape[0] // mesh.size, mesh.index()
    mine = dec(torch.from_numpy(z[i * per:(i + 1) * per]), mesh_lib.Axis(mesh)).numpy()
    whole = [video.decode_frames(dec, torch.from_numpy(lat), mesh).numpy() for lat in scaled]
    return mine, whole, dict(calls)


def tiny_bundle(states: dict, temporal: bool = False) -> video.ModelBundle:
    dec = vae_temporal.TemporalDecoder(TINY_VAE) if temporal else vae.Decoder(TINY_VAE)
    return video.ModelBundle(load(unet.GuidanceUNet(TINY_GUIDE), states["guide"]),
                             load(unet.DenoisingUNet(TINY_DEN), states["den"]),
                             load(vae.Encoder(TINY_VAE), states["enc"]),
                             load(dec, states["dec"]))


def pipeline_shards(states: dict, config, inputs: tuple, calls: list, temporal: bool = False):
    """The tiny pipeline on a mesh of every rank, called once per keyword set
    of ``calls`` with the same inputs: (each call's result, the chosen meshes'
    shapes, the collectives of the pipeline's meshes)."""
    pipe = video.VideoPipeline(tiny_bundle(states, temporal), config, device="cpu",
                               mesh=mesh_lib.make_mesh())
    seen = Counter()
    choose = pipe.mesh_for

    def mesh_for(*args):
        m = choose(*args)
        if m is not None and not hasattr(m, "_counted"):
            m._counted = counting(m)
        return m

    pipe.mesh_for = mesh_for
    results = []
    for kw in calls:
        out = pipe(*inputs, **kw)
        results.append(out.numpy() if isinstance(out, torch.Tensor) else out)
    shapes = {k: (None if m is None else m.shape) for k, m in pipe._meshes.items()}
    for m in pipe._meshes.values():
        if m is not None:
            seen.update(m._counted)
    return results, shapes, dict(seen)


def bank_residency(states: dict, runs: list):
    """Each (config, inputs) through the tiny pipeline on a mesh of every
    rank: per run, (the latents, the batch of each guidance-UNet call on this
    rank, the bank rows handed to the denoiser, the denoiser that ran)."""
    out = []
    for config, inputs in runs:
        pipe = video.VideoPipeline(tiny_bundle(states), config, device="cpu",
                                   mesh=mesh_lib.make_mesh())
        guided, held = [], []
        guide = pipe.bundle.guide.forward

        def forward(x, *args, _guide=guide, _seen=guided, **kwargs):
            _seen.append(x.shape[0])
            return _guide(x, *args, **kwargs)

        pipe.bundle.guide.forward = forward
        for name in ("_denoise", "_denoise_streamed"):
            def denoise(*args, _fn=getattr(pipe, name), _name=name, _held=held, **kwargs):
                banks = args[1] if _name == "_denoise" else kwargs.get("banks_cached")
                _held.append((_name, None if banks is None
                              else int(next(iter(banks.values())).shape[0])))
                return _fn(*args, **kwargs)
            setattr(pipe, name, denoise)
        latents = pipe(*inputs, decode=False).numpy()
        out.append((latents, guided, held))
    return out


def tiny_loaders() -> None:
    """The port's loaders at tiny widths (every rank draws the same seeded
    weights)."""
    from mikudance_tpu_torch.core import loaders

    for name, fixed in LOADERS.items():
        real = getattr(loaders, name)
        setattr(loaders, name, lambda *p, _real=real, _fixed=fixed, **kw: _real(
            *p, **{**kw, **_fixed}))


def fail_on(rank: int) -> None:
    """Raises on global rank ``rank``; every other rank waits in a barrier
    that the failed rank leaves."""
    if torch.distributed.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()


if __name__ == "__main__":
    from mikudance_tpu_torch.scripts import inference_video

    torch.set_num_threads(1)  # the ranks share the host's cores
    tiny_loaders()
    result = inference_video.main(sys.argv[2:])
    grouped = torch.distributed.is_initialized()
    torch.save((result, grouped), os.path.join(sys.argv[1], f"rank{os.environ['RANK']}.pt"))
    if grouped:
        torch.distributed.destroy_process_group()
