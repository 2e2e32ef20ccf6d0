"""Entry points: one flagship forward, and a dry run over several ranks.

Port of ``__graft_entry__.py``:

- ``entry(device=None)`` returns ``(fn, args)``: the 3-D denoising UNet at
  full SD1.5 widths (``DenoisingUNetConfig()``), bf16, with its banks and 257
  context tokens, on a 4-frame clip of 64 x 64 latents (512^2 pictures).
  The weights are the module's seeded init, the inputs seeded normals, so
  the kernels see data. ``fn(*args)`` runs the forward without gradients.
- ``dryrun_multichip(n_devices, device=None)`` spawns ``n_devices`` ranks
  (``core.mesh.spawn``, gloo) and runs the JAX dry run's phases at its tiny
  widths on every rank: the data-parallel stage-2 train step, the
  sequence-parallel step (its loss within 1e-4 of the first's), sharded
  inference, the streamed per-step bank tier, and the headline layout (16
  frames in windows of 30 with an overlap of 8). On the card the ranks share
  the cards round-robin (several ranks on one card, where there is one:
  NCCL refuses two ranks on one device, gloo does not).

    python -c "from mikudance_tpu_torch import graft_entry as g; fn, a = g.entry(); fn(*a)"
    python -c "from mikudance_tpu_torch import graft_entry as g; g.dryrun_multichip(4, 'cpu')"
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def entry(device=None):
    """(fn, args): one flagship forward of the denoising UNet (module
    docstring); ``device=None`` is the card."""
    from .core import loaders
    from .core.configs import DenoisingUNetConfig
    from .core.params import resolve_device
    from .models.unet import bank_keys

    dev = resolve_device(device)
    dtype = torch.bfloat16
    cfg = DenoisingUNetConfig()
    den = loaders.load_denoising(None, use_motion=True, dtype=dtype, device=dev)

    B, T, H, W = 1, 4, 64, 64
    g = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    sample = normal(B, T, H, W, 4)
    ts = torch.zeros((B,), dtype=torch.int32, device=dev)
    ctx = normal(B, 257, 768)
    ch = cfg.unet.block_out_channels
    hw = H * W
    sizes = {f"down_{i}": (hw // 4 ** i, ch[i]) for i in range(3)}
    sizes["mid"] = (hw // 4 ** 3, ch[3])
    sizes.update({f"up_{i}": (hw // 4 ** (3 - i), ch[3 - i]) for i in range(1, 4)})
    banks = {}
    for k in bank_keys(cfg.unet):
        s, c = sizes["mid" if k == "mid" else k.rsplit("_", 1)[0]]
        banks[k] = normal(B * T, s, c)

    @torch.no_grad()
    def fn(sample, ts, ctx, banks):
        return den(sample, ts, ctx, banks=banks)

    return fn, (sample, ts, ctx, banks)


def _rank_device(device) -> torch.device:
    """The rank's device: the CPU, or a card round-robin by rank."""
    import torch.distributed as dist

    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" to run the ranks '
                           'on the CPU')
    dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _dryrun_rank(device, memory_fraction: Optional[float]) -> list:
    """One rank of ``dryrun_multichip``: its phases' report lines."""
    from .core import mesh as mesh_lib
    from .core.configs import (ContextConfig, DenoisingUNetConfig, GuidanceUNetConfig,
                               MotionModuleConfig, PipelineConfig, UNetConfig, VAEConfig)
    from .diffusion.ddim import DDIMSchedule
    from .models.unet import DenoisingUNet, GuidanceUNet
    from .models.vae import Decoder, Encoder
    from .pipelines.video import ModelBundle, VideoPipeline
    from .train.steps import TrainConfig, init_train_state, make_train_step

    dev = _rank_device(device)
    if dev.type == "cuda" and memory_fraction is not None:
        torch.cuda.set_per_process_memory_fraction(memory_fraction, dev)
    mesh = mesh_lib.make_mesh()
    n = mesh.size
    lines = []

    def report(text: str) -> None:
        if mesh.rank == 0:
            print(text, flush=True)
        lines.append(text)

    # the JAX dry run's smallest UNets with every structural case: cross-attention
    # and plain down blocks, mid, up path, motion after every attention, MAN
    # after every down block
    tiny = UNetConfig(block_out_channels=(32, 64, 64), layers_per_block=1, attention_heads=4)

    def models():
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []), \
                torch.device(dev):
            torch.manual_seed(0)
            guide = GuidanceUNet(GuidanceUNetConfig(unet=tiny, use_man=True))
            den = DenoisingUNet(DenoisingUNetConfig(
                unet=tiny, motion=MotionModuleConfig(num_attention_heads=4)))
        return guide, den

    B, T, h, w = n, 2, 8, 8
    rng = np.random.default_rng(0)
    batch = {
        "latents": rng.normal(size=(B, T, h, w, 4)),
        "cond20": rng.normal(size=(B, T, h, w, 20)),
        "motion": rng.normal(size=(B, T, h, w, 2)),
        "clip_ctx": rng.normal(size=(B, 5, 768)),
        "uncond": np.zeros((B,)),
    }
    batch = {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in batch.items()}
    cfg = TrainConfig(trainable_substrings=("motion", "man_"))  # the stage-2 freeze set
    schedule = DDIMSchedule.create(beta_schedule="scaled_linear")

    def train_step(step_mesh):
        state = init_train_state(cfg, *models())
        step = make_train_step(cfg, schedule, state, step_mesh)
        gen = torch.Generator(device=dev).manual_seed(1)
        metrics = step(mesh_lib.shard_train_batch(batch, step_mesh), gen)
        return float(metrics["loss"]), state

    # phase 1: the data-parallel stage-2 step, the batch over 'data'
    loss, state = train_step(mesh)
    if not (np.isfinite(loss) and state.step == 1 and state.optimizer.count == 1):
        raise RuntimeError(f"dryrun_multichip({n}): train step: loss {loss}, step {state.step}")
    report(f"dryrun_multichip({n}): train ok, loss={loss:.4f}")

    # phase 2: sequence parallelism, each clip's frames over 'frame' too; the
    # same batch and draws must give the data-parallel step's loss
    if n % 2 == 0 and T % 2 == 0:
        sp_mesh = mesh_lib.Mesh(np.arange(n).reshape(n // 2, 2),
                                (mesh_lib.DATA_AXIS, mesh_lib.FRAME_AXIS))
        loss_sp, _ = train_step(sp_mesh)
        if not abs(loss_sp - loss) < 1e-4:
            raise RuntimeError(f"dryrun_multichip({n}): sequence-parallel loss {loss_sp} "
                               f"against {loss}")
        report(f"dryrun_multichip({n}): sequence-parallel train ok, mesh={sp_mesh.shape}, "
               f"loss={loss_sp:.4f}")

    # phase 3: sharded inference, the tiny pipeline on a mesh of every rank
    guide, den = models()
    tiny_vae = VAEConfig(block_out_channels=(16, 32, 32, 32), norm_num_groups=8)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []), torch.device(dev):
        torch.manual_seed(0)
        enc, dec = Encoder(tiny_vae).eval(), Decoder(tiny_vae).eval()
    bundle = ModelBundle(guide.eval(), den.eval(), enc, dec)
    Hv = 64
    hv = Hv // 8
    pcfg = PipelineConfig(width=Hv, height=Hv, num_inference_steps=2,
                          context=ContextConfig(frames=4, overlap=2), guidance_clip_mode="cond")

    def request(config, frames):
        pipe = VideoPipeline(bundle, config, device=dev, mesh=mesh)
        video = pipe(rng.uniform(-1, 1, (Hv, Hv, 3)).astype(np.float32),
                     rng.uniform(0, 1, (Hv, Hv, 3)).astype(np.float32),
                     rng.uniform(0, 1, (frames, Hv, Hv, 3)).astype(np.float32),
                     rng.uniform(0, 1, (frames, Hv, Hv, 3)).astype(np.float32),
                     rng.uniform(0, 1, (frames, Hv, Hv, 3)).astype(np.float32),
                     rng.normal(0, 0.1, (frames, hv, hv, 2)).astype(np.float32),
                     rng.normal(0, 1, (1, 5, 768)).astype(np.float32),
                     rng.normal(0, 1, (frames, hv, hv, 4)).astype(np.float32), to_host=True)
        video = np.asarray(video)
        if video.shape != (frames, Hv, Hv, 3) or video.dtype != np.uint8:
            raise RuntimeError(f"dryrun_multichip({n}): video {video.shape} {video.dtype}")
        return video

    video = request(pcfg, 6)
    report(f"dryrun_multichip({n}): sharded inference ok, {video.shape}")

    # phase 4: the streamed (per-step) bank tier: 2-frame windows with an
    # overlap of 1 over max(n, 2) frames, one window group a rank
    Ts = max(n, 2)
    request(dataclasses.replace(pcfg, bank_mode="per_step", cached_bank_positions=4,
                                context=ContextConfig(frames=2, overlap=1)), Ts)
    report(f"dryrun_multichip({n}): sharded STREAMED inference ok")

    # phase 5: the headline layout, 16 frames in one window of 30 / 8
    Th = 16
    request(dataclasses.replace(pcfg, context=ContextConfig(frames=30, overlap=8),
                                bank_mode="cached"), Th)
    report(f"dryrun_multichip({n}): HEADLINE-layout sharded inference ok (T={Th}, nw=1, "
           f"wf={Th})")
    return lines


def dryrun_multichip(n_devices: int, device=None) -> list:
    """Spawn ``n_devices`` gloo ranks and run the dry run's phases on each
    (module docstring); ``device=None`` is the card(s), ``"cpu"`` the CPU.
    Returns rank 0's report lines; raises where a phase fails on any rank."""
    from .core import mesh as mesh_lib

    fraction = None
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device is available; pass device="cpu" to run the '
                               'ranks on the CPU')
        # ranks that share a card each take an equal part of it
        per_card = -(-n_devices // torch.cuda.device_count())
        fraction = 0.9 / per_card
    got = mesh_lib.spawn(n_devices, _dryrun_rank, (device, fraction), timeout=900)
    return got[0]


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), out.dtype)
