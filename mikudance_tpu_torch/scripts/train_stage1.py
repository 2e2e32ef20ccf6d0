"""Stage-1 trainer of the PyTorch port: both UNets, single frames.

The arguments and the YAML schema of the JAX package's ``scripts/train_stage1.py``
(``configs/train/train_stage1.yaml``), plus ``--device``: the guidance UNet
without MAN and the denoising UNet without motion modules train fully on
single-frame samples; the frozen VAE and CLIP tower prepare each batch on the
device.

    python -m mikudance_tpu_torch.scripts.train_stage1 --config configs/train/train_stage1.yaml
    python -m mikudance_tpu_torch.scripts.train_stage1 --config ... --synthetic 8 --max_steps 2

It runs on the CUDA card; ``--device cpu`` asks for the CPU by name. Weight
files that the YAML names and the disk lacks leave their module at a seeded
random init. Under ``torchrun`` the ranks split the batch over a 'data' mesh
(``train_bs`` a multiple of the ranks) and shard the optimizer state
(``solver.optimizer_state_sharding``, default on):

    torchrun --nproc-per-node 8 -m mikudance_tpu_torch.scripts.train_stage1 --config ...
    torchrun --nproc-per-node 2 -m mikudance_tpu_torch.scripts.train_stage1 --config ... \
        --synthetic 2 --device cpu
"""

from __future__ import annotations

import os
import random
from typing import Optional, Sequence

import numpy as np
import torch

from . import _train_common as common


def synthetic_batches(bs: int, size: int, steps: int):
    rng = np.random.default_rng(0)
    for _ in range(steps):
        yield {
            "ref_img": rng.uniform(-1, 1, (bs, size, size, 3)).astype(np.float32),
            "tgt_img": rng.uniform(-1, 1, (bs, size, size, 3)).astype(np.float32),
            "ref_skel_img": rng.uniform(0, 1, (bs, size, size, 3)).astype(np.float32),
            "tgt_pose_img": rng.uniform(0, 1, (bs, size, size, 3)).astype(np.float32),
            "tgt_face_img": rng.uniform(0, 1, (bs, size, size, 3)).astype(np.float32),
            "tgt_hand_img": rng.uniform(0, 1, (bs, size, size, 3)).astype(np.float32),
            "clip_img": rng.normal(0, 1, (bs, 224, 224, 3)).astype(np.float32),
        }


def main(argv: Optional[Sequence[str]] = None):
    """Returns the final ``TrainState``."""
    args = common.parse_args(__doc__, argv)
    cfg = common.read_yaml(args.config)

    from ..core import loaders
    from ..core import mesh as mesh_lib
    from ..core.params import resolve_device
    from ..train import checkpoint as ckpt_lib
    from ..train.runner import make_encoder_fns, train_loop

    # under torchrun: one rank a card over NCCL, or gloo ranks with --device cpu
    device = mesh_lib.init_from_env(args.device) or resolve_device(args.device)
    data_cfg = cfg.get("data", {})
    solver = cfg.get("solver", {})
    size = int(data_cfg.get("train_width", 768))
    bs = int(data_cfg.get("train_bs", 8))
    dtype = common.compute_dtype(solver)
    unet_cfg = common.unet_overrides(cfg)

    # the UNets load in fp32 (the optimizer's master copies come from these
    # values) and are cast to the compute dtype by train_loop
    remat = bool(solver.get("gradient_checkpointing", False))
    guide = loaders.load_guidance(cfg.get("pretrained_reference_unet"), use_man=False,
                                  device=device, unet_config=unet_cfg, remat=remat)
    den = loaders.load_denoising(cfg.get("pretrained_denoising_unet"), use_motion=False,
                                 device=device, unet_config=unet_cfg, remat=remat)
    vae_enc, vae_dec = loaders.load_vae(cfg.get("vae_model_path"), dtype=dtype, device=device)
    clip = loaders.load_clip(cfg.get("image_encoder_path"), dtype=dtype, device=device)
    enc = make_encoder_fns(vae_enc, clip)
    schedule = common.make_schedule(cfg)
    tcfg = common.make_train_config(cfg, bs, None)  # stage 1 trains both UNets fully
    enc_gen = torch.Generator(device=device).manual_seed(int(cfg.get("seed", 186)))

    def dev(x):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    def prepare_batch(batch, host_rng: random.Random):
        lat = enc.vae_encode_sample(enc_gen, dev(batch["tgt_img"]))
        conds = torch.cat([dev(batch[k]) for k in
                           ("ref_img", "ref_skel_img", "tgt_pose_img", "tgt_face_img",
                            "tgt_hand_img")], dim=0)
        cond_lat = enc.vae_encode_mean(conds)
        B = lat.shape[0]
        cond20 = torch.cat([cond_lat[i * B:(i + 1) * B] for i in range(5)], dim=-1)
        ctx = enc.clip_encode(dev(batch["clip_img"]))
        uncond = float(host_rng.random() < tcfg.uncond_ratio)  # batch-level flip
        return {
            "latents": lat[:, None].float(),
            "cond20": cond20[:, None].float(),
            "motion": torch.zeros((B, 1) + tuple(cond20.shape[1:3]) + (2,), device=device),
            "clip_ctx": ctx.float(),
            "uncond": torch.full((B,), uncond, device=device),
        }

    exp_name = cfg.get("exp_name", "train_stage1_mikudance")
    out_dir = os.path.join(cfg.get("output_dir", "./train_output"), exp_name)
    max_steps = args.max_steps or int(solver.get("max_train_steps", 120000))
    first = common.FirstBatch()

    if args.synthetic:
        batches = first.capture(synthetic_batches(bs, size, args.synthetic))
    else:
        import json

        from ..data.datasets import AnimeImageDataset, ImageSample, PrefetchLoader

        with open(cfg["data_manifest"]) as f:
            manifest = json.load(f)
        ds = AnimeImageDataset(
            [ImageSample(**s) for s in manifest], img_size=(size, size),
            drop_ratio=float(data_cfg.get("drop_ratio", 0.1)),
            style_ratio=float(data_cfg.get("style_ratio", 0.01)))
        loader = PrefetchLoader(ds, bs)
        batches = lambda: first.capture(iter(loader))  # noqa: E731 - one pass an epoch

    def validation_fn(step, state):
        """The stage-1 image pipeline with the current weights on the first
        batch; saves reference | pose | result side by side."""
        if first.batch is None:
            return None
        from PIL import Image

        from ..core.configs import PipelineConfig
        from ..pipelines.image import ImagePipeline
        from ..pipelines.video import ModelBundle

        b = first.batch
        pipe = ImagePipeline(ModelBundle(state.guide, state.den, vae_enc, vae_dec),
                             PipelineConfig(width=size, height=size, num_inference_steps=4,
                                            guidance_scale=3.5), device=device)
        ctx = enc.clip_encode(dev(b["clip_img"][:1])).float().cpu().numpy()
        noise = np.random.default_rng(0).normal(size=(1, size // 8, size // 8, 4))
        img = pipe(b["ref_img"][0], b["ref_skel_img"][0], b["tgt_pose_img"][0],
                   b["tgt_face_img"][0], b["tgt_hand_img"][0], ctx, noise.astype(np.float32))
        img = np.asarray(torch.as_tensor(img).cpu())[0]
        ref_u8 = ((b["ref_img"][0] + 1) * 127.5).clip(0, 255).astype(np.uint8)
        pose_u8 = (b["tgt_pose_img"][0] * 255).clip(0, 255).astype(np.uint8)
        path = os.path.join(out_dir, "validation", f"step_{step}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(np.concatenate([ref_u8, pose_u8, img], axis=1)).save(path)
        print(f"validation image: {path}")
        return path

    def export_fn(step, state):
        ckpt_lib.export_params(state.guide.state_dict(),
                               os.path.join(out_dir, f"reference_unet-{step}.pth"))
        ckpt_lib.export_params(state.den.state_dict(),
                               os.path.join(out_dir, f"denoising_unet-{step}.pth"))

    return train_loop(
        cfg=tcfg, schedule=schedule, guide=guide, den=den, batches=batches,
        prepare_batch=prepare_batch, max_steps=max_steps, output_dir=out_dir,
        run_name=exp_name, checkpointing_steps=int(cfg.get("checkpointing_steps", 3000)),
        log_every=int(cfg.get("log_every", 10)), seed=int(cfg.get("seed", 186)),
        export_fn=export_fn,
        save_model_epochs=int(cfg.get("save_model_epoch_interval", 0)),
        save_model_steps=int(cfg.get("save_model_step_interval", 3000)),
        validation_fn=validation_fn, validation_steps=common.validation_steps(cfg),
        frozen_dtype=dtype,
        # stage 1 trains both UNets (~1.7B parameters): on several ranks the
        # fp32 master copies and Adam moments shard over 'data' (ZeRO)
        zero_shard=bool(solver.get("optimizer_state_sharding", True)),
    )


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
