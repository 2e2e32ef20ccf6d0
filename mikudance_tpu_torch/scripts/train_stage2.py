"""Stage-2 trainer of the PyTorch port: motion modules + MAN blocks, on clips.

The arguments and the YAML schema of the JAX package's ``scripts/train_stage2.py``
(``configs/train/train_stage2.yaml``), plus ``--device``: loads the stage-1
weights and the motion-module checkpoint, freezes everything except
``motion_modules`` in the denoising UNet and ``man_blocks`` in the guidance
UNet, trains on ``n_sample_frames``-frame clips with per-sample scene motion,
and exports a motion-module-only deployable dict.

    python -m mikudance_tpu_torch.scripts.train_stage2 --config configs/train/train_stage2.yaml
    python -m mikudance_tpu_torch.scripts.train_stage2 --config ... --synthetic 8 --max_steps 2

It runs on the CUDA card; ``--device cpu`` asks for the CPU by name. Weight
files that the YAML names and the disk lacks leave their module at a seeded
random init. Under ``torchrun`` the ranks take a ('data', 'frame') mesh: the
batch over 'data', each clip's frames over 'frame' where the batch does not
fill the ranks (a 20-frame clip of batch 1 on 4 ranks: 5 frames a rank):

    torchrun --nproc-per-node 4 -m mikudance_tpu_torch.scripts.train_stage2 --config ...
    torchrun --nproc-per-node 2 -m mikudance_tpu_torch.scripts.train_stage2 --config ... \
        --synthetic 2 --device cpu
"""

from __future__ import annotations

import os
import random
from typing import Optional, Sequence

import numpy as np
import torch

from . import _train_common as common


def synthetic_batches(bs: int, T: int, size: int, steps: int):
    rng = np.random.default_rng(0)
    h = size // 8
    for _ in range(steps):
        yield {
            "tgt_vdo": rng.uniform(-1, 1, (bs, T, size, size, 3)).astype(np.float32),
            "tgt_pose": rng.uniform(0, 1, (bs, T, size, size, 3)).astype(np.float32),
            "tgt_face": rng.uniform(0, 1, (bs, T, size, size, 3)).astype(np.float32),
            "tgt_hand": rng.uniform(0, 1, (bs, T, size, size, 3)).astype(np.float32),
            "scene_motion": rng.normal(0, 0.1, (bs, T, h, h, 2)).astype(np.float32),
            "ref_img": rng.uniform(-1, 1, (bs, size, size, 3)).astype(np.float32),
            "ref_skel_img": rng.uniform(0, 1, (bs, size, size, 3)).astype(np.float32),
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
    size = int(data_cfg.get("train_width", 576))
    bs = int(data_cfg.get("train_bs", 1))
    T = int(data_cfg.get("n_sample_frames", 20))
    h = size // 8
    dtype = common.compute_dtype(solver)
    unet_cfg = common.unet_overrides(cfg)

    # per-block rematerialisation defaults to on, as in the JAX trainer
    remat = bool(solver.get("gradient_checkpointing", True))
    ref_path = cfg.get("stage1_reference_unet")
    den_path = cfg.get("stage1_denoising_unet")
    if cfg.get("stage1_ckpt_dir"):  # {dir}/{denoising,reference}_unet-{step}.pth
        step1 = cfg.get("stage1_ckpt_step", 120000)
        ref_path = ref_path or os.path.join(cfg["stage1_ckpt_dir"],
                                            f"reference_unet-{step1}.pth")
        den_path = den_path or os.path.join(cfg["stage1_ckpt_dir"],
                                            f"denoising_unet-{step1}.pth")
    # the UNets load in fp32 (the optimizer's master copies come from these
    # values) and are cast to the compute dtype by train_loop
    guide = loaders.load_guidance(ref_path, use_man=True, device=device, unet_config=unet_cfg,
                                  remat=remat)
    den = loaders.load_denoising(den_path, cfg.get("mm_path"), use_motion=True, device=device,
                                 unet_config=unet_cfg, remat=remat)
    vae_enc, vae_dec = loaders.load_vae(cfg.get("vae_model_path"), dtype=dtype, device=device)
    clip = loaders.load_clip(cfg.get("image_encoder_path"), dtype=dtype, device=device)
    enc = make_encoder_fns(vae_enc, clip)
    schedule = common.make_schedule(cfg)
    tcfg = common.make_train_config(cfg, bs, ("motion", "man_"))
    enc_gen = torch.Generator(device=device).manual_seed(int(cfg.get("seed", 186)))

    def dev(x):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    def prepare_batch(batch, host_rng: random.Random):
        B = batch["tgt_vdo"].shape[0]

        def flat(x):  # (B, T, H, W, C) -> (B*T, H, W, C)
            a = dev(x)
            return a.reshape((-1,) + tuple(a.shape[2:]))

        def unflat(x):
            return x.reshape((B, T) + tuple(x.shape[1:]))

        lat = enc.vae_encode_sample(enc_gen, flat(batch["tgt_vdo"]))
        pose_l, face_l, hand_l = (enc.vae_encode_mean(flat(batch[k]))
                                  for k in ("tgt_pose", "tgt_face", "tgt_hand"))
        rs = enc.vae_encode_mean(torch.cat([dev(batch["ref_img"]), dev(batch["ref_skel_img"])]))
        ref_rep = rs[:B, None].expand((B, T) + tuple(rs.shape[1:]))
        skel_rep = rs[B:, None].expand((B, T) + tuple(rs.shape[1:]))
        cond20 = torch.cat([ref_rep, skel_rep, unflat(pose_l), unflat(face_l), unflat(hand_l)],
                           dim=-1)
        ctx = enc.clip_encode(dev(batch["clip_img"]))
        uncond = float(host_rng.random() < tcfg.uncond_ratio)
        return {
            "latents": unflat(lat).float(),
            "cond20": cond20.float(),
            "motion": torch.as_tensor(batch["scene_motion"]).to(device=device,
                                                                dtype=torch.float32),
            "clip_ctx": ctx.float(),
            "uncond": torch.full((B,), uncond, device=device),
        }

    exp_name = cfg.get("exp_name", "train_stage2_mikudance")
    out_dir = os.path.join(cfg.get("output_dir", "./train_output"), exp_name)
    max_steps = args.max_steps or int(solver.get("max_train_steps", 60000))
    first = common.FirstBatch()

    if args.synthetic:
        batches = first.capture(synthetic_batches(bs, T, size, args.synthetic))
    else:
        import json

        from ..data.datasets import AnimeVideoDataset, PrefetchLoader, VideoSample

        with open(cfg["data_manifest"]) as f:
            manifest = json.load(f)
        ds = AnimeVideoDataset(
            [VideoSample(**s) for s in manifest], img_size=(size, size), n_sample_frames=T,
            sample_rate=int(data_cfg.get("sample_rate", 3)),
            drop_ratio=float(data_cfg.get("drop_ratio", 0.1)),
            drop_vdo_ratio=float(data_cfg.get("drop_vdo_ratio", 0.1)))
        loader = PrefetchLoader(ds, bs)
        batches = lambda: first.capture(iter(loader))  # noqa: E731 - one pass an epoch

    def validation_fn(step, state):
        """The video pipeline with the current weights on the first batch;
        saves poses | result as a GIF."""
        if first.batch is None:
            return None
        from ..core.configs import ContextConfig, PipelineConfig
        from ..pipelines.video import ModelBundle, VideoPipeline
        from ..utils.media import save_video_grid

        b = first.batch
        pcfg = PipelineConfig(width=size, height=size, num_inference_steps=4,
                              guidance_scale=3.5,
                              context=ContextConfig(frames=min(T, 30), overlap=4),
                              guidance_clip_mode="cond")
        pipe = VideoPipeline(ModelBundle(state.guide, state.den, vae_enc, vae_dec), pcfg,
                             device=device)
        ctx = enc.clip_encode(dev(b["clip_img"][:1])).float().cpu().numpy()
        noise = np.random.default_rng(0).normal(size=(T, h, h, 4)).astype(np.float32)
        video = pipe(b["ref_img"][0], b["ref_skel_img"][0], b["tgt_pose"][0], b["tgt_face"][0],
                     b["tgt_hand"][0], b["scene_motion"][0], ctx, noise, to_host=True)
        path = os.path.join(out_dir, "validation", f"step_{step}.gif")
        save_video_grid([b["tgt_pose"][0], np.asarray(video, np.float32) / 255.0], path, fps=8)
        print(f"validation gif: {path}")
        return path

    def export_fn(step, state):
        den_sd = state.den.state_dict()
        ckpt_lib.export_params(ckpt_lib.filter_by_substring(den_sd, ("motion",)),
                               os.path.join(out_dir, f"motion_module-{step}.pth"))
        ckpt_lib.export_params(state.guide.state_dict(),
                               os.path.join(out_dir, f"reference_unet-{step}.pth"))
        ckpt_lib.export_params(den_sd, os.path.join(out_dir, f"denoising_unet-{step}.pth"))

    return train_loop(
        cfg=tcfg, schedule=schedule, guide=guide, den=den, batches=batches,
        prepare_batch=prepare_batch, max_steps=max_steps, output_dir=out_dir,
        run_name=exp_name, checkpointing_steps=int(cfg.get("checkpointing_steps", 3000)),
        log_every=int(cfg.get("log_every", 10)), seed=int(cfg.get("seed", 186)),
        export_fn=export_fn,
        save_model_steps=int(cfg.get("save_model_step_interval", 3000)),
        save_model_epochs=int(cfg.get("save_model_epoch_interval", 0)),
        validation_fn=validation_fn, validation_steps=common.validation_steps(cfg),
        # several ranks: the batch over 'data' and each clip's frames over
        # 'frame' (sequence parallelism, core/mesh.py::choose_train_mesh)
        batch_size=bs,
        clip_frames=T,
        # the frozen SD weights are stored in the compute dtype; fp32 master
        # copies exist only for the trained tensors (train/steps.py)
        frozen_dtype=dtype,
    )


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
