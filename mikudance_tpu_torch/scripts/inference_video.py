"""Video inference CLI of the PyTorch port: the arguments of the reference
(`scripts/inference_video.py:29-45`: --config -W -H --seed --cfg --steps --fps
--video_decoder, plus -L and --output) over the same YAML schema
(`configs/inference/inference_video.yaml`), and ``--device``.

    python -m mikudance_tpu_torch.scripts.inference_video \\
        --config configs/inference/inference_video.yaml -W 768 -H 768 --steps 20

It runs on the CUDA card; ``--device cpu`` asks for the CPU by name. Weight
files that the YAML names and the disk lacks leave their module at random
init ("smoke mode"), so the whole path can be driven without checkpoints. A
clip longer than one 30-frame window takes the long-clip bank tiers of
``VideoPipeline`` by itself (``PipelineConfig.bank_mode = "auto"``).

On N cards, one process a card:

    torchrun --nproc-per-node N -m mikudance_tpu_torch.scripts.inference_video \\
        --config configs/inference/inference_video.yaml

Under ``torchrun`` (``WORLD_SIZE`` > 1) the ranks join a process group (NCCL,
card ``LOCAL_RANK``; gloo with ``--device cpu``), every rank loads the same
weights and runs the same request over a mesh of all of them (the JAX CLI's
multi-device path), and rank 0 alone writes the video.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("-W", type=int, default=768)
    p.add_argument("-H", type=int, default=768)
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--cfg", type=float, default=3.5)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--fps", type=int)
    p.add_argument("--video_decoder", action="store_true",
                   help="Use the temporal VAE decoder (less flicker, slower).")
    p.add_argument("-L", type=int, default=None, help="limit number of frames")
    p.add_argument("--output", default=None)
    p.add_argument("--device", default=None,
                   help='where to run; default: the CUDA card (an error where there is '
                        'none); "cpu" runs on the CPU')
    return p.parse_args(argv)


def _opt(cfg, key):
    v = cfg.get(key)
    return None if v in (None, "None", "") else v


def read_inference_config(path: str):
    """The reference's ``inference_config:`` indirection (mikudance_config.yaml:
    motion-module kwargs, scheduler kwargs, sampler) -> (MotionModuleConfig,
    SchedulerConfig). Absent keys keep the dataclass defaults, which are the
    released checkpoints' settings; variants the released checkpoints never
    use, and the package does not build, fail loudly."""
    import yaml

    from ..core.configs import MotionModuleConfig, SchedulerConfig

    with open(path) as f:
        icfg = yaml.safe_load(f) or {}
    ua = icfg.get("unet_additional_kwargs", {})
    if ua.get("unet_use_cross_frame_attention") or ua.get("unet_use_temporal_attention"):
        raise NotImplementedError("cross-frame / temporal attention UNet variants are not "
                                  "built (off in every reference config)")
    if ua.get("motion_module_type", "Vanilla") != "Vanilla":
        raise NotImplementedError("only the Vanilla motion module exists")
    if not ua.get("use_inflated_groupnorm", True):
        raise NotImplementedError("per-frame (non-inflated) GroupNorm is the only lowering here")
    mk = ua.get("motion_module_kwargs", {})
    motion_cfg = MotionModuleConfig(
        enabled=bool(ua.get("use_motion_module", True)),
        num_attention_heads=int(mk.get("num_attention_heads", 8)),
        num_transformer_blocks=int(mk.get("num_transformer_block", 1)),
        attention_layers_per_block=len(
            mk.get("attention_block_types", ["Temporal_Self", "Temporal_Self"])),
        temporal_position_encoding=bool(mk.get("temporal_position_encoding", True)),
        temporal_position_encoding_max_len=int(
            mk.get("temporal_position_encoding_max_len", 32)),
        resolutions=tuple(ua.get("motion_module_resolutions", (1, 2, 4, 8))),
        mid_block=bool(ua.get("motion_module_mid_block", True)),
        decoder_only=bool(ua.get("motion_module_decoder_only", False)),
    )
    nk = icfg.get("noise_scheduler_kwargs", {})
    d = SchedulerConfig()
    sched_cfg = SchedulerConfig(
        beta_start=float(nk.get("beta_start", d.beta_start)),
        beta_end=float(nk.get("beta_end", d.beta_end)),
        beta_schedule=nk.get("beta_schedule", d.beta_schedule),
        prediction_type=nk.get("prediction_type", d.prediction_type),
        rescale_betas_zero_snr=bool(nk.get("rescale_betas_zero_snr", d.rescale_betas_zero_snr)),
        timestep_spacing=nk.get("timestep_spacing", d.timestep_spacing),
    )
    sampler = icfg.get("sampler", "DDIM")
    if sampler != "DDIM":
        raise ValueError(f"only the DDIM sampler is supported, got {sampler!r}")
    return motion_cfg, sched_cfg


def main(argv: Optional[Sequence[str]] = None) -> Optional[str]:
    """Runs one request; returns the path of the video it wrote (None on a
    rank other than 0)."""
    import yaml

    from ..core import loaders
    from ..core import mesh as mesh_lib
    from ..core.configs import ContextConfig, PipelineConfig
    from ..core.params import resolve_device
    from ..pipelines.scene_motion import scene_motion_flow
    from ..pipelines.video import ModelBundle, VideoPipeline
    from ..utils import media

    args = parse_args(argv)
    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    # several processes under torchrun: one process group, one device a rank
    device = mesh_lib.init_from_env(args.device) or resolve_device(args.device)
    mesh = mesh_lib.make_mesh() if torch.distributed.is_initialized() else None
    writer = mesh is None or mesh.rank == 0

    width, height = args.W, args.H
    assert width % 8 == 0 and height % 8 == 0, "W/H must be divisible by 8 (f8 VAE)"
    h, w = height // 8, width // 8
    dtype = (torch.bfloat16 if cfg.get("weight_dtype", "fp16") in ("fp16", "bf16")
             else torch.float32)

    # ------------------------------------------------------------- conditions
    tgt_pose = _opt(cfg, "tgt_pose_path")
    if tgt_pose is None:
        raise ValueError("Target pose is required!")
    pose_pils = media.read_frames(tgt_pose)
    src_fps = media.get_fps(tgt_pose)
    if args.L:
        pose_pils = pose_pils[: args.L]
    T = len(pose_pils)
    print(f"Total frames: {T}")

    # absent face/hand streams stay None: the pipeline encodes a single black
    # frame and broadcasts its latent (the reference's black-video fallback)
    face_path, hand_path = _opt(cfg, "tgt_face_path"), _opt(cfg, "tgt_hand_path")
    face_pils = media.read_frames(face_path)[:T] if face_path else None
    hand_pils = media.read_frames(hand_path)[:T] if hand_path else None

    w2c_path, c2w_path = _opt(cfg, "tgt_w2c_path"), _opt(cfg, "tgt_c2w_path")
    if w2c_path and c2w_path:
        w2c, c2w = np.load(w2c_path)[:T], np.load(c2w_path)[:T]
    else:
        w2c = c2w = np.tile(np.eye(4)[None], (T, 1, 1))
    depth_path = _opt(cfg, "ref_depth_path")
    depth = np.load(depth_path) if depth_path else np.zeros((1, height, width), np.float32)
    motion = scene_motion_flow(w2c, c2w, media.resize_depth(depth, h, w), device=device)

    ref_pil = media.load_image(cfg["ref_image_path"])
    skel_pil = media.load_image(cfg["ref_skel_path"])
    # uint8 end to end: the pipeline scales on the device
    ref = media.to_u8_frame(ref_pil, height, width)
    skel = media.to_u8_frame(skel_pil, height, width)
    pose = media.frames_to_u8(pose_pils, height, width)
    face = media.frames_to_u8(face_pils, height, width) if face_pils else None
    hand = media.frames_to_u8(hand_pils, height, width) if hand_pils else None

    # ------------------------------------------------------------- models
    ref_path = _opt(cfg, "reference_unet_path")
    sd_dir = _opt(cfg, "pretrained_base_model_path")
    sd_unet = os.path.join(sd_dir, "unet") if sd_dir else None
    sd_unet_file = loaders._find_weights(sd_unet) if sd_unet and os.path.isdir(sd_unet) else None
    if not (ref_path and os.path.exists(ref_path)):
        print("WARNING: reference_unet weights not found -> random init (smoke mode)")

    motion_cfg, sched_cfg = None, None
    icfg_path = _opt(cfg, "inference_config")
    if icfg_path and os.path.exists(icfg_path):
        motion_cfg, sched_cfg = read_inference_config(icfg_path)

    on = dict(dtype=dtype, device=device)
    guide = loaders.load_guidance(ref_path, use_man=True, **on)
    den = loaders.load_denoising(_opt(cfg, "denoising_unet_path"),
                                 _opt(cfg, "motion_module_path"), sd_unet_file,
                                 use_motion=True, motion_config=motion_cfg, **on)
    enc, dec = loaders.load_vae(_opt(cfg, "pretrained_vae_path"), **on)
    clip = loaders.load_clip(_opt(cfg, "image_encoder_path"), **on)
    if args.video_decoder:
        dec = loaders.load_temporal_decoder(_opt(cfg, "pretrained_temporal_vae_path"), **on)

    pcfg = PipelineConfig(
        width=width, height=height, num_inference_steps=args.steps,
        guidance_scale=args.cfg, context=ContextConfig(frames=30, overlap=8),
        **({"scheduler": sched_cfg} if sched_cfg else {}),
    )
    pipe = VideoPipeline(ModelBundle(guide, den, enc, dec, clip), pcfg, device=device,
                         mesh=mesh)

    clip_ctx = pipe.clip_context(ref_pil)
    # torch's CPU generator, for bit-parity with the reference's randn_tensor
    noise_ref = media.torch_seed_noise(args.seed, (1, 4, T, h, w), dtype_half=True)
    noise = np.moveaxis(noise_ref[0], 0, -1)  # (T, h, w, 4)

    video = pipe(ref, skel, pose, face, hand, motion, clip_ctx, noise, to_host=True)
    if not writer:  # every rank holds the video; rank 0 writes it
        return None

    # ------------------------------------------------------------- save
    out = args.output
    if out is None:
        now = datetime.now()
        date_str, time_str = now.strftime("%Y%m%d"), now.strftime("%H%M%S")
        out_dir = Path(f"output/{date_str}/{time_str}--seed_{args.seed}-{width}x{height}")
        out = str(out_dir / (f"{Path(tgt_pose).stem}_{Path(cfg['ref_image_path']).stem}_"
                             f"{height}x{width}_{int(args.cfg)}_{time_str}.mp4"))
    # the grid writer wants float [0, 1]: reference picture, poses, result
    ref_row = np.tile((ref.astype(np.float32) / 255.0)[None], (T, 1, 1, 1))
    media.save_video_grid([ref_row, pose.astype(np.float32) / 255.0,
                           video.astype(np.float32) / 255.0], out, fps=args.fps or src_fps)
    print(f"saved: {out}")
    return out


if __name__ == "__main__":
    main()
