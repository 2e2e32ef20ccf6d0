"""Model / pipeline configuration dataclasses.

Mirrors the architecture hyperparameters of the reference models:
- SD1.5 UNet geometry: `reference src/models/unet_3d_mix.py:38-88`
  (block_out_channels (320,640,1280,1280), layers_per_block 2, heads 8,
  cross_attention_dim 768 for the CLIP-image conditioned variant).
- Guidance ("MIX") UNet: 20-channel conv_in (in_channels*5), MAN blocks after
  every down block (`reference src/models/unet_2d_mix.py:321-326,556-557`).
- Motion module kwargs: `reference configs/inference/mikudance_config.yaml:14-22`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    heads: int = 8
    # head_dim is derived per-block: channels // heads


@dataclasses.dataclass(frozen=True)
class MotionModuleConfig:
    enabled: bool = True
    num_attention_heads: int = 8
    num_transformer_blocks: int = 1
    attention_layers_per_block: int = 2  # ("Temporal_Self", "Temporal_Self")
    temporal_position_encoding: bool = True
    temporal_position_encoding_max_len: int = 32
    zero_initialize: bool = True
    resolutions: Tuple[int, ...] = (1, 2, 4, 8)
    mid_block: bool = True
    decoder_only: bool = False


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Shared SD1.5-geometry UNet configuration."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # down block i has cross-attention iff i < num_blocks - 1 (SD1.5: 3x CrossAttn + 1 plain)
    cross_attention_dim: int = 768
    attention_heads: int = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0

    @property
    def num_blocks(self) -> int:
        return len(self.block_out_channels)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclasses.dataclass(frozen=True)
class GuidanceUNetConfig:
    """Reference/guidance encoder: 20-ch conv_in, optional MAN blocks.

    `use_man=True` is the stage-2 "MIX" variant (`unet_2d_mix.py`);
    `use_man=False` is the stage-1 "MIX_CHAR" variant (`unet_2d_mix_char.py`).
    """

    unet: UNetConfig = UNetConfig()
    cond_channels: int = 20  # in_channels * 5
    motion_channels: int = 2  # trailing scene-motion channels (MIX only)
    use_man: bool = True
    man_hidden: int = 128


@dataclasses.dataclass(frozen=True)
class DenoisingUNetConfig:
    unet: UNetConfig = UNetConfig()
    motion: MotionModuleConfig = MotionModuleConfig()


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """SD KL autoencoder (sd-vae-ft-mse geometry)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT-L/14 vision tower with projection (sd-image-variations encoder)."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"  # inference; training uses "scaled_linear"
    prediction_type: str = "v_prediction"
    rescale_betas_zero_snr: bool = True
    timestep_spacing: str = "trailing"


@dataclasses.dataclass(frozen=True)
class ContextConfig:
    """Sliding-window scheduler params (`pipeline_mikudance.py:383-387`)."""

    frames: int = 30
    stride: int = 1
    overlap: int = 8
    batch_size: int = 1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    width: int = 768
    height: int = 768
    num_inference_steps: int = 20
    guidance_scale: float = 3.5
    context: ContextConfig = ContextConfig()
    scheduler: SchedulerConfig = SchedulerConfig()
    # "reference_inference": replicate the reference pipeline's CLIP-embed
    # tiling for the guidance UNet (pipeline_mikudance.py:646 repeats the
    # [uncond, cond] pair f times, so window position k gets the uncond embed
    # for even k). "cond": every frame gets the cond embed (training behavior).
    guidance_clip_mode: str = "reference_inference"
    # Post-hoc latent frame-rate upsampling (`pipeline_mikudance.py:688`):
    # inserts 2^(factor-1)-1 slerp/lerp latents between consecutive frames.
    # factor=1 is the no-op (the reference's effective default).
    interpolation_factor: int = 1
    interpolation_mode: str = "slerp"
    # Reference-attention bank residency. "cached" computes every (window,
    # position) bank once and keeps all of them on the device for the whole
    # denoise loop. "per_step" recomputes banks inside the loop in window
    # groups (the reference's own memory behavior,
    # `pipeline_mikudance.py:647-653`). "auto" picks cached while
    # nw*wf <= cached_bank_positions, else per_step. "cached_q8" caches every
    # position's banks as int8 + per-position fp32 scales. The port runs the
    # cached path; the others raise NotImplementedError (ROADMAP Queue 1, 8).
    bank_mode: str = "auto"  # "auto" | "cached" | "per_step" | "cached_q8"
    cached_bank_positions: int = 64
    # per-UNet-call frame cap: past this many (window, frame) positions the
    # JAX package scans window groups (not yet ported, ROADMAP Queue 1, 8)
    max_denoise_frame_batch: int = 32
    # Cap on denoiser-UNet frame-passes per device program in the JAX
    # package's grouped denoise; kept so configs stay interchangeable.
    max_exec_frame_passes: int = 640


SD15_UNET = UNetConfig()
GUIDANCE_MIX = GuidanceUNetConfig(use_man=True)
GUIDANCE_MIX_CHAR = GuidanceUNetConfig(use_man=False)
DENOISING_3D = DenoisingUNetConfig()
DENOISING_2D = DenoisingUNetConfig(motion=MotionModuleConfig(enabled=False))
