"""Model / pipeline configuration dataclasses.

Mirrors the architecture hyperparameters of the reference models:
- SD1.5 UNet geometry: `reference src/models/unet_3d_mix.py:38-88`
  (block_out_channels (320,640,1280,1280), layers_per_block 2, heads 8,
  cross_attention_dim 768 for the CLIP-image conditioned variant).
- Guidance ("MIX") UNet: 20-channel conv_in (in_channels*5), MAN blocks after
  every down block (`reference src/models/unet_2d_mix.py:321-326,556-557`).
- Motion module kwargs: `reference configs/inference/mikudance_config.yaml:14-22`.
- SDXL UNet geometry (``SDXL_UNET``): ``stabilityai/stable-diffusion-xl-base-1.0``
  ``unet/config.json`` (block_out_channels (320, 640, 1280), no spatial
  attention at level 0, transformer_layers_per_block (1, 2, 10) with a
  10-deep mid block, attention_head_dim (5, 10, 20) read as head counts,
  cross_attention_dim 2048, linear projections, "text_time" added
  conditioning); the AnimateDiff SDXL motion adapter's modules at all three
  levels and none in the mid block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


# SDXL's time ids: original height and width, crop top and left, target
# height and width
ADDITION_TIME_IDS = 6


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
    # the levels that hold motion modules, as downsampling factors (level i
    # is 2^i): SD1.5's four, SDXL's (1, 2, 4)
    resolutions: Tuple[int, ...] = (1, 2, 4, 8)
    mid_block: bool = True
    decoder_only: bool = False


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Shared UNet configuration; the defaults are SD1.5's geometry."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_heads: int = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    # heads of each level's spatial transformers (SDXL's attention_head_dim,
    # which counts heads); None: attention_heads at every level
    level_heads: Optional[Tuple[int, ...]] = None
    # the levels whose down and up blocks hold spatial transformers; None:
    # every level but the last (SD1.5: 3x CrossAttn + 1 plain)
    attention_levels: Optional[Tuple[int, ...]] = None
    # transformer blocks a spatial transformer stacks, by level (None: one);
    # the mid block's stacks as many as the last level's
    transformer_layers: Optional[Tuple[int, ...]] = None
    # Transformer2DModel's proj_in / proj_out as Linear (SDXL) or 1x1 Conv2d
    use_linear_projection: bool = False
    # SDXL's "text_time" added conditioning: the ADDITION_TIME_IDS time ids,
    # each a sinusoid of addition_time_embed_dim, after a pooled vector,
    # projected from projection_class_embeddings_input_dim to the time
    # embedding; None: none
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816

    @property
    def num_blocks(self) -> int:
        return len(self.block_out_channels)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def heads(self, level: int) -> int:
        return self.attention_heads if self.level_heads is None else self.level_heads[level]

    def has_attention(self, level: int) -> bool:
        if self.attention_levels is None:
            return level < self.num_blocks - 1
        return level in self.attention_levels

    def depth(self, level: int) -> int:
        """Transformer blocks a spatial transformer of ``level`` stacks."""
        return 1 if self.transformer_layers is None else self.transformer_layers[level]

    @property
    def pooled_dim(self) -> int:
        """Width of the added conditioning's pooled vector (SDXL: 1280)."""
        return self.projection_class_embeddings_input_dim - \
            ADDITION_TIME_IDS * self.addition_time_embed_dim


def unet_config(u) -> UNetConfig:
    """``u`` as the port's ``UNetConfig``: a UNet configuration of the JAX
    package (SD1.5's fields, without SDXL's) takes the defaults of the fields
    it lacks."""
    if isinstance(u, UNetConfig):
        return u
    return UNetConfig(**{f.name: getattr(u, f.name) for f in dataclasses.fields(UNetConfig)
                         if hasattr(u, f.name)})


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
    # nw*wf <= cached_bank_positions, else per_step. "cached_q8" caches one
    # int8 bank (+ per-position fp32 scales) per unique (frame, CLIP-context
    # variant) and denoises in window groups.
    # Both budgets below are sized for one 80 GB card at 768^2 in bf16, from
    # peak torch.cuda.max_memory_allocated of one-step requests of 16 to 74
    # frames (`python3 chip_smoke.py --budgets` on an NVIDIA H100 80GB HBM3,
    # 700.00 W; the fits are in PERF.md); shorter sides need less.
    #
    # How many (window, position) banks "auto" caches, the group budget of
    # "per_step" and the guidance-UNet chunk of "cached_q8", counted in
    # positions of SD1.5's banks at the clip's size: the budget in bytes is
    # this many times the bytes of an SD1.5 position's banks, and a UNet whose
    # positions hold more bytes (SDXL's, 2.3x at one size) gets that many fewer, so
    # that every SD1.5 decision stays as it was (``bank_position_budget``).
    # What it bounds
    # is the guidance UNet's batch: 4.4 GiB + 0.164 GiB a position (6.99 GiB
    # at 16 positions, 23.99 GiB at 120), so 192 positions, six 30-frame
    # windows, take about 36 GiB, under half the card; the cached raw banks
    # themselves are 0.051 GiB a position.
    bank_mode: str = "auto"  # "auto" | "cached" | "per_step" | "cached_q8"
    cached_bank_positions: int = 192
    # per-UNet-call frame cap: past this many (window, frame) positions the
    # denoiser runs over window groups (CFG as two passes) instead of one
    # batch over every window with CFG folded in. One batch peaks at 4.4 GiB
    # + 0.50 GiB a position (12.41 GiB at 16, 49.40 GiB at 90): 96 keeps
    # three 30-frame windows in one batch at about 52 GiB, two thirds of the
    # card. Grouping costs no time (48 frames, one step: 4.68 s in one batch,
    # 4.71 s in three groups), so the headroom is kept rather than spent.
    max_denoise_frame_batch: int = 96
    # Cap on denoiser frame-passes per device program in the JAX package's
    # grouped denoise. Unused by the port, whose loop is dispatched from the
    # host every step; kept so configs stay interchangeable.
    max_exec_frame_passes: int = 640


SD15_UNET = UNetConfig()
GUIDANCE_MIX = GuidanceUNetConfig(use_man=True)
GUIDANCE_MIX_CHAR = GuidanceUNetConfig(use_man=False)
DENOISING_3D = DenoisingUNetConfig()
DENOISING_2D = DenoisingUNetConfig(motion=MotionModuleConfig(enabled=False))

SDXL_UNET = UNetConfig(block_out_channels=(320, 640, 1280), cross_attention_dim=2048,
                       level_heads=(5, 10, 20), attention_levels=(1, 2),
                       transformer_layers=(1, 2, 10), use_linear_projection=True,
                       addition_embed_type="text_time")
SDXL_MOTION = MotionModuleConfig(resolutions=(1, 2, 4), mid_block=False)
SDXL_GUIDANCE = GuidanceUNetConfig(unet=SDXL_UNET)
SDXL_DENOISING = DenoisingUNetConfig(unet=SDXL_UNET, motion=SDXL_MOTION)
SDXL_VAE = VAEConfig(scaling_factor=0.13025)
