"""Stage-1 single-frame pose-to-image pipeline.

Port of ``mikudance_tpu/pipelines/image.py`` (reference ``Pose2ImagePipeline``,
`pipeline_stage1_img.py:192`): 20-channel condition stack (no scene motion, no
MAN: the ``GUIDANCE_MIX_CHAR`` guidance UNet), banks computed once (the
reference runs the guidance UNet only at step 0, `:348-359`, which is what
static banks are), CFG over a batch of 2, plain DDIM loop, single-frame VAE
decode. It is the T = 1 case of the video machinery, with a denoiser without
motion modules (``DENOISING_2D``); one with motion modules works too, its
temporal attention then runs over one frame.

Runs on the CUDA card unless the caller names another device: ``device=None``
raises where there is no card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.configs import PipelineConfig
from ..core.params import resolve_device
from ..diffusion.ddim import DDIMSchedule, inference_step_pairs
from ..models.unet import bank_keys, precompute_context_kv, precompute_reference_kv
from .video import (SD_LATENT_SCALE, ModelBundle, _dtype, build_condition_stack, encode_frames,
                    to_unit_float)


class ImagePipeline:
    def __init__(self, bundle: ModelBundle, config: PipelineConfig = PipelineConfig(),
                 schedule: Optional[DDIMSchedule] = None, device=None):
        """``device=None`` means the CUDA card and raises where there is none;
        the bundle is moved to the device."""
        self.device = resolve_device(device)
        self.bundle = bundle.to(self.device)
        self.config = config
        sc = config.scheduler
        self.schedule = schedule or DDIMSchedule.create(
            beta_schedule=sc.beta_schedule,
            prediction_type=sc.prediction_type,
            rescale_betas_zero_snr=sc.rescale_betas_zero_snr,
        )

    def _banks(self, cond20: torch.Tensor, ctx_cond: torch.Tensor):
        # ``guidance_clip_mode`` is a quirk of the video pipeline only: the
        # reference image pipeline passes the cond embed straight to the
        # reference UNet (`pipeline_stage1_img.py:348-359`).
        d = _dtype(self.bundle.guide)
        t0 = torch.zeros((1,), dtype=torch.int32, device=self.device)
        return self.bundle.guide(cond20.to(d), None, t0, ctx_cond.to(d))

    def _denoise(self, noise: torch.Tensor, banks, ctx_cond: torch.Tensor, ts, prev_ts,
                 scale: float) -> torch.Tensor:
        den = self.bundle.den
        d = _dtype(den)
        # step-invariant K/V taken out of the loop (see pipelines/video.py);
        # batch row 0 is the uncond half: zero bank K/V, zero context
        banks2 = {
            key: (torch.cat([torch.zeros_like(k), k]), torch.cat([torch.zeros_like(v), v]))
            for key, (k, v) in precompute_reference_kv(den, banks, d).items()
        }
        ctx2 = torch.cat([torch.zeros_like(ctx_cond), ctx_cond]).to(d)
        ctx_kv2 = precompute_context_kv(den, ctx2, bank_keys(den.cfg.unet), d)

        x = noise.float()
        for t, t_prev in zip(ts.tolist(), prev_ts.tolist()):
            batch = torch.cat([x, x])[:, None].to(d)  # (2, 1, h, w, 4)
            t_b = torch.full((2,), t, dtype=torch.int32, device=self.device)
            pred = den(batch, t_b, banks_kv=banks2, ctx_kv=ctx_kv2)[:, 0].float()
            noise_pred = pred[0:1] + scale * (pred[1:2] - pred[0:1])
            x = self.schedule.step(noise_pred, t, t_prev, x)
        return x

    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        img = self.bundle.vae_dec(latents / SD_LATENT_SCALE)
        img = torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0)
        return torch.round(img * 255.0).to(torch.uint8)

    @torch.inference_mode()
    def __call__(
        self,
        ref_image: np.ndarray,  # (H, W, 3) in [-1, 1] float, or raw uint8
        ref_skel: np.ndarray,  # (H, W, 3) in [0, 1] float, or raw uint8
        pose: np.ndarray,  # as ref_skel
        face: np.ndarray,
        hand: np.ndarray,
        clip_context: np.ndarray,  # (1, S, 768)
        noise: np.ndarray,  # (1, h, w, 4)
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        decode: bool = True,
    ):
        """Returns the fp32 latents (1, h, w, 4) (decode=False) or the uint8
        image (1, H, W, 3) on the device."""
        steps = num_inference_steps or self.config.num_inference_steps
        scale = self.config.guidance_scale if guidance_scale is None else guidance_scale
        dev = self.device
        frames = torch.stack([to_unit_float(ref_image, True, dev)]
                             + [to_unit_float(a, False, dev)
                                for a in (ref_skel, pose, face, hand)])
        lat = encode_frames(self.bundle.vae_enc, frames)
        cond20 = build_condition_stack(lat[0:1], lat[1:2], lat[2:3], lat[3:4], lat[4:5])
        ctx = torch.as_tensor(clip_context, device=dev).float()
        banks = self._banks(cond20, ctx)
        ts, prev_ts = inference_step_pairs(self.schedule, steps)
        latents = self._denoise(torch.as_tensor(noise, device=dev), banks, ctx, ts, prev_ts, float(scale))
        if not decode:
            return latents
        return self._decode(latents)
