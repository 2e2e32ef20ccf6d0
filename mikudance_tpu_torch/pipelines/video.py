"""MikuDance video sampling pipeline, cached-bank path.

Port of ``mikudance_tpu/pipelines/video.py`` (reference
``MikuDanceVideoPipeline.__call__``, `pipeline_mikudance.py:362-704`):

- All condition frames are VAE-encoded in chunks of one batched stream (the
  reference loops frame-at-a-time, `:483-549`).
- Reference-attention banks depend only on the 22-channel condition stack
  and t=0, never on the denoising state, so the guidance UNet runs once per
  (window, position), and the banks are projected through the denoiser's
  attn1 K/V weights once per clip (as is the CLIP context through attn2).
- The denoising loop runs every sliding window as one batched UNet call with
  CFG folded into the batch: the first half is uncond, with zero bank K/V and
  a zero CLIP context — by linearity exactly the reference's plain
  self-attention bypass (`mutual_mix_attention.py:181-201`).
- Overlap fusion (the reference's "counter", `:577-664`) is an
  ``index_add_`` followed by a division by the per-frame window count.

CFG-embed parity: the reference tiles the [uncond, cond] CLIP pair f times
for the guidance UNet (`:646`), so window position k gets the uncond embed
when (f + k) is even; ``guidance_clip_mode="reference_inference"`` does the
same, ``"cond"`` gives every frame the cond embed.

After the loop, ``PipelineConfig.interpolation_factor`` upsamples the frame
rate of the latents (``pipelines/interpolation.py``); the decoder is the SD
VAE's or the temporal one (``models/vae_temporal.py``), whichever the bundle
holds.

The pipeline runs on the CUDA card unless the caller names another device:
``device=None`` raises where there is no card, ``device="cpu"`` runs on the
CPU. The bundle's modules are moved to that device.

Only the cached path is ported. Per-step banks, int8 banks and
window-grouped denoising raise ``NotImplementedError`` (ROADMAP Queue 1,
item 8).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..core.configs import PipelineConfig
from ..core.params import resolve_device
from ..diffusion.ddim import DDIMSchedule, inference_step_pairs
from ..models.unet import (DenoisingUNet, GuidanceUNet, bank_keys,
                           precompute_context_kv, precompute_reference_kv)
from ..models.clip_vision import CLIPVisionTower, clip_image_tokens
from ..models.vae import Decoder, Encoder, latent_mean
from ..models.vae_temporal import TemporalDecoder
from . import context as ctx_sched
from .interpolation import interpolate_latents

SD_LATENT_SCALE = 0.18215


@dataclasses.dataclass
class ModelBundle:
    """The networks of the sampler (weights live in the modules): the two
    UNets, the VAE encoder, either decoder and, optionally, the CLIP tower
    that turns the reference picture into the image prompt."""

    guide: GuidanceUNet
    den: DenoisingUNet
    vae_enc: Encoder
    vae_dec: Union[Decoder, TemporalDecoder]
    clip: Optional[CLIPVisionTower] = None

    def to(self, device: torch.device) -> "ModelBundle":
        for m in (self.guide, self.den, self.vae_enc, self.vae_dec, self.clip):
            if m is not None:
                m.to(device)
        return self


def _dtype(module: torch.nn.Module) -> torch.dtype:
    return next(module.parameters()).dtype


def encode_frames(vae_enc: Encoder, frames: torch.Tensor, chunk: int = 8) -> torch.Tensor:
    """VAE-encode frames (N, H, W, 3) in [-1, 1] -> scaled latent means
    (N, H/8, W/8, 4), ``chunk`` frames at a time (one 768^2 frame holds GBs
    of encoder activations)."""
    lats = [latent_mean(vae_enc(frames[i:i + chunk])) for i in range(0, frames.shape[0], chunk)]
    return torch.cat(lats, dim=0) * SD_LATENT_SCALE


def decode_frames(vae_dec, latents: torch.Tensor) -> torch.Tensor:
    """Scaled latents (N, h, w, 4) -> images in about [-1, 1], decoded
    ``vae_dec.decode_chunk`` frames at a time (16 for the temporal decoder,
    whose convolutions couple a chunk's frames; 4 for the SD decoder, a
    memory knob). The remainder is its own smaller chunk, never zero-padded:
    pad frames would bleed into real ones through the temporal convolutions."""
    c = vae_dec.decode_chunk
    return torch.cat([vae_dec(latents[i:i + c] / SD_LATENT_SCALE)
                      for i in range(0, latents.shape[0], c)], dim=0)


def to_unit_float(x, signed: bool, device: torch.device) -> torch.Tensor:
    """Images to the device as float32. uint8 travels as bytes and is scaled
    on the device: signed=True -> [-1, 1] (VAE image range), else [0, 1] (the
    condition streams, the reference's do_normalize=False processor)."""
    t = torch.as_tensor(x, device=device)  # an array, or a tensor on any device
    if t.dtype == torch.uint8:
        t = t.float()
        return t / 127.5 - 1.0 if signed else t / 255.0
    return t.float()


def build_condition_stack(ref_latent, skel_latent, pose_latents, face_latents,
                          hand_latents) -> torch.Tensor:
    """Per-frame 20-channel condition stack in the reference's concat order
    (`pipeline_mikudance.py:557-567`): [ref, skel, pose, face, hand]."""
    T = pose_latents.shape[0]
    ref = ref_latent.expand((T,) + ref_latent.shape[1:])
    skel = skel_latent.expand((T,) + skel_latent.shape[1:])
    return torch.cat([ref, skel, pose_latents, face_latents, hand_latents], dim=-1)


def guidance_context_for_windows(windows: np.ndarray, ctx_cond: torch.Tensor,
                                 ctx_uncond: torch.Tensor, mode: str) -> torch.Tensor:
    """(nw*wf, S, 768) CLIP context for the guidance UNet, per window position."""
    nw, wf = windows.shape
    if mode == "cond":
        return ctx_cond.expand((nw * wf,) + ctx_cond.shape[1:])
    if mode == "reference_inference":
        # reference tiles [u, c] f times; cond half position k gets index f+k.
        use_uncond = np.tile((np.arange(wf) + wf) % 2 == 0, nw)
        mask = torch.as_tensor(use_uncond, device=ctx_cond.device)[:, None, None]
        return torch.where(mask, ctx_uncond, ctx_cond)
    raise ValueError(f"unknown guidance_clip_mode {mode!r}")


class VideoPipeline:
    """Host-side orchestrator of the sampler on one device."""

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
            num_train_timesteps=sc.num_train_timesteps,
            beta_start=sc.beta_start,
            beta_end=sc.beta_end,
        )

    def clip_context(self, ref_image) -> np.ndarray:
        """Reference picture -> the (1, 257, 768) CLIP tokens ``__call__``
        takes, through the bundle's CLIP tower."""
        if self.bundle.clip is None:
            raise ValueError("the bundle holds no CLIP tower")
        return clip_image_tokens(self.bundle.clip, ref_image, self.device)

    # ------------------------------------------------------------------ banks
    def _compute_banks(self, window_cond: torch.Tensor, window_motion: torch.Tensor,
                       g_ctx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Guidance UNet over all (window, position) condition frames; t=0."""
        t0 = torch.zeros((window_cond.shape[0],), dtype=torch.int32, device=self.device)
        return self.bundle.guide(window_cond, window_motion, t0, g_ctx)

    # ------------------------------------------------------- CFG fusion step
    def _fused_cfg_step(self, sum_u, sum_c, counts, scale: float, t: int, t_prev: int,
                        latents: torch.Tensor) -> torch.Tensor:
        """Counter-normalized window fusion -> CFG mix -> one DDIM update
        (`pipeline_mikudance.py:577-678`)."""
        inv = (1.0 / counts)[:, None, None, None]
        mean_u, mean_c = sum_u * inv, sum_c * inv
        noise_pred = mean_u + scale * (mean_c - mean_u)
        return self.schedule.step(noise_pred, t, t_prev, latents)

    # ---------------------------------------------------------------- denoise
    def _denoise(self, noise: torch.Tensor, banks: Dict[str, torch.Tensor],
                 ctx_cond: torch.Tensor, windows: np.ndarray, counts: torch.Tensor,
                 ts: np.ndarray, prev_ts: np.ndarray, guidance_scale: float) -> torch.Tensor:
        """noise: (T, h, w, 4); banks: each (nw*wf, S, C), cond half.
        Returns the final fp32 latents (T, h, w, 4)."""
        den = self.bundle.den
        nw, wf = windows.shape
        dt = _dtype(den)

        # Step-invariant K/V: banks and CLIP context are projected once here.
        # CFG batch: first nw windows uncond (zero bank K/V, zero context).
        banks2 = {
            key: (torch.cat([torch.zeros_like(k), k]), torch.cat([torch.zeros_like(v), v]))
            for key, (k, v) in precompute_reference_kv(den, banks, dt).items()
        }
        ctx2 = torch.cat([torch.zeros_like(ctx_cond).expand((nw,) + ctx_cond.shape[1:]),
                          ctx_cond.expand((nw,) + ctx_cond.shape[1:])]).to(dt)
        ctx_kv2 = precompute_context_kv(den, ctx2, bank_keys(den.cfg.unet), dt)

        win_idx = torch.as_tensor(windows, dtype=torch.long, device=self.device)
        flat_idx = win_idx.reshape(-1)
        latents = noise.float()
        for t, t_prev in zip(ts.tolist(), prev_ts.tolist()):
            win = latents[win_idx]  # (nw, wf, h, w, 4)
            batch = torch.cat([win, win]).to(dt)
            t_b = torch.full((2 * nw,), t, dtype=torch.int32, device=self.device)
            pred = den(batch, t_b, banks_kv=banks2, ctx_kv=ctx_kv2).float()
            pred_u = pred[:nw].reshape((nw * wf,) + pred.shape[2:])
            pred_c = pred[nw:].reshape((nw * wf,) + pred.shape[2:])
            sum_u = torch.zeros_like(latents).index_add_(0, flat_idx, pred_u)
            sum_c = torch.zeros_like(latents).index_add_(0, flat_idx, pred_c)
            latents = self._fused_cfg_step(sum_u, sum_c, counts, guidance_scale, t, t_prev,
                                           latents)
        return latents

    # ----------------------------------------------------------------- decode
    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents -> uint8 frames on the device: round(clip(x/2 + 0.5) * 255)."""
        imgs = decode_frames(self.bundle.vae_dec, latents)
        imgs = torch.clamp(imgs.float() / 2.0 + 0.5, 0.0, 1.0)
        return torch.round(imgs * 255.0).to(torch.uint8)

    def decode_to_host(self, latents: torch.Tensor) -> np.ndarray:
        """Decode chunk by chunk; each chunk's uint8 copy to the host is queued
        behind its decode, so it rides under the next chunk's decode."""
        c = self.bundle.vae_dec.decode_chunk
        parts = [self._decode(latents[i:i + c]).to("cpu", non_blocking=True)
                 for i in range(0, latents.shape[0], c)]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return torch.cat(parts).numpy()

    # ------------------------------------------------------------------- call
    @torch.inference_mode()
    def __call__(
        self,
        ref_image: np.ndarray,  # (H, W, 3) in [-1, 1] float, or raw uint8
        ref_skel: np.ndarray,  # (H, W, 3) in [0, 1] float, or raw uint8
        pose_frames: np.ndarray,  # (T, H, W, 3) in [0, 1] float, or raw uint8
        face_frames: Optional[np.ndarray],  # as pose_frames, or None if absent
        hand_frames: Optional[np.ndarray],  # as pose_frames, or None if absent
        scene_motion,  # (T, h, w, 2) latent-res flow, array or tensor on any device
        clip_context: np.ndarray,  # (1, S, 768) CLIP image tokens of ref image
        noise: np.ndarray,  # (T, h, w, 4) initial gaussian latents
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        decode: bool = True,
        to_host: bool = False,
        timer=None,  # utils.profiling.Timer: per-phase wall times (syncs between phases)
    ):
        """Returns the fp32 latents (decode=False), uint8 frames (T', H, W, 3)
        on the device, or, with to_host=True, the uint8 frames as numpy;
        T' = (T - 1) * 2^(interpolation_factor - 1) + 1."""
        mark = timer.mark if timer is not None else (lambda name: None)
        if timer is not None:
            timer.start()
        cfgc = self.config
        steps = num_inference_steps or cfgc.num_inference_steps
        scale = cfgc.guidance_scale if guidance_scale is None else guidance_scale
        T = pose_frames.shape[0]
        dev = self.device

        windows = ctx_sched.window_matrix(
            T, cfgc.context.frames, cfgc.context.stride, cfgc.context.overlap)
        nw, wf = windows.shape
        self._check_cached_path(nw, wf)

        # 1. VAE encodes. An absent face/hand stream (None), or a present
        # all-black uint8 one, is the reference CLI's black-frame fallback:
        # one black frame is encoded and its latent broadcast over T
        # (identical per-frame numerics, no T-frame transfer and encode).
        def collapse_black(frames):
            if isinstance(frames, np.ndarray) and frames.dtype == np.uint8 and not frames.any():
                return None
            return frames

        face_frames, hand_frames = collapse_black(face_frames), collapse_black(hand_frames)
        H_img, W_img = pose_frames.shape[1:3]
        black = np.zeros((1, H_img, W_img, 3), np.uint8)

        def as4(x):
            return x[None] if x.ndim == 3 else x

        raw = [as4(np.asarray(ref_image)), as4(np.asarray(ref_skel)), pose_frames,
               black if face_frames is None else face_frames,
               black if hand_frames is None else hand_frames]
        if all(p.dtype == np.uint8 for p in raw):
            # one stacked byte transfer; row 0 is the ref image ([-1, 1]),
            # every later row a [0, 1] condition stream
            f = torch.from_numpy(np.concatenate(raw, axis=0)).to(dev).float()
            all_frames = torch.cat([f[:1] / 127.5 - 1.0, f[1:] / 255.0])
        else:
            all_frames = torch.cat([to_unit_float(raw[0], True, dev)]
                                   + [to_unit_float(p, False, dev) for p in raw[1:]])
        lat = encode_frames(self.bundle.vae_enc, all_frames)
        mark("vae_encode")
        o = 2 + T
        n_face = raw[3].shape[0]
        ref_l, skel_l, pose_l = lat[0:1], lat[1:2], lat[2:o]
        face_l, hand_l = lat[o:o + n_face], lat[o + n_face:]
        face_l = face_l.expand((T,) + face_l.shape[1:]) if n_face == 1 else face_l
        hand_l = hand_l.expand((T,) + hand_l.shape[1:]) if hand_l.shape[0] == 1 else hand_l
        cond20 = build_condition_stack(ref_l, skel_l, pose_l, face_l, hand_l)
        del all_frames, lat

        # 2. banks for every (window, position), computed once
        counts = torch.as_tensor(ctx_sched.frame_counts(windows, T), dtype=torch.float32,
                                 device=dev)
        flat = torch.as_tensor(windows.reshape(-1), dtype=torch.long, device=dev)
        ctx_cond = torch.as_tensor(clip_context, device=dev).float()
        gdt = _dtype(self.bundle.guide)
        g_ctx = guidance_context_for_windows(
            windows, ctx_cond, torch.zeros_like(ctx_cond), cfgc.guidance_clip_mode).to(gdt)
        motion = torch.as_tensor(scene_motion, device=dev)
        banks = self._compute_banks(cond20[flat].to(gdt), motion[flat].to(gdt), g_ctx)
        mark("guidance_banks")

        # 3. the loop over DDIM steps
        ts, prev_ts = inference_step_pairs(self.schedule, steps,
                                           spacing=cfgc.scheduler.timestep_spacing)
        latents = self._denoise(torch.as_tensor(noise, device=dev), banks,
                                ctx_cond, windows, counts, ts, prev_ts, float(scale))
        del banks
        mark("denoise")
        # 4. optional latent frame-rate upsampling (`pipeline_mikudance.py:688`)
        if cfgc.interpolation_factor > 1:
            latents = interpolate_latents(latents, cfgc.interpolation_factor,
                                          cfgc.interpolation_mode)

        if not decode:
            return latents
        if to_host:
            out = self.decode_to_host(latents)
            mark("decode_d2h")
            return out
        out = self._decode(latents)
        mark("decode")
        return out

    def _check_cached_path(self, nw: int, wf: int) -> None:
        """The port runs the cached-bank path with every window in one UNet
        batch; a call that needs another path raises."""
        cfgc = self.config
        if cfgc.bank_mode not in ("auto", "cached", "per_step", "cached_q8"):
            raise ValueError(f"unknown bank_mode {cfgc.bank_mode!r}")
        if cfgc.bank_mode in ("per_step", "cached_q8") or (
                cfgc.bank_mode == "auto" and nw * wf > cfgc.cached_bank_positions):
            raise NotImplementedError(
                f"bank_mode={cfgc.bank_mode!r} with {nw}x{wf} window positions needs the "
                "per-step / int8 bank tiers (ROADMAP Queue 1, item 8)")
        if nw * wf > cfgc.max_denoise_frame_batch and nw > 1:
            raise NotImplementedError(
                f"{nw} windows of {wf} frames exceed max_denoise_frame_batch="
                f"{cfgc.max_denoise_frame_batch}: window-grouped denoising is "
                "ROADMAP Queue 1, item 8")
