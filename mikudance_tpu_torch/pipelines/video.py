"""MikuDance video sampling pipeline.

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

Long clips (``PipelineConfig.bank_mode``, ``_denoise_streamed``): where the
banks of every (window, position) or one UNet batch over every window would
not fit the card, the denoiser runs over window groups, with the banks
cached whole, cached as int8 with one entry per (frame, context variant), or
recomputed per (step, group) through the guidance UNet.

Several devices (``mesh``, ``core/mesh.py``): one process a device, every
rank calls the same pipeline on the same inputs. Per call, a ('win',
'frame') mesh is chosen from the window geometry (``choose_2d_mesh``): the
encode and the SD decode shard frames over all its ranks, the denoiser's
(2 nw, wf) batch shards over both axes (the motion modules reshard frames
by ``all_to_all``), the banks shard positions over all ranks and go, by one
``exchange``, to the ranks whose block needs them, the window groups of the
grouped tiers (and of a rank's batch past ``max_denoise_frame_batch``) split
over the ranks, which sum their fusion sums, and the temporal decoder shards
whole chunks or a chunk's frames (halos, summed moments). Cached banks stay
sharded: no rank holds all of them, so their budget scales with the ranks.
Collectives then give every rank the whole result; ranks the chosen mesh
leaves out receive it by broadcast. Without a mesh, or with a mesh of one,
nothing changes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..core.configs import PipelineConfig
from ..core.mesh import FRAME_AXIS, WIN_AXIS, Axis, Mesh, choose_2d_mesh, pad_to_multiple
from ..core.params import resolve_device
from ..diffusion.ddim import DDIMSchedule, inference_step_pairs
from ..models.unet import (DenoisingUNet, GuidanceUNet, bank_keys, bank_position_budget,
                           precompute_context_kv, precompute_reference_kv)
from ..models.clip_vision import CLIPVisionTower, clip_image_tokens
from ..models.vae import Decoder, Encoder, latent_mean
from ..models.vae_temporal import TemporalDecoder
from ..utils.profiling import count, span
from . import context as ctx_sched
from .interpolation import interpolate_latents

SD_LATENT_SCALE = 0.18215  # the SD VAE's; a pipeline reads its VAE's own (SDXL: 0.13025)


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


def _local_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's share of ``x``'s leading axis split over every rank of
    ``mesh`` (row-major), the axis zero-padded to a multiple of the rank
    count first (the JAX package's ``_pad_leading`` + ``P((win, frame))``)."""
    per = pad_to_multiple(x.shape[0], mesh.size) // mesh.size
    part = x[mesh.index() * per:(mesh.index() + 1) * per]
    if part.shape[0] < per:
        part = torch.cat([part, part.new_zeros((per - part.shape[0],) + part.shape[1:])])
    return part


def _unet_block(mesh: Mesh, nw: int, wf: int, index: Optional[int] = None):
    """((row start, stop), (frame start, stop)): the block of the (2 nw, wf)
    CFG batch that the rank at grid index ``index`` (default: this rank) runs
    on a ('win', 'frame') mesh."""
    rank = mesh.rank if index is None else int(mesh.ranks.reshape(-1)[index])
    at = mesh.coords(rank)
    bw, tf = 2 * nw // mesh.shape[WIN_AXIS], wf // mesh.shape[FRAME_AXIS]
    return ((at[WIN_AXIS] * bw, (at[WIN_AXIS] + 1) * bw),
            (at[FRAME_AXIS] * tf, (at[FRAME_AXIS] + 1) * tf))


def _block_positions(mesh: Mesh, nw: int, wf: int, index: int) -> np.ndarray:
    """The (window, position) rows (window * wf + frame) of the cond half in
    the block of grid index ``index``, ascending: the banks that rank needs
    (none where its rows are all uncond)."""
    rows, frames = _unet_block(mesh, nw, wf, index)
    cond_w = np.arange(max(rows[0], nw), rows[1]) - nw
    return (cond_w[:, None] * wf + np.arange(*frames)[None]).reshape(-1)


def encode_frames(vae_enc: Encoder, frames: torch.Tensor, chunk: int = 8,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """VAE-encode frames (N, H, W, 3) in [-1, 1] -> scaled latent means
    (N, H/8, W/8, 4), ``chunk`` frames at a time (one 768^2 frame holds GBs
    of encoder activations). With a mesh each rank encodes its share of the
    frames and the latents are gathered."""
    N = frames.shape[0]
    if mesh is not None:
        frames = _local_rows(frames, mesh)
    lats = torch.cat([latent_mean(vae_enc(frames[i:i + chunk]))
                      for i in range(0, frames.shape[0], chunk)], dim=0)
    if mesh is not None:
        lats = mesh.all_gather(lats)[:N]
    return lats * vae_enc.cfg.scaling_factor


def _decode_chunked(vae_dec, latents: torch.Tensor) -> torch.Tensor:
    c, scale = vae_dec.decode_chunk, vae_dec.cfg.scaling_factor
    return torch.cat([vae_dec(latents[i:i + c] / scale)
                      for i in range(0, latents.shape[0], c)], dim=0)


def decode_frames(vae_dec, latents: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Scaled latents (N, h, w, 4) -> images in about [-1, 1], decoded
    ``vae_dec.decode_chunk`` frames at a time (16 for the temporal decoder,
    whose convolutions couple a chunk's frames; 4 for the SD decoder, a
    memory knob). The remainder is its own smaller chunk, never zero-padded:
    pad frames would bleed into real ones through the temporal convolutions.

    With a mesh: the SD decoder shards frames over every rank; the temporal
    decoder shards whole chunks where their count splits over the ranks,
    else the frames of each chunk where the chunk splits (halos and summed
    moments, ``_decode_frame_sharded``), else decodes on every rank alike."""
    N = latents.shape[0]
    if mesh is not None:
        n, c = mesh.size, vae_dec.decode_chunk
        if not vae_dec.frames_coupled:
            return mesh.all_gather(_decode_chunked(vae_dec, _local_rows(latents, mesh)))[:N]
        if N % c == 0 and (N // c) % n == 0:
            per = N // n
            mine = latents[mesh.index() * per:(mesh.index() + 1) * per]
            return mesh.all_gather(_decode_chunked(vae_dec, mine))
        if c % n == 0 and N >= c:
            return _decode_frame_sharded(vae_dec, latents, mesh)
    return _decode_chunked(vae_dec, latents)


def _decode_frame_sharded(vae_dec, latents: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Temporal-decoder chunks with each chunk's frames split over every rank
    of the mesh (c / n consecutive frames a rank); the remainder (under one
    chunk) decodes on every rank alike."""
    N, c = latents.shape[0], vae_dec.decode_chunk
    per, i, frames = c // mesh.size, mesh.index(), Axis(mesh)
    scale, full = vae_dec.cfg.scaling_factor, N - N % c
    parts = [mesh.all_gather(vae_dec(latents[s + i * per:s + (i + 1) * per] / scale, frames))
             for s in range(0, full, c)]
    if N % c:
        parts.append(vae_dec(latents[full:] / scale))
    return torch.cat(parts, dim=0)


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


def quantize_banks(banks: Dict[str, torch.Tensor]):
    """Symmetric per-position int8 quantization of reference banks.

    Banks are LayerNormed hidden states (O(1) scale) consumed as additive
    attention K/V inputs; one scale per (position, key) keeps the error at a
    fraction of a percent. int8 halves the bank bytes against bf16, so a long
    clip can cache every bank instead of recomputing them per (step, group)
    through the guidance UNet.

    Returns (values int8, scales fp32 (n, 1, 1)) dicts."""
    qv, qs = {}, {}
    for k, v in banks.items():
        vf = v.float()
        s = vf.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-8) / 127.0
        qv[k] = torch.round(vf / s).clamp_(-127, 127).to(torch.int8)  # half to even
        qs[k] = s
    return qv, qs


def dequantize_banks(qv, qs, dtype) -> Dict[str, torch.Tensor]:
    return {k: (qv[k].float() * qs[k]).to(dtype) for k in qv}


def choose_bank_group(num_windows: int, window_len: int, budget_positions: int,
                      n_shards: int = 1) -> Optional[int]:
    """Largest divisor g of num_windows with g*window_len <= budget (min 1):
    the window-group size of the grouped denoise. With ``n_shards`` (the
    ranks of a mesh, each scanning the same number of groups) the group
    count must also split evenly over the shards; returns None when no such
    g exists (the caller pads with zero-weight windows or runs unsharded)."""
    best = None
    for g in range(1, num_windows + 1):
        if (num_windows % g == 0 and g * window_len <= budget_positions
                and (num_windows // g) % n_shards == 0):
            best = g
    if n_shards == 1 and best is None:
        best = 1  # a single over-budget window group: stream window-by-window
    return best


def context_variants(windows: np.ndarray, mode: str) -> np.ndarray:
    """(nw*wf,) bool: which window positions get the uncond CLIP embed in the
    guidance UNet. The reference tiles [u, c] f times, so the cond half's
    position k gets index f + k."""
    nw, wf = windows.shape
    if mode == "cond":
        return np.zeros(nw * wf, bool)
    if mode == "reference_inference":
        return np.tile((np.arange(wf) + wf) % 2 == 0, nw)
    raise ValueError(f"unknown guidance_clip_mode {mode!r}")


def unique_bank_index(windows: np.ndarray, mode: str):
    """A bank depends only on (frame, CLIP-context variant), never on the
    window a position sits in: (frames (n,), variant is uncond (n,) bool,
    position -> unique row (nw*wf,)) of the deduplicated bank cache."""
    pairs = windows.reshape(-1).astype(np.int64) * 2 + context_variants(windows, mode)
    uniq, inv = np.unique(pairs, return_inverse=True)
    return uniq // 2, (uniq % 2).astype(bool), inv.reshape(-1)


def guidance_context_for_windows(windows: np.ndarray, ctx_cond: torch.Tensor,
                                 ctx_uncond: torch.Tensor, mode: str) -> torch.Tensor:
    """(nw*wf, S, 768) CLIP context for the guidance UNet, per window position."""
    use_uncond = context_variants(windows, mode)
    if mode == "cond":
        return ctx_cond.expand((use_uncond.size,) + ctx_cond.shape[1:])
    mask = torch.as_tensor(use_uncond, device=ctx_cond.device)[:, None, None]
    return torch.where(mask, ctx_uncond, ctx_cond)


def schedule_for(config: PipelineConfig) -> DDIMSchedule:
    """The DDIM schedule a pipeline of ``config`` samples with."""
    sc = config.scheduler
    return DDIMSchedule.create(
        beta_schedule=sc.beta_schedule,
        prediction_type=sc.prediction_type,
        rescale_betas_zero_snr=sc.rescale_betas_zero_snr,
        num_train_timesteps=sc.num_train_timesteps,
        beta_start=sc.beta_start,
        beta_end=sc.beta_end,
    )


class VideoPipeline:
    """Host-side orchestrator of the sampler on one device, or on the ranks
    of a mesh."""

    def __init__(self, bundle: ModelBundle, config: PipelineConfig = PipelineConfig(),
                 schedule: Optional[DDIMSchedule] = None, device=None,
                 mesh: Optional[Mesh] = None):
        """``device=None`` means the CUDA card (under a process group, card
        ``LOCAL_RANK``) and raises where there is none; the bundle is moved
        to the device. ``mesh``: the ranks a call may spread over
        (``core.mesh.make_mesh()``, all of them); every rank builds the same
        pipeline and calls it with the same inputs. Per call the ('win',
        'frame') mesh is chosen from the window geometry; choosing one is
        collective (``dist.new_group``), and the meshes are kept."""
        self.device = resolve_device(device)
        self.bundle = bundle.to(self.device)
        self.config = config
        self.schedule = schedule or schedule_for(config)
        self.mesh = mesh
        self._meshes: Dict[tuple, Optional[Mesh]] = {}

    def mesh_for(self, batch: int, frames: int) -> Optional[Mesh]:
        """The ('win', 'frame') mesh of a (batch, frames) UNet batch over the
        pipeline's ranks; None on one rank."""
        if self.mesh is None or self.mesh.size == 1:
            return None
        if (batch, frames) not in self._meshes:
            self._meshes[batch, frames] = choose_2d_mesh(self.mesh.ranks.reshape(-1), batch,
                                                         frames)
        return self._meshes[batch, frames]

    def clip_context(self, ref_image) -> np.ndarray:
        """Reference picture -> the (1, 257, 768) CLIP tokens ``__call__``
        takes, through the bundle's CLIP tower."""
        if self.bundle.clip is None:
            raise ValueError("the bundle holds no CLIP tower")
        return clip_image_tokens(self.bundle.clip, ref_image, self.device)

    # ------------------------------------------------------------------ banks
    def _compute_banks(self, window_cond: torch.Tensor, window_motion: torch.Tensor,
                       g_ctx: torch.Tensor, mesh: Optional[Mesh] = None,
                       need: Optional[list] = None,
                       g_add: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Guidance UNet over the given (window, position) condition frames;
        t=0; ``g_add``: each position's added conditioning (SDXL), or None.
        The guidance UNet is per frame: with a mesh each rank runs its
        share of the positions, and the banks go where ``need`` (one
        ascending array of positions per grid index) sends them. Nothing is
        gathered: a rank ends with the banks of its own positions only."""
        if mesh is not None:
            per = pad_to_multiple(window_cond.shape[0], mesh.size) // mesh.size
            lo, mine = mesh.index() * per, need[mesh.index()]
            banks = self._compute_banks(*(_local_rows(x, mesh)
                                          for x in (window_cond, window_motion, g_ctx)),
                                        g_add=None if g_add is None else _local_rows(g_add, mesh))
            send = [p[(p >= lo) & (p < lo + per)] - lo for p in need]
            recv = [int(((mine >= j * per) & (mine < (j + 1) * per)).sum())
                    for j in range(mesh.size)]
            idx = torch.as_tensor(np.concatenate(send), dtype=torch.long, device=self.device)
            return {k: mesh.exchange(v[idx], [len(p) for p in send], recv)
                    for k, v in banks.items()}
        t0 = torch.zeros((window_cond.shape[0],), dtype=torch.int32, device=self.device)
        return self.bundle.guide(window_cond, window_motion, t0, g_ctx, add_emb=g_add)

    def _compute_banks_q8(self, window_cond, window_motion, g_ctx, chunk: int,
                          mesh: Optional[Mesh] = None, g_add: Optional[torch.Tensor] = None):
        """The banks of every given position as (int8 values, fp32 scales):
        the guidance UNet runs over ``chunk`` positions at a time and each
        chunk is quantized as it is produced, so the extra memory is one
        chunk's banks in the guidance UNet's type. With a mesh, each rank
        quantizes its share of the positions and every rank gets all int8
        buffers (one scale per position: the split changes no value)."""
        n = window_cond.shape[0]
        if mesh is not None:
            parts = self._compute_banks_q8(*(_local_rows(x, mesh)
                                             for x in (window_cond, window_motion, g_ctx)),
                                           chunk,
                                           g_add=None if g_add is None else _local_rows(g_add,
                                                                                        mesh))
            return tuple({k: mesh.all_gather(v)[:n] for k, v in part.items()}
                         for part in parts)
        chunk = max(1, min(chunk, n))
        qv, qs = {}, {}
        for i in range(0, n, chunk):
            piece = quantize_banks(self._compute_banks(
                window_cond[i:i + chunk], window_motion[i:i + chunk], g_ctx[i:i + chunk],
                g_add=None if g_add is None else g_add[i:i + chunk]))
            for buf, part in zip((qv, qs), piece):
                for k, p in part.items():
                    if k not in buf:
                        buf[k] = torch.empty((n,) + p.shape[1:], dtype=p.dtype, device=p.device)
                    buf[k][i:i + chunk] = p
        return qv, qs

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
                 ts: np.ndarray, prev_ts: np.ndarray, guidance_scale: float,
                 mesh: Optional[Mesh] = None, added=None) -> torch.Tensor:
        """noise: (T, h, w, 4); banks: each (nw*wf, S, C), cond half;
        ``added``: the denoiser's added conditioning of the (uncond, cond)
        halves, each (1, time embedding), or None.
        Returns the final fp32 latents (T, h, w, 4).

        With a ('win', 'frame') mesh the UNet is SPMD: a rank runs its block
        of the (2 nw, wf) batch, rows over 'win' and frames over 'frame', and
        ``banks`` are that block's (``_block_positions``); the prediction is
        gathered, and the fusion and the DDIM update run alike on every
        rank."""
        den = self.bundle.den
        nw, wf = windows.shape
        dt = _dtype(den)
        rows, frames = (0, 2 * nw), (0, wf)  # this rank's block of the CFG batch
        if mesh is not None:
            rows, frames = _unet_block(mesh, nw, wf)
            dw, df = mesh.shape[WIN_AXIS], mesh.shape[FRAME_AXIS]
        n_uncond = max(0, min(rows[1], nw) - rows[0]) * (frames[1] - frames[0])

        # Step-invariant K/V: banks and CLIP context are projected once here.
        # CFG batch: first nw windows uncond (zero bank K/V, zero context).
        def uncond_first(x):
            return torch.cat([x.new_zeros((n_uncond,) + x.shape[1:]), x])

        with span("bank_kv"):
            banks2 = {key: (uncond_first(k), uncond_first(v))
                      for key, (k, v) in precompute_reference_kv(den, banks, dt).items()}
            ctx2 = torch.cat([torch.zeros_like(ctx_cond).expand((nw,) + ctx_cond.shape[1:]),
                              ctx_cond.expand((nw,) + ctx_cond.shape[1:])]).to(dt)
            ctx_kv2 = precompute_context_kv(den, ctx2[rows[0]:rows[1]],
                                            bank_keys(den.cfg.unet), dt)
            # the raw banks and their K/V, held through the loop
            count("bank_bytes", sum(t.numel() * t.element_size()
                                    for t in [*banks.values(), *(x for kv in banks2.values()
                                                                 for x in kv)]))
        add2 = None
        if added is not None:  # (uncond, cond) rows of the CFG batch, this rank's
            add2 = torch.cat([added[0].expand(nw, -1), added[1].expand(nw, -1)])[rows[0]:rows[1]]
        frame_axis = None if mesh is None else Axis(mesh, FRAME_AXIS)

        win_idx = torch.as_tensor(windows, dtype=torch.long, device=self.device)
        flat_idx = win_idx.reshape(-1)
        latents = noise.float()
        for t, t_prev in zip(ts.tolist(), prev_ts.tolist()):
            with span("denoise_step"):
                win = latents[win_idx]  # (nw, wf, h, w, 4)
                batch = torch.cat([win, win])[rows[0]:rows[1], frames[0]:frames[1]].to(dt)
                t_b = torch.full((rows[1] - rows[0],), t, dtype=torch.int32, device=self.device)
                pred = den(batch, t_b, banks_kv=banks2, ctx_kv=ctx_kv2,
                           frame_axis=frame_axis, add_emb=add2).float()
                if mesh is not None:  # the blocks of every rank -> (2 nw, wf, h, w, 4)
                    grid = mesh.all_gather(pred[None]).reshape((dw, df) + pred.shape)
                    pred = grid.transpose(1, 2).reshape((2 * nw, wf) + pred.shape[2:])
                pred_u = pred[:nw].reshape((nw * wf,) + pred.shape[2:])
                pred_c = pred[nw:].reshape((nw * wf,) + pred.shape[2:])
                sum_u = torch.zeros_like(latents).index_add_(0, flat_idx, pred_u)
                sum_c = torch.zeros_like(latents).index_add_(0, flat_idx, pred_c)
                latents = self._fused_cfg_step(sum_u, sum_c, counts, guidance_scale, t, t_prev,
                                               latents)
        return latents

    # ------------------------------------------------------ denoise (grouped)
    def _denoise_streamed(self, noise: torch.Tensor, cond20: torch.Tensor,
                          motion: torch.Tensor, ctx_cond: torch.Tensor, g_ctx: torch.Tensor,
                          windows: np.ndarray, counts: torch.Tensor, ts: np.ndarray,
                          prev_ts: np.ndarray, guidance_scale: float, group: int,
                          banks_cached=None, bank_idx=None, win_w: Optional[np.ndarray] = None,
                          mesh: Optional[Mesh] = None, added=None,
                          g_add: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Long-clip denoise: the UNet runs over groups of ``group`` windows,
        never over all windows at once. Three bank modes share the loop:

        - ``banks_cached=None``: the banks of a group are recomputed per
          (step, group) through the guidance UNet from ``cond20``, ``motion``
          and ``g_ctx`` (each (nw*wf, ...) or (T, ...)), the reference's own
          memory behaviour (`pipeline_mikudance.py:647-653`);
        - a dict of (n, S, C) banks, those of every position of this rank's
          windows (of every window without a mesh): computed once outside and
          sliced per group (cached-grouped: the banks fit, one UNet batch
          does not);
        - an (int8 values, fp32 scales) tuple with ``bank_idx`` (nw*wf,): the
          deduplicated quantized cache, gathered and dequantized per group.

        CFG is two passes of the denoiser, not a doubled batch: the uncond
        pass has a zero CLIP context and no banks (plain self-attention, the
        same math as zero banks), so activations are half of ``_denoise``'s.
        A group's banks are dropped before the next group's are made.

        With a mesh the window groups split over its ranks (flattened), each
        rank summing its own groups' predictions; the sums are added over the
        ranks before the DDIM update, which every rank computes alike.
        ``win_w`` (nw,): 0 for the pad windows that make the groups split
        evenly, whose predictions stay out of the sums. ``added``: the
        denoiser's (uncond, cond) added conditioning, ``g_add`` (nw*wf, ...)
        the guidance UNet's per position, or None."""
        den = self.bundle.den
        nw, wf = windows.shape
        cdt, gdt = _dtype(den), _dtype(self.bundle.guide)
        recompute = banks_cached is None
        quantized = isinstance(banks_cached, tuple)
        ctx_b = ctx_cond.expand((group,) + ctx_cond.shape[1:]).to(cdt)
        ctx_0 = torch.zeros_like(ctx_b)
        add_u, add_c = (None, None) if added is None else added
        win_idx = torch.as_tensor(windows, dtype=torch.long, device=self.device)
        if quantized:
            bank_idx = torch.as_tensor(bank_idx, dtype=torch.long, device=self.device)

        def group_banks(rows: slice, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
            if recompute:
                return self._compute_banks(cond20[flat].to(gdt), motion[flat].to(gdt),
                                           g_ctx[rows], g_add=None if g_add is None else g_add[rows])
            if quantized:
                idx = bank_idx[rows]
                qv, qs = banks_cached
                return dequantize_banks({k: v[idx] for k, v in qv.items()},
                                        {k: v[idx] for k, v in qs.items()}, cdt)
            return {k: v[rows.start - first:rows.stop - first] for k, v in banks_cached.items()}

        starts = range(0, nw, group)
        if mesh is not None:  # this rank's share of the groups
            per = len(starts) // mesh.size
            starts = starts[mesh.index() * per:(mesh.index() + 1) * per]
        first = starts[0] * wf  # this rank's first position
        if win_w is not None:
            win_w = torch.as_tensor(win_w, dtype=torch.float32, device=self.device)
        latents = noise.float()
        for t, t_prev in zip(ts.tolist(), prev_ts.tolist()):
            with span("denoise_step"):
                sum_u, sum_c = torch.zeros_like(latents), torch.zeros_like(latents)
                t_b = torch.full((group,), t, dtype=torch.int32, device=self.device)
                for g0 in starts:
                    w_g = win_idx[g0:g0 + group]  # (group, wf)
                    flat = w_g.reshape(-1)
                    win = latents[w_g].to(cdt)  # (group, wf, h, w, 4)
                    pred_u = den(win, t_b, ctx_0, add_emb=add_u).float()
                    banks = group_banks(slice(g0 * wf, (g0 + group) * wf), flat)
                    pred_c = den(win, t_b, ctx_b, banks=banks, add_emb=add_c).float()
                    del banks
                    if win_w is not None:  # pad windows (weight 0) stay out of the sums
                        w = win_w[g0:g0 + group][:, None, None, None, None]
                        pred_u, pred_c = pred_u * w, pred_c * w
                    sum_u.index_add_(0, flat, pred_u.reshape((group * wf,) + pred_u.shape[2:]))
                    sum_c.index_add_(0, flat, pred_c.reshape((group * wf,) + pred_c.shape[2:]))
                if mesh is not None:
                    sum_u, sum_c = mesh.psum(sum_u), mesh.psum(sum_c)
                latents = self._fused_cfg_step(sum_u, sum_c, counts, guidance_scale, t, t_prev,
                                               latents)
        return latents

    # ----------------------------------------------------------------- decode
    def _decode(self, latents: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
        """Latents -> uint8 frames on the device: round(clip(x/2 + 0.5) * 255)."""
        imgs = decode_frames(self.bundle.vae_dec, latents, mesh)
        imgs = torch.clamp(imgs.float() / 2.0 + 0.5, 0.0, 1.0)
        return torch.round(imgs * 255.0).to(torch.uint8)

    def decode_to_host(self, latents: torch.Tensor, mesh: Optional[Mesh] = None) -> np.ndarray:
        """Decode chunk by chunk; each chunk's uint8 copy to the host is queued
        behind its decode, so it rides under the next chunk's decode. On a
        mesh a chunk is one decoder chunk a rank."""
        c = self.bundle.vae_dec.decode_chunk * (mesh.size if mesh is not None else 1)
        parts = [self._decode(latents[i:i + c], mesh).to("cpu", non_blocking=True)
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
        time_ids=None,  # (6,) SDXL's added time ids, where the UNets take them
        pooled=None,  # (1, 1280) SDXL's pooled vector, where the UNets take it
    ):
        """Returns the fp32 latents (decode=False), uint8 frames (T', H, W, 3)
        on the device, or, with to_host=True, the uint8 frames as numpy;
        T' = (T - 1) * 2^(interpolation_factor - 1) + 1. On a mesh every rank
        returns the whole result. ``time_ids`` and ``pooled``: the added
        conditioning of UNets that have one (SDXL's "text_time"); the
        uncond half of CFG takes a zero pooled vector, as it takes a zero
        CLIP context, and so does every guidance position that takes the
        uncond context. SD1.5's UNets take none."""
        cfgc = self.config
        T, H_img, W_img = pose_frames.shape[:3]
        windows = ctx_sched.window_matrix(
            T, cfgc.context.frames, cfgc.context.stride, cfgc.context.overlap)
        mesh = self.mesh_for(2 * windows.shape[0], windows.shape[1])
        subset = mesh is not None and mesh.size < self.mesh.size
        if mesh is None or mesh.rank in mesh:
            with span("clip"):
                out = self._sample(ref_image, ref_skel, pose_frames, face_frames, hand_frames,
                                   scene_motion, clip_context, noise, windows, mesh,
                                   num_inference_steps, guidance_scale, decode,
                                   to_host and not subset, timer, time_ids, pooled)
        else:  # a rank the chosen mesh leaves out waits for the result
            f = cfgc.interpolation_factor
            n = T if f <= 1 else (T - 1) * 2 ** (f - 1) + 1
            out = (torch.empty((n, H_img, W_img, 3), dtype=torch.uint8, device=self.device)
                   if decode else torch.empty((n,) + tuple(noise.shape[1:]),
                                              dtype=torch.float32, device=self.device))
        if subset:
            out = self.mesh.broadcast(out, src=int(mesh.ranks.flat[0]))
            if decode and to_host:
                out = out.cpu().numpy()
        return out

    def _sample(self, ref_image, ref_skel, pose_frames, face_frames, hand_frames, scene_motion,
                clip_context, noise, windows: np.ndarray, mesh: Optional[Mesh],
                num_inference_steps, guidance_scale, decode: bool, to_host: bool, timer,
                time_ids=None, pooled=None):
        """``__call__``'s work on a rank of ``mesh`` (or on the one device)."""
        mark = timer.mark if timer is not None else (lambda name: None)
        if timer is not None:
            timer.start()
        cfgc = self.config
        steps = num_inference_steps or cfgc.num_inference_steps
        scale = cfgc.guidance_scale if guidance_scale is None else guidance_scale
        T = pose_frames.shape[0]
        dev = self.device
        nw, wf = windows.shape
        if cfgc.bank_mode not in ("auto", "cached", "per_step", "cached_q8"):
            raise ValueError(f"unknown bank_mode {cfgc.bank_mode!r}")
        if (time_ids is None) != (pooled is None):
            raise ValueError("the added conditioning takes both time_ids and pooled")

        # 1. VAE encodes. An absent face/hand stream (None), or a present
        # all-black uint8 one, is the reference CLI's black-frame fallback:
        # one black frame is encoded and its latent broadcast over T
        # (identical per-frame numerics, no T-frame transfer and encode).
        def collapse_black(frames):
            if isinstance(frames, np.ndarray) and frames.dtype == np.uint8 and not frames.any():
                return None
            return frames

        def as4(x):
            return x[None] if x.ndim == 3 else x

        with span("h2d_normalize"):
            face_frames, hand_frames = collapse_black(face_frames), collapse_black(hand_frames)
            H_img, W_img = pose_frames.shape[1:3]
            black = np.zeros((1, H_img, W_img, 3), np.uint8)
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
            mark("h2d_normalize")
        with span("vae_encode"):
            lat = encode_frames(self.bundle.vae_enc, all_frames, mesh=mesh)
            mark("vae_encode")
        o = 2 + T
        n_face = raw[3].shape[0]
        ref_l, skel_l, pose_l = lat[0:1], lat[1:2], lat[2:o]
        face_l, hand_l = lat[o:o + n_face], lat[o + n_face:]
        face_l = face_l.expand((T,) + face_l.shape[1:]) if n_face == 1 else face_l
        hand_l = hand_l.expand((T,) + hand_l.shape[1:]) if hand_l.shape[0] == 1 else hand_l
        cond20 = build_condition_stack(ref_l, skel_l, pose_l, face_l, hand_l)
        del all_frames, lat

        # 2. bank residency: cache the banks of every (window, position)
        # where they fit (computed once, reused across steps), else recompute
        # them per step in window groups (see _denoise_streamed). cached_q8
        # keeps one int8 entry per unique (frame, context variant). The
        # denoiser runs over window groups where one UNet batch over every
        # window (a rank's share of it on a mesh) would pass
        # max_denoise_frame_batch. A mesh keeps the cached banks sharded,
        # each rank those of its block or of its windows, so their budget
        # scales with it; not where one window is past the UNet-batch budget
        # and every rank runs every window.
        counts = torch.as_tensor(ctx_sched.frame_counts(windows, T), dtype=torch.float32,
                                 device=dev)
        flat = torch.as_tensor(windows.reshape(-1), dtype=torch.long, device=dev)
        ctx_cond = torch.as_tensor(clip_context, device=dev).float()
        gdt = _dtype(self.bundle.guide)
        motion = torch.as_tensor(scene_motion, device=dev)
        noise = torch.as_tensor(noise, device=dev)
        q8 = cfgc.bank_mode == "cached_q8"
        n_mesh = mesh.size if mesh is not None else 1
        # the bank budget in this UNet's positions (SD1.5's: cached_bank_positions)
        bank_pos = bank_position_budget(cfgc.cached_bank_positions, self.bundle.den.cfg.unet,
                                        *noise.shape[1:3])
        grouped = q8 or (nw > 1 and nw * wf > cfgc.max_denoise_frame_batch * n_mesh)
        alike = grouped and wf > cfgc.max_denoise_frame_batch
        budget = bank_pos * (1 if alike else n_mesh)
        per_step = cfgc.bank_mode == "per_step" or (cfgc.bank_mode == "auto" and nw * wf > budget)
        # the grouped tiers on a mesh: window groups split over its ranks;
        # where the group count does not split, zero-weight pad windows (the
        # first window again) make it split, as long as one window fits the
        # budget (bank memory for per-step banks, else the UNet batch)
        stream_mesh, win_eff, win_w = None, windows, None
        if (per_step or grouped) and mesh is not None:
            budget_pos = bank_pos if per_step else cfgc.max_denoise_frame_batch
            if choose_bank_group(nw, wf, budget_pos, mesh.size):
                stream_mesh = mesh
            elif wf <= budget_pos:
                pad = (-nw) % mesh.size  # a group of one window always splits then
                win_eff = np.concatenate([windows, np.repeat(windows[:1], pad, axis=0)])
                win_w = np.concatenate([np.ones(nw, np.float32), np.zeros(pad, np.float32)])
                stream_mesh = mesh
            else:
                kind = "bank" if per_step else "UNet-batch"
                print(f"bank streaming: one {wf}-frame window exceeds the {budget_pos}-position "
                      f"{kind} budget; denoise runs on every rank alike, window by window")
        nw_eff = win_eff.shape[0]
        n_sh = stream_mesh.size if stream_mesh is not None else 1
        g_ctx = guidance_context_for_windows(
            win_eff, ctx_cond, torch.zeros_like(ctx_cond), cfgc.guidance_clip_mode).to(gdt)
        # the added conditioning (SDXL): the denoiser's (uncond, cond) halves
        # and the guidance UNet's per position, each projected once a clip
        added, g_add, add_of = None, None, None
        if pooled is not None:
            tid = torch.as_tensor(np.asarray(time_ids), device=dev).float().reshape(1, -1)
            pool = torch.as_tensor(pooled, device=dev).float().reshape(1, -1)
            den = self.bundle.den
            added = (den.added_embedding(tid, torch.zeros_like(pool)),
                     den.added_embedding(tid, pool))

            def add_of(uncond: np.ndarray) -> torch.Tensor:  # per position, guidance UNet's
                u = torch.as_tensor(uncond, device=dev)[:, None]
                return self.bundle.guide.added_embedding(
                    tid.expand(u.shape[0], -1), torch.where(u, torch.zeros_like(pool), pool))

            g_add = add_of(context_variants(win_eff, cfgc.guidance_clip_mode))
        ts, prev_ts = inference_step_pairs(self.schedule, steps,
                                           spacing=cfgc.scheduler.timestep_spacing)

        # 3. the loop over DDIM steps
        if per_step:
            with span("denoise_streamed"):
                group = choose_bank_group(nw_eff, wf, bank_pos, n_sh)
                latents = self._denoise_streamed(noise, cond20, motion, ctx_cond, g_ctx,
                                                 win_eff, counts, ts, prev_ts, float(scale),
                                                 group, win_w=win_w, mesh=stream_mesh,
                                                 added=added, g_add=g_add)
                mark("denoise_streamed")
        else:
            with span("guidance_banks"):
                bank_idx = None
                if q8:
                    u_frames, u_uncond, bank_idx = unique_bank_index(win_eff,
                                                                     cfgc.guidance_clip_mode)
                    u_frames = torch.as_tensor(u_frames, dtype=torch.long, device=dev)
                    u_mask = torch.as_tensor(u_uncond, device=dev)[:, None, None]
                    g_ctx_u = torch.where(u_mask, torch.zeros_like(ctx_cond), ctx_cond).to(gdt)
                    banks = self._compute_banks_q8(cond20[u_frames].to(gdt),
                                                   motion[u_frames].to(gdt), g_ctx_u,
                                                   chunk=bank_pos, mesh=mesh,
                                                   g_add=None if add_of is None
                                                   else add_of(u_uncond))
                elif grouped and stream_mesh is not None:  # the banks of this rank's windows
                    per = nw_eff // stream_mesh.size * wf
                    mine = slice(stream_mesh.index() * per, (stream_mesh.index() + 1) * per)
                    f = torch.as_tensor(win_eff.reshape(-1)[mine], dtype=torch.long, device=dev)
                    banks = self._compute_banks(cond20[f].to(gdt), motion[f].to(gdt),
                                                g_ctx[mine],
                                                g_add=None if g_add is None else g_add[mine])
                else:  # every window's banks; on a mesh, those of this rank's UNet block
                    spmd = None if grouped else mesh
                    need = None if spmd is None else [_block_positions(mesh, nw, wf, j)
                                                      for j in range(mesh.size)]
                    banks = self._compute_banks(cond20[flat].to(gdt), motion[flat].to(gdt),
                                                g_ctx, mesh=spmd, need=need, g_add=g_add)
                mark("guidance_banks")
            with span("denoise"):
                if grouped:
                    # cached-grouped: every bank fits, one UNet batch over every
                    # window does not (two 30-frame windows at 768^2)
                    group = choose_bank_group(nw_eff, wf, cfgc.max_denoise_frame_batch,
                                              n_sh) or 1
                    latents = self._denoise_streamed(noise, cond20, motion, ctx_cond, g_ctx,
                                                     win_eff, counts, ts, prev_ts, float(scale),
                                                     group, banks_cached=banks,
                                                     bank_idx=bank_idx, win_w=win_w,
                                                     mesh=stream_mesh, added=added, g_add=g_add)
                else:
                    latents = self._denoise(noise, banks, ctx_cond, windows, counts, ts,
                                            prev_ts, float(scale), mesh=mesh, added=added)
                del banks  # gigabytes of cached banks, freed before the decode
                mark("denoise")
        # 4. optional latent frame-rate upsampling (`pipeline_mikudance.py:688`)
        if cfgc.interpolation_factor > 1:
            latents = interpolate_latents(latents, cfgc.interpolation_factor,
                                          cfgc.interpolation_mode)

        if not decode:
            return latents
        if to_host:
            with span("decode_d2h"):
                out = self.decode_to_host(latents, mesh)
                mark("decode_d2h")
            return out
        with span("decode"):
            out = self._decode(latents, mesh)
            mark("decode")
        return out
