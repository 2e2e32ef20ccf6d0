"""The reference's inference algorithm (``serve.py``'s, step by step, fp32) on
the SDXL-geometry twins (``twins_xl.py``), with SDXL's added conditioning
handed to both UNets: the time ids the same everywhere; the pooled vector
where the CLIP context is the cond one, and zero where it is the uncond (zero)
one: in the denoiser's uncond pass, and at the guidance positions that the
reference's tiling gives the uncond context. The latents are scaled by the
configuration's VAE factor (SDXL's VAE: 0.13025).
"""

from __future__ import annotations

import numpy as np
import torch

from . import schedule as sch
from .serve import _nchw, encode_mean


def sample(nets, inputs, added, traffic: dict, config: dict, device) -> np.ndarray:
    """One clip: ``nets`` {"vae", "guide", "den"}; ``inputs`` the request as
    the XL driver makes it; ``added`` (time ids (6,), pooled (1, P)) as
    numpy. Returns uint8 frames (T, H, W, 3)."""
    ref_img, skel, pose, face, hand, motion, clip_ctx, noise = inputs
    vae, guide, den = nets["vae"], nets["guide"], nets["den"]
    scale = float(config["vae"]["scaling_factor"])
    T, H, W = pose.shape[:3]

    def unit(x):  # uint8 -> [0, 1]
        return _nchw(x.astype(np.float32) / 255.0, device)

    def stream(x):  # an absent or all-black stream: one black frame for all
        if x is None or not x.any():
            return encode_mean(vae, torch.zeros((1, 3, H, W), device=device), scale).expand(
                T, -1, -1, -1)
        return encode_mean(vae, unit(x), scale)

    ref_l = encode_mean(vae, _nchw(ref_img[None].astype(np.float32) / 127.5 - 1.0, device),
                        scale)
    skel_l = encode_mean(vae, unit(skel[None]), scale)
    pose_l = torch.cat([encode_mean(vae, unit(pose[i:i + 4]), scale) for i in range(0, T, 4)])
    cond20 = torch.cat([ref_l.expand(T, -1, -1, -1), skel_l.expand(T, -1, -1, -1), pose_l,
                        stream(face), stream(hand)], dim=1)
    motion_t = _nchw(motion.astype(np.float32), device)
    ctx_c = torch.from_numpy(clip_ctx.astype(np.float32)).to(device)
    ctx_u = torch.zeros_like(ctx_c)
    tid = torch.from_numpy(np.asarray(added[0], np.float32)).to(device).reshape(1, -1)
    pool_c = torch.from_numpy(np.asarray(added[1], np.float32)).to(device).reshape(1, -1)
    pool_u = torch.zeros_like(pool_c)

    ctx_cfg = config["context"]
    wins = sch.windows(T, ctx_cfg["frames"], ctx_cfg["overlap"], ctx_cfg.get("stride", 1))
    tiled = config["guidance_clip_mode"] == "reference_inference"
    banks = []
    for win in wins:
        f = len(win)
        uncond = [tiled and (f + k) % 2 == 0 for k in range(f)]
        g_ctx = torch.cat([ctx_u if u else ctx_c for u in uncond])
        g_pool = torch.cat([pool_u if u else pool_c for u in uncond])
        _, b = guide(cond20[win], torch.zeros(f, device=device), g_ctx,
                     motion_map=motion_t[win], write=True, added=(tid.expand(f, -1), g_pool))
        banks.append(b)

    ac = sch.alphas_cumprod(config["scheduler"])
    lat = _nchw(noise.astype(np.float32), device)
    for t, t_prev in sch.step_pairs(config["scheduler"], int(traffic["steps"])):
        sum_u, sum_c = torch.zeros_like(lat), torch.zeros_like(lat)
        count = torch.zeros((T, 1, 1, 1), device=device)
        for win, b in zip(wins, banks):
            f = len(win)
            t_b = torch.full((1,), float(t), device=device)
            pred_u, _ = den(lat[win], t_b, ctx_u, banks=None, T=f, added=(tid, pool_u))
            pred_c, _ = den(lat[win], t_b, ctx_c, banks=b, T=f, added=(tid, pool_c))
            sum_u[win] += pred_u
            sum_c[win] += pred_c
            count[win] += 1
        mean_u, mean_c = sum_u / count, sum_c / count
        v = mean_u + float(traffic["guidance_scale"]) * (mean_c - mean_u)
        lat = sch.ddim_step(v, t, t_prev, lat, ac)

    frames = []
    for i in range(T):
        img = vae.decoder(vae.post_quant_conv(lat[i:i + 1] / scale))
        frames.append(torch.round((img / 2 + 0.5).clamp(0, 1) * 255.0))
    return torch.cat(frames).permute(0, 2, 3, 1).to(torch.uint8).cpu().numpy()
