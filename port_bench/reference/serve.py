"""The reference's inference algorithm (MikuDance ``pipeline_mikudance.py``),
step by step in plain PyTorch on the reference networks, fp32:

per-stream VAE encodes (latent means, scaled; an absent face or hand stream
is a black frame); the 20-channel condition stack [ref, skel, pose, face,
hand]; the guidance UNet per window at t = 0 writing the banks, its CLIP
context tiled [uncond, cond] over the window as the reference does (position
k of a window of f frames takes the uncond context where f + k is even) or
cond everywhere; per window and step the denoiser twice, uncond (zero context,
no banks) and cond (context, banks); the windows' predictions averaged per
frame, CFG, DDIM; each frame decoded and rounded to uint8.
"""

from __future__ import annotations

import numpy as np
import torch

from . import schedule as sch


def _nchw(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3))).to(device)


def encode_mean(vae, pixels: torch.Tensor, scale: float) -> torch.Tensor:
    """Scaled latent means of (N, 3, H, W) pixels."""
    return vae.quant_conv(vae.encoder(pixels))[:, :4] * scale


def sample(nets, inputs, traffic: dict, config: dict, device) -> np.ndarray:
    """One clip: ``nets`` {"vae", "guide", "den"}; ``inputs`` the request as
    the traffic generator makes it. Returns uint8 frames (T, H, W, 3)."""
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

    ctx_cfg = config["context"]
    wins = sch.windows(T, ctx_cfg["frames"], ctx_cfg["overlap"], ctx_cfg.get("stride", 1))
    tiled = config["guidance_clip_mode"] == "reference_inference"
    banks = []
    for win in wins:
        f = len(win)
        g_ctx = torch.cat([ctx_u if tiled and (f + k) % 2 == 0 else ctx_c for k in range(f)])
        _, b = guide(cond20[win], torch.zeros(f, device=device), g_ctx,
                     motion_map=motion_t[win], write=True)
        banks.append(b)

    ac = sch.alphas_cumprod(config["scheduler"])
    lat = _nchw(noise.astype(np.float32), device)
    for t, t_prev in sch.step_pairs(config["scheduler"], int(traffic["steps"])):
        sum_u, sum_c = torch.zeros_like(lat), torch.zeros_like(lat)
        count = torch.zeros((T, 1, 1, 1), device=device)
        for win, b in zip(wins, banks):
            f = len(win)
            t_b = torch.full((1,), float(t), device=device)
            pred_u, _ = den(lat[win], t_b, ctx_u, banks=None, T=f)
            pred_c, _ = den(lat[win], t_b, ctx_c, banks=b, T=f)
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
