"""Camera trajectory + depth -> 2-channel scene-motion flow field.

Port of ``mikudance_tpu/pipelines/scene_motion.py`` (reference
``camera_to_scene_motion``, `tools/scene_motion_tracking.py:14-67`):
back-project a latent-resolution pixel grid at depth ``z = 100 - 50*depth``,
transform frame t's points by ``w2c[t+1] @ c2w[t]``, re-project through the
pinhole K, and take the 2-D displacement. 3-sigma clipping; frame 0 is zero
flow. Output layout is (T, h, w, 2), channels last (the reference emits
(T, 2, h, w)). ``scene_motion_flow`` runs in torch on the card unless the
caller names another device; ``scene_motion_flow_np`` is its host-only
float64 numpy twin.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.params import resolve_device

# Pinhole intrinsics used at inference (reference `scripts/inference_video.py:185`).
DEFAULT_K = (3.2, 3.2, 1.6, 1.6)


def _k_matrix(K) -> np.ndarray:
    fx, fy, cx, cy = K
    M = np.zeros((3, 4))
    M[0, 0], M[1, 1], M[0, 2], M[1, 2], M[2, 2] = fx, fy, cx, cy, 1.0
    return M


def scene_motion_flow(w2c, c2w, depth, K=DEFAULT_K, device=None) -> torch.Tensor:
    """w2c, c2w: (T, 4, 4); depth: (h, w) in [0, 1]; arrays or tensors.
    Returns (T, h, w, 2) float32 flow on ``device``; frame 0 is zero.
    ``device=None`` means the device of ``depth`` where that is a tensor, else
    the card, and raises where there is none: a run on the CPU from arrays is
    asked for by name (``device="cpu"``)."""
    if device is None and isinstance(depth, torch.Tensor):
        device = depth.device
    device = resolve_device(device)
    w2c, c2w, depth = (torch.as_tensor(a, dtype=torch.float32, device=device)
                       for a in (w2c, c2w, depth))
    T = w2c.shape[0]
    h, w = depth.shape
    Km = torch.as_tensor(_k_matrix(K), dtype=torch.float32, device=device)

    # Python floor-division semantics, matching the reference's
    # ``np.arange(-width // 2, width // 2)`` (scene_motion_tracking.py:18-19):
    # for ODD sizes the grid starts at -(w+1)//2, not -(w//2).
    x0, y0 = -w // 2, -h // 2
    xs = torch.arange(x0, x0 + w, dtype=torch.float32, device=device)
    ys = torch.arange(y0, y0 + h, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")  # (h, w)
    zz = 100.0 - depth * 50.0
    pts = torch.stack([xx.reshape(-1), yy.reshape(-1), zz.reshape(-1),
                       torch.ones(h * w, device=device)], dim=-1)  # (hw, 4)

    img0 = pts @ Km.T  # (hw, 3)
    img0 = img0[:, :2] / img0[:, 2:3]

    world = torch.einsum("tij,aj->tai", c2w, pts)  # (T, hw, 4)
    cam = torch.einsum("tij,taj->tai", w2c[1:], world[:-1])
    img = torch.einsum("ij,taj->tai", Km, cam)
    img = img[..., :2] / img[..., 2:3]

    flow = img - img0[None]  # (T-1, hw, 2)
    mean, std = flow.mean(), flow.std(unbiased=False)
    clipped = torch.clamp(flow, mean - 3 * std, mean + 3 * std)
    # The reference zeroes the flow when it is non-finite (scene_motion_tracking.py:53-65).
    clipped = torch.where(torch.isfinite(flow).all(), clipped, torch.zeros_like(clipped))
    return torch.cat([torch.zeros((1, h, w, 2), dtype=flow.dtype, device=device),
                      clipped.reshape(T - 1, h, w, 2)], dim=0)


def scene_motion_flow_np(w2c, c2w, depth, K=DEFAULT_K) -> np.ndarray:
    """Pure-numpy twin in float64, same math and layout as the torch version."""
    T = w2c.shape[0]
    h, w = depth.shape
    Km = _k_matrix(K)

    x0, y0 = -w // 2, -h // 2  # Python floor division: reference grid origin
    xs = np.arange(x0, x0 + w, dtype=np.float64)
    ys = np.arange(y0, y0 + h, dtype=np.float64)
    xx, yy = np.meshgrid(xs, ys)
    zz = 100.0 - depth.astype(np.float64) * 50.0
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel(), np.ones(h * w)], axis=-1)

    img0 = pts @ Km.T
    img0 = img0[:, :2] / img0[:, 2:3]

    world = np.einsum("tij,aj->tai", np.asarray(c2w, np.float64), pts)
    cam = np.einsum("tij,taj->tai", np.asarray(w2c, np.float64)[1:], world[:-1])
    img = np.einsum("ij,taj->tai", Km, cam)
    img = img[..., :2] / img[..., 2:3]
    flow = img - img0[None]

    out = np.zeros((T, h, w, 2), dtype=np.float32)
    if np.isfinite(flow).all():
        mean, std = flow.mean(), flow.std()
        flow = np.clip(flow, mean - 3 * std, mean + 3 * std)
        out[1:] = flow.reshape(T - 1, h, w, 2)
    return out
