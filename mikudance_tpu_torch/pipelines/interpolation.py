"""Latent frame interpolation (linear / slerp).

Port of ``mikudance_tpu/pipelines/interpolation.py`` (reference
`src/pipelines/utils.py:6-29` and the pipeline's ``interpolate_latents``,
`pipeline_mikudance.py:317-360`): inserts ``2^(factor-1) - 1`` interpolated
latents between consecutive frames to upsample the frame rate post-hoc.
Slerp is the default and factor=1 is the no-op.
"""

from __future__ import annotations

import torch


def lerp(v0: torch.Tensor, v1: torch.Tensor, t) -> torch.Tensor:
    return (1.0 - t) * v0 + t * v1


def slerp(v0: torch.Tensor, v1: torch.Tensor, t, dot_threshold: float = 0.9995):
    """Spherical interpolation over the last axis (flattened latents,
    utils.py:19-29); leading axes are batch, ``t`` broadcasts against them.
    Nearly parallel pairs (|cos| > ``dot_threshold``) fall back to lerp."""
    n0 = torch.linalg.vector_norm(v0, dim=-1, keepdim=True)
    n1 = torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
    d = torch.clamp(((v0 / n0) * (v1 / n1)).sum(dim=-1, keepdim=True), -1.0, 1.0)
    theta = torch.arccos(d) * t
    v2 = v1 - v0 * d
    norm = torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
    v2 = torch.where(norm > 1e-12, v2 / torch.clamp(norm, min=1e-12), torch.zeros_like(v2))
    slerped = v0 * torch.cos(theta) + v2 * torch.sin(theta) * n0
    return torch.where(d.abs() > dot_threshold, lerp(v0, v1, t), slerped)


def interpolate_latents(latents: torch.Tensor, factor: int, mode: str = "slerp") -> torch.Tensor:
    """latents (T, h, w, c) -> ((T-1) * 2^(factor-1) + 1, h, w, c): every
    (pair, t) combination in one batched expression (the reference loops
    pairs in Python, `pipeline_mikudance.py:330-356`)."""
    if factor <= 1:
        return latents
    fn = slerp if mode == "slerp" else lerp
    n_insert = 2 ** (factor - 1) - 1
    T = latents.shape[0]
    a = latents[:-1].reshape(T - 1, 1, -1)  # (T-1, 1, D)
    b = latents[1:].reshape(T - 1, 1, -1)
    ts = torch.arange(1, n_insert + 1, dtype=torch.float32, device=latents.device) / (n_insert + 1)
    mids = fn(a, b, ts[None, :, None])  # (T-1, n, D)
    seq = torch.cat([a, mids.to(a.dtype)], dim=1)  # (T-1, 1+n, D)
    out = torch.cat([seq.reshape((T - 1) * (1 + n_insert), -1), b[-1]], dim=0)
    return out.reshape((-1,) + latents.shape[1:])
