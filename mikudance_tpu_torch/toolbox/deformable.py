"""Multi-scale deformable attention (UniPose / Deformable-DETR core op).

Port of ``mikudance_tpu/toolbox/deformable.py``. The reference implements
this op as a CUDA extension with a pure-PyTorch numerical spec
(``ms_deform_attn_core_pytorch``, ``grid_sample``-based); this is that spec,
on either device:

- ``ms_deform_attn``: bilinear ``F.grid_sample`` (``padding_mode="zeros"``,
  ``align_corners=False``) at ``2 * loc - 1``, per level, weighted and summed
  over levels and points, streamed over chunks of ``Q_CHUNK`` queries so the
  800^2 encoder's 13294 queries never hold every sample at once;
- ``toolbox.native.ms_deform_attn_cpu``: the port's C++ CPU kernel, the
  second implementation it is held to.

Semantics (the reference spec): sampling locations are in [0, 1] per level;
bilinear sampling uses align_corners=False with zero padding outside; output
is the attention-weighted sum over levels and points.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

# Queries per chunk, as the JAX package's ``Q_CHUNK``: one chunk's samples at
# the 800^2 encoder (10 frames, 8 heads of 32, 4 points) are ~84 MB a level.
Q_CHUNK = 2048


def ms_deform_attn(
    value: torch.Tensor,  # (B, S, H_heads, D), S = sum(h_l * w_l)
    spatial_shapes: Sequence[Tuple[int, int]],  # [(h, w)] per level
    sampling_locations: torch.Tensor,  # (B, Q, H_heads, L, P, 2) in [0,1]
    attention_weights: torch.Tensor,  # (B, Q, H_heads, L, P)
    q_chunk: int = None,
) -> torch.Tensor:
    """Returns (B, Q, H_heads * D)."""
    B, S, Hh, D = value.shape
    Q, L, P = sampling_locations.shape[1], sampling_locations.shape[3], sampling_locations.shape[4]
    q_chunk = q_chunk or Q_CHUNK

    # per-level (B * Hh, D, h, w) value maps, built once per call
    maps = []
    offset = 0
    for h, w in spatial_shapes:
        v = value[:, offset: offset + h * w]  # (B, hw, Hh, D)
        maps.append(v.permute(0, 2, 3, 1).reshape(B * Hh, D, h, w))
        offset += h * w

    chunks = []
    for q0 in range(0, Q, q_chunk):
        loc = sampling_locations[:, q0: q0 + q_chunk]
        wts = attention_weights[:, q0: q0 + q_chunk]
        q = loc.shape[1]
        out = value.new_zeros(B * Hh, D, q)
        for lvl, v in enumerate(maps):
            grid = loc[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(B * Hh, q, P, 2)
            sampled = F.grid_sample(v, 2 * grid - 1, mode="bilinear", padding_mode="zeros",
                                    align_corners=False)  # (B * Hh, D, q, P)
            wt = wts[:, :, :, lvl].permute(0, 2, 1, 3).reshape(B * Hh, 1, q, P)
            out = out + (sampled * wt).sum(-1)
        chunks.append(out)
    out = torch.cat(chunks, dim=-1)  # (B * Hh, D, Q)
    return out.reshape(B, Hh, D, Q).permute(0, 3, 1, 2).reshape(B, Q, Hh * D)
