"""Motion-Adaptive Normalization (SPADE-style), channels-last.

Port of ``mikudance_tpu/models/man.py`` (reference ``MANModule``,
`man_module.py:7-33`): instance-norm the features, then predict per-pixel
(gamma, beta) from the nearest-resized 2-channel scene-motion map through a
shared 3x3 conv MLP: ``out = IN(x) * (1 + gamma) + beta``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import conv3x3, conv_nhwc


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalization over H, W (torch InstanceNorm2d,
    affine=False, default eps 1e-5), on (B, H, W, C)."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def resize_nearest(m: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest-neighbor resize of (B, H, W, C) to (B, h, w, C) with torch
    ``F.interpolate(mode="nearest")`` index arithmetic (floor(i * in / out))."""
    B, H, W, C = m.shape
    rows = torch.arange(h, device=m.device) * H // h
    cols = torch.arange(w, device=m.device) * W // w
    return m[:, rows][:, :, cols]


class MANBlock(nn.Module):
    def __init__(self, channels: int, motion_channels: int = 2, nhidden: int = 128):
        super().__init__()
        self.mlp_shared = nn.Sequential(conv3x3(motion_channels, nhidden), nn.ReLU())
        self.mlp_gamma = conv3x3(nhidden, channels)
        self.mlp_beta = conv3x3(nhidden, channels)

    def forward(self, x: torch.Tensor, motion_map: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) features; motion_map: (B, Hm, Wm, 2)."""
        normalized = instance_norm(x)
        m = resize_nearest(motion_map, x.shape[1], x.shape[2]).to(x.dtype)
        actv = F.relu(conv_nhwc(self.mlp_shared[0], m))
        gamma = conv_nhwc(self.mlp_gamma, actv)
        beta = conv_nhwc(self.mlp_beta, actv)
        return normalized * (1.0 + gamma) + beta
