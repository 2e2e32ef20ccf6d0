"""Resnet blocks and spatial up/down sampling on channels-last tensors.

Port of ``mikudance_tpu/models/resnet.py``. Frames are folded into the
batch axis upstream (the reference's "inflated" 3-D convs are 2-D convs on
``(b f) c h w``), so everything here is 2-D on (B*T, H, W, C). Convolutions
run through ``conv_nhwc``: a channels-last tensor viewed as NCHW is what
cuDNN's channels-last kernels take, so no layout copy is made. While
``kernels.conv2d.PREFER_PALLAS`` is set it sends the stride-1 3x3 convolutions
to the fused kernel instead, as the JAX package's ``conv3x3`` does
(``models/resnet.py:40-53``); the UNets, MAN, the SD VAE and the temporal
decoder all convolve through this one helper.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import conv2d as _conv2d
from .layers import GroupNorm


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply a torch ``Conv2d`` (OIHW weights) to an NHWC tensor. The result
    is contiguous NHWC (what the norm kernels take): a channels-last input
    gives a channels-last output, so ``contiguous`` copies only if a backend
    answered in NCHW. With ``conv2d.PREFER_PALLAS`` set (read at every call),
    a convolution that ``conv2d.applicable`` accepts goes to ``conv3x3_fused``
    with the module's weights, repacked once."""
    if _conv2d.PREFER_PALLAS and _conv2d.applicable(conv, x):
        packed = _conv2d.packed_weight(conv) if x.device.type == "cuda" else None
        return _conv2d.conv3x3_fused(x.contiguous(), conv.weight, conv.bias, packed)
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()


def conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    # padding=1 on both sides for every stride: torch's Conv2d(k=3, p=1),
    # which the JAX package spells as explicit ((1, 1), (1, 1)) padding.
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


class ResnetBlock(nn.Module):
    """GN-silu-conv -> +time -> GN-silu-conv, with 1x1 shortcut on width change."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, norm_groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(norm_groups, in_channels, eps, silu=True)
        self.conv1 = conv3x3(in_channels, out_channels)
        if temb_channels:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(norm_groups, out_channels, eps, silu=True)
        self.conv2 = conv3x3(out_channels, out_channels)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = conv_nhwc(self.conv1, self.norm1(x))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = conv_nhwc(self.conv2, self.norm2(h))
        if hasattr(self, "conv_shortcut"):
            x = conv_nhwc(self.conv_shortcut, x)
        return x + h


class Downsample(nn.Module):
    """3x3 stride-2 conv with (1, 1) padding (``downsamplers.0.conv``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(self.conv, x)


def nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor 2x spatial upsample of (B, H, W, C) in one copy."""
    B, H, W, C = x.shape
    return x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)


class Upsample(nn.Module):
    """Nearest 2x + 3x3 conv (``upsamplers.0.conv``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(self.conv, nearest_2x(x))
