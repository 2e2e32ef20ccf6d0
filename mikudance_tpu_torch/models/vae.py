"""SD KL autoencoder (sd-vae-ft-mse geometry), channels-last.

Port of ``mikudance_tpu/models/vae.py`` in diffusers' ``AutoencoderKL`` key
grammar: ``Encoder`` holds ``encoder.*`` and ``quant_conv``, ``Decoder``
holds ``post_quant_conv`` and ``decoder.*``. Geometry: f8,
block_out_channels (128, 256, 512, 512), 2 layers per block, a single-head
mid-block attention, GroupNorm eps 1e-6, and torch's asymmetric (0, 1)
downsample padding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.configs import VAEConfig
from .layers import GroupNorm, run_attention
from .resnet import conv3x3, conv_nhwc, nearest_2x


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, norm_groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(norm_groups, in_channels, 1e-6, silu=True)
        self.conv1 = conv3x3(in_channels, out_channels)
        self.norm2 = GroupNorm(norm_groups, out_channels, 1e-6, silu=True)
        self.conv2 = conv3x3(out_channels, out_channels)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv_nhwc(self.conv2, self.norm2(conv_nhwc(self.conv1, self.norm1(x))))
        if hasattr(self, "conv_shortcut"):
            x = conv_nhwc(self.conv_shortcut, x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head self-attention over spatial positions (mid block): at
    768^2 a 9216-token attention of head width 512."""

    def __init__(self, channels: int, norm_groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(norm_groups, channels, 1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        h = self.group_norm(x).reshape(B, H * W, C)
        h = run_attention(self.to_q(h), self.to_k(h), self.to_v(h), 1)
        return x + self.to_out[0](h).reshape(B, H, W, C)


class VAEDownsample(nn.Module):
    """Asymmetric (0, 1) pad + 3x3 stride-2 conv (torch VAE downsampler)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(self.conv, F.pad(x, (0, 0, 0, 1, 0, 1)))


class VAEUpsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(self.conv, nearest_2x(x))


class _Stage(nn.Module):
    """A down/up block: ``resnets`` then an optional ``downsamplers``/``upsamplers``."""

    def __init__(self, resnets, sampler=None, down: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            setattr(self, "downsamplers" if down else "upsamplers", nn.ModuleList([sampler]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        for name in ("downsamplers", "upsamplers"):
            if hasattr(self, name):
                x = getattr(self, name)[0](x)
        return x


class _Mid(nn.Module):
    def __init__(self, channels: int, norm_groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [VAEResnetBlock(channels, channels, norm_groups) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, norm_groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _EncoderBody(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, g, L = cfg.block_out_channels, cfg.norm_num_groups, cfg.layers_per_block
        self.conv_in = conv3x3(cfg.in_channels, ch[0])
        blocks, cin = [], ch[0]
        for i, c in enumerate(ch):
            resnets = [VAEResnetBlock(cin if j == 0 else c, c, g) for j in range(L)]
            blocks.append(_Stage(resnets, VAEDownsample(c) if i < len(ch) - 1 else None))
            cin = c
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _Mid(ch[-1], g)
        self.conv_norm_out = GroupNorm(g, ch[-1], 1e-6, silu=True)
        self.conv_out = conv3x3(ch[-1], 2 * cfg.latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv_nhwc(self.conv_in, x)
        for b in self.down_blocks:
            h = b(h)
        return conv_nhwc(self.conv_out, self.conv_norm_out(self.mid_block(h)))


class _DecoderBody(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g, L = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups, cfg.layers_per_block
        self.conv_in = conv3x3(cfg.latent_channels, rev[0])
        self.mid_block = _Mid(rev[0], g)
        blocks, cin = [], rev[0]
        for i, c in enumerate(rev):
            resnets = [VAEResnetBlock(cin if j == 0 else c, c, g) for j in range(L + 1)]
            blocks.append(_Stage(resnets, VAEUpsample(c) if i < len(rev) - 1 else None,
                                 down=False))
            cin = c
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(g, rev[-1], 1e-6, silu=True)
        self.conv_out = conv3x3(rev[-1], cfg.out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(conv_nhwc(self.conv_in, z))
        for b in self.up_blocks:
            h = b(h)
        return conv_nhwc(self.conv_out, self.conv_norm_out(h))


class Encoder(nn.Module):
    """Images (B, H, W, 3) in [-1, 1] -> moments (B, H/8, W/8, 8): [mean | logvar]."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = _EncoderBody(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.quant_conv.weight.dtype)
        return conv_nhwc(self.quant_conv, self.encoder(x))


class Decoder(nn.Module):
    """Unscaled latents (B, h, w, 4) -> images (B, 8h, 8w, 3) in about [-1, 1]."""

    # frames are independent; the chunk is a memory knob (the reference
    # decodes frame-at-a-time, `pipeline_mikudance.py:115-130`)
    decode_chunk = 4

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
        self.decoder = _DecoderBody(cfg)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        z = z.to(self.post_quant_conv.weight.dtype)
        return self.decoder(conv_nhwc(self.post_quant_conv, z))


def latent_mean(moments: torch.Tensor, latent_channels: int = 4) -> torch.Tensor:
    return moments[..., :latent_channels]
