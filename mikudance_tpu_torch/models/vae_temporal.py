"""Temporal VAE decoder (SVD/Latte ``AutoencoderKLTemporalDecoder`` geometry).

Port of ``mikudance_tpu/models/vae_temporal.py``, in diffusers' key grammar
(``decoder.mid_block.resnets.{j}.spatial_res_block`` / ``.temporal_res_block``
/ ``.time_mixer.mix_factor``, ``decoder.up_blocks.{i}``,
``decoder.time_conv_out``). The reference's ``--video_decoder`` flag swaps the
SD VAE decoder for it, decoding 16-frame chunks with cross-frame temporal
convolutions (`pipeline_mikudance.py:132-150`). The encoder is the standard
SD encoder; only the decoder differs:

- SpatioTemporalResBlock = spatial ResnetBlock + temporal (3,1,1)-conv
  ResnetBlock over frames + learned sigmoid alpha blend.
- mid block: res -> single-head attention -> res; 4 up blocks of 3 resnets.
- final ``time_conv_out``: a (3,1,1) temporal conv on the RGB output.

Layout: the decoder takes one chunk (T, h, w, 4), channels last. The temporal
ResnetBlock's GroupNorms pool jointly over frames: the chunk goes through
the GroupNorm kernel as one image (1, T, H, W, C).

One chunk's frames on one device only: sharding a chunk's frames over
devices (halo exchange, summed moments) is multi-GPU work and not here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.configs import VAEConfig
from .layers import GroupNorm
from .resnet import conv3x3, conv_nhwc
from .vae import VAEAttention, VAEResnetBlock, VAEUpsample


class TemporalConv(nn.Conv3d):
    """torch ``Conv3d(C_in, C_out, kernel=(3,1,1), padding=(1,0,0))`` applied
    to (T, H, W, C): a 1-D conv along T with full channel mixing. It runs as
    a (3, 1) 2-D conv over the (T, H*W) plane, which in channels-last memory
    is the input as it lies."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T, H, W, C = x.shape
        plane = x.reshape(1, T, H * W, C).permute(0, 3, 1, 2)  # (1, C, T, H*W) view
        y = F.conv2d(plane, self.weight[..., 0], self.bias, padding=(1, 0))
        return y.permute(0, 2, 3, 1).reshape(T, H, W, self.out_channels)


class TemporalResnetBlock(nn.Module):
    """GN-silu-temporal conv twice, plus the input. torch applies GroupNorm
    to the (B, C, T, H, W) video tensor: the statistics pool over frames
    too, unlike the per-frame spatial norms."""

    def __init__(self, channels: int, norm_groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(norm_groups, channels, 1e-6, silu=True)
        self.conv1 = TemporalConv(channels, channels)
        self.norm2 = GroupNorm(norm_groups, channels, 1e-6, silu=True)
        self.conv2 = TemporalConv(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x[None])[0])
        h = self.conv2(self.norm2(h[None])[0])
        return x + h


class _TimeMixer(nn.Module):
    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.tensor([0.5]))


class SpatioTemporalResBlock(nn.Module):
    """Spatial resnet -> temporal resnet -> learned alpha blend (diffusers
    ``SpatioTemporalResBlock`` with merge_strategy="learned")."""

    def __init__(self, in_channels: int, out_channels: int, norm_groups: int = 32):
        super().__init__()
        self.spatial_res_block = VAEResnetBlock(in_channels, out_channels, norm_groups)
        self.temporal_res_block = TemporalResnetBlock(out_channels, norm_groups)
        self.time_mixer = _TimeMixer()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spatial = self.spatial_res_block(x)  # frames are the batch axis
        temporal = self.temporal_res_block(spatial)
        alpha = torch.sigmoid(self.time_mixer.mix_factor.float())[0].to(spatial.dtype)
        return alpha * spatial + (1.0 - alpha) * temporal


class _TemporalMid(nn.Module):
    def __init__(self, channels: int, norm_groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(channels, channels, norm_groups) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, norm_groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _TemporalUp(nn.Module):
    def __init__(self, in_channels: int, channels: int, layers: int, norm_groups: int,
                 upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(in_channels if j == 0 else channels, channels, norm_groups)
             for j in range(layers)])
        if upsample:
            self.upsamplers = nn.ModuleList([VAEUpsample(channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        return self.upsamplers[0](x) if hasattr(self, "upsamplers") else x


class _TemporalDecoderBody(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups  # (512, 512, 256, 128)
        self.conv_in = conv3x3(cfg.latent_channels, rev[0])
        self.mid_block = _TemporalMid(rev[0], g)
        blocks, cin = [], rev[0]
        for i, c in enumerate(rev):
            blocks.append(_TemporalUp(cin, c, cfg.layers_per_block + 1, g, i < len(rev) - 1))
            cin = c
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(g, rev[-1], 1e-6, silu=True)
        self.conv_out = conv3x3(rev[-1], cfg.out_channels)
        self.time_conv_out = TemporalConv(cfg.out_channels, cfg.out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(conv_nhwc(self.conv_in, z))
        for b in self.up_blocks:
            h = b(h)
        return self.time_conv_out(conv_nhwc(self.conv_out, self.conv_norm_out(h)))


class TemporalDecoder(nn.Module):
    """Drop-in replacement for ``models.vae.Decoder``: one chunk of unscaled
    latents (T, h, w, 4) -> images (T, 8h, 8w, 3) in about [-1, 1]."""

    # The chunk size is part of the numerical contract: temporal convs couple
    # the frames of a chunk, so 16 matches the reference
    # (`pipeline_mikudance.py:81,132-150`).
    decode_chunk = 16
    frames_coupled = True

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.decoder = _TemporalDecoderBody(cfg)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z.to(self.decoder.conv_in.weight.dtype))
