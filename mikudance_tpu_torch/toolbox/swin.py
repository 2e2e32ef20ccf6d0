"""Swin Transformer backbone (Swin-T), channels-last.

Port of ``mikudance_tpu/toolbox/swin.py``: the UniPose backbone of the
reference XPose (``models/UniPose/swin_transformer.py:429``, built at ``:653``
as swin_T_224_1k: embed 96, depths (2,2,6,2), heads (3,6,12,24), window 7),
returning the stage 1..3 feature maps (``config_model/UniPose_SwinT.py``
return_interm_indices=[1,2,3]).

Parameter names follow the reference module (``patch_embed.proj``,
``layers.{i}.blocks.{j}.attn.qkv``, ``layers.{i}.downsample.reduction``,
``norm{i}``; ``attn.relative_position_index`` is a buffer of the
``state_dict`` there too), so ``core.convert.convert_swin`` reads this
module's ``state_dict`` as it reads a released checkpoint's.

Maps whose side is not a multiple of the window (800/4 = 200, 384/4 = 96)
are padded right and bottom before the window partition and cropped after;
shifted blocks roll by -shift before and +shift after, with the -100 mask
between regions. Attention is the plain einsum-and-softmax of the JAX
module, on stock ops.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def relative_position_index(window: int) -> np.ndarray:
    """(W^2, W^2) indices into the (2W-1)^2 bias table (swin_transformer.py)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, W^2, W^2)
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int64)


def shift_mask(H: int, W: int, window: int, shift: int) -> np.ndarray:
    """Attention mask for shifted windows (-100 off-region), (num_win, W^2, W^2)."""
    img = np.zeros((H, W))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(H // window, window, W // window, window)
    wins = wins.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def window_merge(x: torch.Tensor, w: int, B: int, H: int, W: int) -> torch.Tensor:
    C = x.shape[-1]
    x = x.reshape(B, H // w, W // w, w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(window)))

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x: (B_windows, W^2, C); mask: (num_win, W^2, W^2) or None."""
        Bw, N, C = x.shape
        hd = C // self.heads
        q, k, v = self.qkv(x).reshape(Bw, N, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        attn = torch.einsum("bhqd,bhkd->bhqk", q, k) * hd ** -0.5
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        attn = attn + bias.reshape(N, N, self.heads).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(Bw // nw, nw, self.heads, N, N) + mask[None, :, None]
            attn = attn.reshape(Bw, self.heads, N, N)
        out = torch.einsum("bhqk,bhkd->bhqd", attn.softmax(-1), v)
        return self.proj(out.transpose(1, 2).reshape(Bw, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))  # erf GELU


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        w, s = self.window, self.shift
        pad_h, pad_w = (-H) % w, (-W) % w
        h = F.pad(self.norm1(x), (0, 0, 0, pad_w, 0, pad_h))
        Hp, Wp = H + pad_h, W + pad_w
        mask = None
        if s > 0:
            h = torch.roll(h, (-s, -s), dims=(1, 2))
            mask = torch.from_numpy(shift_mask(Hp, Wp, w, s)).to(h)
        h = window_merge(self.attn(window_partition(h, w), mask), w, B, Hp, Wp)
        if s > 0:
            h = torch.roll(h, (s, s), dims=(1, 2))
        x = x + h[:, :H, :W]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, 4, stride=4)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H/4, W/4, C)."""
        return self.norm(self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            [SwinBlock(dim, heads, window, 0 if j % 2 == 0 else window // 2)
             for j in range(depth)])
        self.downsample = PatchMerging(dim) if downsample else None


class SwinTransformer(nn.Module):
    """Swin-T by default; returns stage features selected by out_indices."""

    def __init__(self, embed_dim: int = 96, depths: Tuple[int, ...] = (2, 2, 6, 2),
                 heads: Tuple[int, ...] = (3, 6, 12, 24), window: int = 7,
                 out_indices: Tuple[int, ...] = (1, 2, 3)):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            [BasicLayer(embed_dim * 2 ** i, d, heads[i], window, i < len(depths) - 1)
             for i, d in enumerate(depths)])
        for i in self.out_indices:
            self.add_module(f"norm{i}", nn.LayerNorm(embed_dim * 2 ** i, eps=1e-5))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (B, H, W, 3) -> list of (B, H/2^(i+2), W/2^(i+2), C_i) features."""
        x = self.patch_embed(x)
        outs: List[torch.Tensor] = []
        for i, layer in enumerate(self.layers):
            for block in layer.blocks:
                x = block(x)
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x))
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs

