"""AnimateDiff-style temporal motion module on (B, T, H, W, C) video.

Port of ``mikudance_tpu/models/motion_module.py`` (reference
``VanillaTemporalModule`` -> ``TemporalTransformer3DModel`` ->
``TemporalTransformerBlock`` -> ``VersatileAttention``,
`motion_module.py:45,96,194,293`), in the reference's key grammar
(``temporal_transformer.transformer_blocks.{b}.attention_blocks.{a}``):

- tokens stay (B, T, P=H*W, C) end to end; the temporal attention kernel
  reads that layout in place, so frames never swap with positions in memory;
- the sinusoidal positional encoding (max_len 32) is added to the query
  path only: K/V come from the pre-PE tokens (`motion_module.py:404-417`);
- ``proj_out`` starts at zero, so a fresh module is the identity.

Frame sharding (``frame_axis``, a ``core.mesh.Axis``): when the frames of
the map are split over the ranks of a mesh axis, everything here but the
temporal attention is frame-local. One ``all_to_all`` turns frame-local
tokens into position-sharded tokens that hold every frame, the attention
blocks run on whole sequences with the whole positional encoding, and the
inverse ``all_to_all`` restores the frame split; where the positions do not
split over the ranks (tiny deep levels), the frames are gathered, every rank
computes all of them and keeps its own. Both give the unsharded result.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.mesh import Axis
from .layers import Attention, GEGLUFeedForward, GroupNorm, LayerNorm, remat_call


def temporal_positional_encoding(max_len: int, dim: int) -> np.ndarray:
    """Standard sinusoidal PE table (max_len, dim), float32."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float64) * (-math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


class TemporalAttentionLayer(Attention):
    """One VersatileAttention("Temporal_Self"): PE on queries, attend over T."""

    def __init__(self, dim: int, heads: int, max_len: int = 32, use_pe: bool = True):
        super().__init__(dim, heads)
        self.use_pe = use_pe
        self.register_buffer(
            "pe", torch.tensor(temporal_positional_encoding(max_len, dim)), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, P, C) pre-normed tokens."""
        kv = x  # pre-PE alias, replicating motion_module.py:404-417
        if self.use_pe:
            x = x + self.pe[: x.shape[1]].to(x.dtype)[None, :, None, :]
        return super().forward(x, kv)


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, attention_layers: int, max_len: int,
                 use_pe: bool, remat: bool = False):
        super().__init__()
        self.remat = remat  # nested: each attention layer and the feed-forward
        self.attention_blocks = nn.ModuleList(
            [TemporalAttentionLayer(dim, heads, max_len, use_pe)
             for _ in range(attention_layers)])
        self.norms = nn.ModuleList([LayerNorm(dim) for _ in range(attention_layers)])
        self.ff = GEGLUFeedForward(dim)
        self.ff_norm = LayerNorm(dim)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for attn, norm in zip(self.attention_blocks, self.norms):
            h = h + remat_call(self.remat, attn, norm(h))
        return h + remat_call(self.remat, self.ff, self.ff_norm(h))


class TemporalTransformer(nn.Module):
    def __init__(self, dim: int, heads: int, num_transformer_blocks: int,
                 attention_layers: int, max_len: int, use_pe: bool, norm_groups: int,
                 remat: bool = False):
        super().__init__()
        self.norm = GroupNorm(norm_groups, dim, 1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList(
            [TemporalTransformerBlock(dim, heads, attention_layers, max_len, use_pe, remat)
             for _ in range(num_transformer_blocks)])
        self.proj_out = nn.Linear(dim, dim)
        nn.init.zeros_(self.proj_out.weight)  # zero_initialize (reference :73-75)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x: torch.Tensor, frame_axis: Optional[Axis] = None) -> torch.Tensor:
        B, T, H, W, C = x.shape
        h = self.norm(x.reshape(B * T, H, W, C)).reshape(B, T, H * W, C)
        h = self.proj_in(h)
        sp = frame_axis.size if frame_axis is not None else 1
        gathered = sp > 1 and (H * W) % sp != 0
        if gathered:
            h = frame_axis.all_gather(h, dim=1)
        elif sp > 1:  # frame-local -> position-sharded, every frame present
            h = frame_axis.all_to_all(h, split_dim=2, concat_dim=1)
        for block in self.transformer_blocks:
            h = block(h)
        if gathered:
            i = frame_axis.index()
            h = h[:, i * T:(i + 1) * T]
        elif sp > 1:
            h = frame_axis.all_to_all(h, split_dim=1, concat_dim=2)
        h = self.proj_out(h).reshape(B, T, H, W, C)
        return h + x


class MotionModule(nn.Module):
    """Full temporal transformer applied to a (B, T, H, W, C) feature map."""

    def __init__(self, dim: int, heads: int = 8, num_transformer_blocks: int = 1,
                 attention_layers: int = 2, max_len: int = 32, use_pe: bool = True,
                 norm_groups: int = 32, remat: bool = False):
        super().__init__()
        self.temporal_transformer = TemporalTransformer(
            dim, heads, num_transformer_blocks, attention_layers, max_len, use_pe,
            norm_groups, remat)

    def forward(self, x: torch.Tensor, frame_axis: Optional[Axis] = None) -> torch.Tensor:
        """x: (B, T, H, W, C), the rank's T frames where ``frame_axis``
        shards them."""
        return self.temporal_transformer(x, frame_axis)
