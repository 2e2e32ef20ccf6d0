"""CLIP ViT-L/14 vision tower with projection.

Port of ``mikudance_tpu/models/clip_vision.py``: the
``CLIPVisionModelWithProjection`` image encoder of sd-image-variations as the
reference pipeline uses it (`pipeline_mikudance.py:405-417`). The image prompt
is the FULL 257-token sequence — ``last_hidden_state`` -> ``post_layernorm``
-> ``visual_projection`` -> (B, 257, 768) — not the pooled class token.

Parameter names follow the Hugging Face checkpoint
(``vision_model.embeddings.*``, ``vision_model.pre_layrnorm`` spelt as there,
``vision_model.encoder.layers.{i}.self_attn.q_proj``, ``visual_projection``),
so a released ``state_dict`` loads with no converter.

Attention is 16 heads of 64 over 257 tokens: below the flash kernels'
1024-token threshold, so the dispatcher's plain route, as in the JAX
package. The LayerNorms are the port's ``LayerNorm`` (kernel K6 on the card).

Also here: the CLIPImageProcessor constants and ``clip_image_tokens``, the
step from a reference picture to the tower's tokens.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.configs import CLIPVisionConfig
from ..core.params import resolve_device
from .layers import LayerNorm, run_attention
from .resnet import conv_nhwc

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    """q/k/v/out projections, all with bias."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_proj(run_attention(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                                           self.heads))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, inner)
        self.fc2 = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.randn(cfg.hidden_size) * 0.02)
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(n_pos, cfg.hidden_size)
        nn.init.normal_(self.position_embedding.weight, std=0.02)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        B = pixel_values.shape[0]
        patches = conv_nhwc(self.patch_embedding, pixel_values.to(self.class_embedding.dtype))
        patches = patches.reshape(B, -1, patches.shape[-1])
        cls = self.class_embedding.expand(B, 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight[None]


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class _VisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.pre_layrnorm(self.embeddings(pixel_values))
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x)


class CLIPVisionTower(nn.Module):
    """pixel_values (B, 224, 224, 3), CLIP-normalized, channels last ->
    the projected full token sequence (B, 1 + patches, projection_dim)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionModel(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.visual_projection(self.vision_model(pixel_values))


def to_clip_input(img, size: int = 224) -> np.ndarray:
    """A picture -> (1, size, size, 3) CLIP-normalized float32, resized with
    an antialiased bicubic filter as CLIPImageProcessor does. A PIL image is
    resized by PIL itself; an (H, W, 3) uint8 array by torch's antialiased
    bicubic (the same a = -0.5 kernel, rounded to uint8 levels as PIL does)."""
    if hasattr(img, "convert"):  # a PIL image; 3 is PIL's BICUBIC
        x = np.asarray(img.convert("RGB").resize((size, size), 3), dtype=np.float32)
    else:
        t = torch.from_numpy(np.asarray(img, dtype=np.uint8)).permute(2, 0, 1)[None].float()
        t = F.interpolate(t, size=(size, size), mode="bicubic", antialias=True,
                          align_corners=False)
        x = t.round().clamp(0, 255)[0].permute(1, 2, 0).numpy()
    return ((x / 255.0 - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD)[None].astype(np.float32)


@torch.inference_mode()
def clip_image_tokens(tower: CLIPVisionTower, ref_image,
                      device: Optional[torch.device] = None) -> np.ndarray:
    """Reference picture (PIL image or (H, W, 3) uint8) -> (1, 257, 768)
    float32 CLIP tokens on the host, what ``VideoPipeline`` takes as
    ``clip_context``. ``device=None`` means the card and raises where there is
    none; the tower is moved there."""
    dev = resolve_device(device)
    tower = tower.to(dev)
    pixels = torch.from_numpy(to_clip_input(ref_image, tower.cfg.image_size)).to(dev)
    return tower(pixels).float().cpu().numpy()
