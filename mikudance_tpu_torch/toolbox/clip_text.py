"""CLIP text encoder (ViT-B/32 text tower).

Port of ``mikudance_tpu/toolbox/clip_text.py``. UniPose embeds
instance/keypoint NAMES with CLIP's text encoder (the reference XPose's
``models/UniPose/unipose.py:122-124`` loads ViT-B/32; encodings are
projected into the detector at ``:332-344``). Geometry: vocab 49408, context
77, width 512, 12 layers, 8 heads, causal masking (-inf above the diagonal),
quick_gelu, EOT-token pooling (the position of the largest id, the first one
where the tokenizer pads with EOT) through ``text_projection``.

Parameter names follow the Hugging Face ``CLIPTextModelWithProjection``
(``text_model.encoder.layers.{i}.self_attn.q_proj``, ``text_projection``),
the grammar of ``openai/clip-vit-base-patch32``'s ``pytorch_model.bin`` that
``core.convert.convert_clip_text_hf`` reads; ``text_state_dict`` takes the
text tower's tensors out of that file.

Tokenization uses the byte-BPE vocab, which isn't shipped here; pass token ids
(e.g. from ``transformers.CLIPTokenizer`` when available).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
from torch import nn

from ._modules import Namespace


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)



class CLIPTextLayer(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.layer_norm1 = nn.LayerNorm(width, eps=1e-5)
        self.self_attn = Namespace(q_proj=nn.Linear(width, width), k_proj=nn.Linear(width, width),
                                    v_proj=nn.Linear(width, width),
                                    out_proj=nn.Linear(width, width))
        self.layer_norm2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = Namespace(fc1=nn.Linear(width, 4 * width), fc2=nn.Linear(4 * width, width))

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        hd = C // self.heads
        h = self.layer_norm1(x)
        a = self.self_attn
        q, k, v = (p(h).reshape(B, L, self.heads, hd) for p in (a.q_proj, a.k_proj, a.v_proj))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd) + causal
        o = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v).reshape(B, L, C)
        x = x + a.out_proj(o)
        return x + self.mlp.fc2(quick_gelu(self.mlp.fc1(self.layer_norm2(x))))


class CLIPTextEncoder(nn.Module):
    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 layers: int = 12, heads: int = 8):
        super().__init__()
        embeddings = Namespace(token_embedding=nn.Embedding(vocab_size, width),
                                position_embedding=nn.Embedding(context_length, width))
        nn.init.normal_(embeddings.token_embedding.weight, std=0.02)
        nn.init.normal_(embeddings.position_embedding.weight, std=0.01)
        self.text_model = Namespace(
            embeddings=embeddings,
            encoder=Namespace(layers=nn.ModuleList(
                [CLIPTextLayer(width, heads) for _ in range(layers)])),
            final_layer_norm=nn.LayerNorm(width, eps=1e-5))
        self.text_projection = nn.Linear(width, width, bias=False)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        """token_ids: (B, L) integer -> pooled text features (B, width)."""
        B, L = token_ids.shape
        tm = self.text_model
        x = tm.embeddings.token_embedding(token_ids) + tm.embeddings.position_embedding.weight[:L]
        causal = torch.full((L, L), float("-inf"), dtype=x.dtype, device=x.device).triu(1)
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        x = tm.final_layer_norm(x)
        pooled = x[torch.arange(B, device=x.device), token_ids.argmax(-1)]
        return self.text_projection(pooled)


def text_state_dict(src: Mapping) -> Dict[str, torch.Tensor]:
    """The text tower's tensors of a Hugging Face CLIP ``state_dict`` (a whole
    ``CLIPModel``'s included: ``vision_model.*``, ``visual_projection`` and
    ``logit_scale`` are left out, and the ``position_ids`` buffer older files
    hold)."""
    return {k: v for k, v in src.items()
            if (k.startswith("text_model.") and not k.endswith("position_ids"))
            or k == "text_projection.weight"}
