"""UniPose: open-vocabulary keypoint detector (inference forward).

Port of ``mikudance_tpu/toolbox/unipose.py``, the rebuild of the reference
XPose's *live inference path* (``models/UniPose/unipose.py:35,316`` +
``deformable_transformer.py:38`` + ``fuse_modules.py:100,243`` +
``transformer_vanilla.py:62``) with the computation graph of the
UniPose_SwinT build (``config_model/UniPose_SwinT.py``: hidden 256, 6 enc +
6 dec layers, 8 heads, 4 feature levels, 4 points, 900 queries,
dim_feedforward 2048, two_stage 'standard', embed_init_tgt, text enhancer +
fusion + text cross-attention, num_body_points 68).

Flow:
  Swin-T -> 3 stage features + stride-2 extra level -> 1x1/3x3 proj + GN(32)
  -> flatten + SineHW position embeddings (+ level embed)
  -> 6x [BiAttention image<->text fusion; text self-enhance layer;
         deformable self-attention + FFN]
  -> two-stage proposal selection (gen_encoder_output_proposals -> enc_output
     -> contrastive class vs text -> top-900 -> box init)
  -> decoder: 2 box layers on 900 queries, then top-50 instances expand to
     50 x (1 box + 68 keypoint) queries (keypoint queries = projected CLIP
     keypoint-text embeddings), group-isolated self-attention
     (``mask_generate.py:10-43``), text cross-attention, deformable cross-
     attention, iterative box/pose refinement
  -> heads: contrastive logits, box, keypoint xy (+ constant-vis z slots,
     keypoint_xyzxyz_to_xyxyzz layout).

Parameter names are the reference checkpoint's (``backbone.0.layers.{i}...``,
``input_proj.{i}.0``, ``transformer.encoder.fusion_layers.{i}.attn.v_proj``,
``transformer.decoder.layers.{i}.ca_text.in_proj_weight``,
``bbox_embed.0.layers.{k}``), so ``core.convert.convert_unipose`` reads this
module's ``state_dict``, and a released checkpoint loads with
``load_state_dict(live_state_dict(ckpt), strict=True)``: ``live_state_dict``
drops the keys that are dead at inference (``DEAD_KEY_PREFIXES``).

Inference-only simplifications (as the JAX module): no image padding masks
(the drivers batch uniformly-sized frames, so valid_ratios == 1); the DN
branches and the ``* 0.0`` gradient hacks are dropped.

Numerics as the JAX module: masked attention logits take float32's minimum
(``NEG_INF``), the fusion block's padded text takes -inf, ``inverse_sigmoid``
clips at 1e-3, the top-k orders ties by index as ``jax.lax.top_k`` does.
GroupNorm's epsilon is flax's default 1e-6, as the JAX module runs it. Stock
PyTorch ops throughout.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ._modules import Namespace
from .deformable import ms_deform_attn
from .swin import SwinTransformer

NEG_INF = float(np.finfo(np.float32).min)

# Keys of a released checkpoint that the inference forward never reads: the
# DN label embedding, pos_proj, padding and the CLIP model saved inside it
# (``unipose.py:421-426`` multiplies them by 0.0), and the shared heads'
# aliases of ``bbox_embed.0`` / ``pose_embed.0`` / ``pose_hw_embed.0``.
DEAD_KEY_PREFIXES = (
    "label_enc.", "pos_proj.", "padding", "clip_model.",
    "transformer.decoder.bbox_embed.", "transformer.decoder.pose_embed.",
    "transformer.decoder.pose_hw_embed.", "transformer.enc_out_bbox_embed.",
)
_SHARED_HEADS = ("bbox_embed.", "pose_embed.", "pose_hw_embed.")


def live_state_dict(src: Mapping) -> Dict:
    """A released checkpoint's ``state_dict`` (``module.`` prefix optional)
    without its dead keys: what ``UniPose.load_state_dict(..., strict=True)``
    takes."""
    out = {}
    for k, v in src.items():
        k = k[7:] if k.startswith("module.") else k
        if k.startswith(DEAD_KEY_PREFIXES):
            continue
        head = next((h for h in _SHARED_HEADS if k.startswith(h)), None)
        if head is not None and not k.startswith(head + "0."):
            continue
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# positional embeddings
# ---------------------------------------------------------------------------


def sine_pos_embed_hw(h: int, w: int, num_feats: int = 128,
                      temp_h: float = 20.0, temp_w: float = 20.0) -> np.ndarray:
    """PositionEmbeddingSineHW (``position_encoding.py:67-110``), normalized,
    no padding: cumsum of an all-valid mask. Returns (h*w, 2*num_feats)."""
    eps, scale = 1e-6, 2 * math.pi
    y = (np.arange(h, dtype=np.float64) + 1.0)
    x = (np.arange(w, dtype=np.float64) + 1.0)
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_tx = temp_w ** (2 * (np.arange(num_feats) // 2) / num_feats)
    dim_ty = temp_h ** (2 * (np.arange(num_feats) // 2) / num_feats)
    pos_x = x[:, None] / dim_tx  # (w, F)
    pos_y = y[:, None] / dim_ty  # (h, F)

    def interleave(p):
        return np.stack([np.sin(p[:, 0::2]), np.cos(p[:, 1::2])], axis=2).reshape(
            p.shape[0], -1)

    pos_x = interleave(pos_x)  # (w, F)
    pos_y = interleave(pos_y)  # (h, F)
    grid = np.concatenate(
        [np.broadcast_to(pos_y[:, None], (h, w, num_feats)),
         np.broadcast_to(pos_x[None, :], (h, w, num_feats))], axis=-1)
    return grid.reshape(h * w, 2 * num_feats).astype(np.float32)


def _sine(p: torch.Tensor) -> torch.Tensor:
    """sin of the even features and cos of the odd ones, interleaved."""
    return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()], dim=-1).flatten(-2)


def gen_sineembed_for_position(pos: torch.Tensor) -> torch.Tensor:
    """(B, Q, 4) sigmoid-space boxes -> (B, Q, 512) (``utils.py:193-219``)."""
    dim_t = 10000.0 ** (2 * (torch.arange(128, device=pos.device) // 2) / 128.0)

    def embed(v):  # (B, Q) -> (B, Q, 128)
        return _sine((v * (2 * math.pi))[..., None] / dim_t)

    return torch.cat([embed(pos[..., 1]), embed(pos[..., 0]),
                      embed(pos[..., 2]), embed(pos[..., 3])], dim=-1)


def get_sine_pos_embed(pos: torch.Tensor, num_feats: int = 256) -> torch.Tensor:
    """``utils.py:26-55`` with exchange_xy=False on a (..., 1) tensor."""
    dim_t = 10000.0 ** (2 * (torch.arange(num_feats, device=pos.device) // 2) / num_feats)
    return _sine(pos[..., 0:1] * (2 * math.pi) / dim_t)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """``util/misc.py:689-693`` (note eps 1e-3)."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of the last axis, largest first, ties
    in index order: ``jax.lax.top_k``'s order."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------



class MLP(nn.Module):
    """``utils.py:162-174``: Linear stack with ReLU between."""

    def __init__(self, in_dim: int, hidden: int, out: int, num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden] * (num_layers - 1) + [out]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiheadAttention(nn.Module):
    """torch ``nn.MultiheadAttention``'s parameters (packed ``in_proj``), with
    the JAX module's masking: attn_mask True = blocked; key_padding True = pad;
    blocked logits take ``NEG_INF``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q, k, v, attn_mask=None, key_padding_mask=None):
        B, Q, C = q.shape
        S = k.shape[1]
        hd = C // self.heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        qh = F.linear(q, wq, bq).reshape(B, Q, self.heads, hd)
        kh = F.linear(k, wk, bk).reshape(B, S, self.heads, hd)
        vh = F.linear(v, wv, bv).reshape(B, S, self.heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(hd)
        if attn_mask is not None:
            # (Q, S), (B, Q, S) or (B, heads, Q, S); a 3-D mask is per sample
            m = attn_mask
            if m.ndim == 2:
                m = m[None, None]
            elif m.ndim == 3:
                m = m[:, None]
            logits = logits.masked_fill(m, NEG_INF)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
        out = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), vh).reshape(B, Q, C)
        return self.out_proj(out)


class MSDeformAttnModule(nn.Module):
    """MSDeformAttn (``ops/modules/ms_deform_attn.py:33,83-143``): learned
    sampling offsets + softmax weights around 2D or 4D reference points."""

    def __init__(self, dim: int = 256, heads: int = 8, levels: int = 4, points: int = 4):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        self.value_proj = nn.Linear(dim, dim)
        self.sampling_offsets = nn.Linear(dim, heads * levels * points * 2)
        self.attention_weights = nn.Linear(dim, heads * levels * points)
        self.output_proj = nn.Linear(dim, dim)

    def forward(self, query, ref_points, value, spatial_shapes):
        """query (B,Q,C); ref_points (B,Q,L,2|4); value (B,S,C)."""
        B, Q, C = query.shape
        Hh, L, P = self.heads, self.levels, self.points
        v = self.value_proj(value).reshape(B, -1, Hh, C // Hh)
        off = self.sampling_offsets(query).reshape(B, Q, Hh, L, P, 2)
        attn = self.attention_weights(query).reshape(B, Q, Hh, L * P).softmax(-1)
        attn = attn.reshape(B, Q, Hh, L, P)
        if ref_points.shape[-1] == 2:
            wh = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=off.dtype,
                              device=off.device)
            loc = ref_points[:, :, None, :, None, :] + off / wh[None, None, None, :, None, :]
        else:  # 4D boxes: offsets scaled by box size (``ms_deform_attn.py:121-123``)
            loc = (ref_points[:, :, None, :, None, :2]
                   + off / P * ref_points[:, :, None, :, None, 2:] * 0.5)
        return self.output_proj(ms_deform_attn(v, spatial_shapes, loc, attn))


class DeformEncoderLayer(nn.Module):
    """DeformableTransformerEncoderLayer (``deformable_transformer.py:943-998``)."""

    def __init__(self, dim: int = 256, ffn: int = 2048, heads: int = 8, levels: int = 4,
                 points: int = 4):
        super().__init__()
        self.self_attn = MSDeformAttnModule(dim, heads, levels, points)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.linear1 = nn.Linear(dim, ffn)
        self.linear2 = nn.Linear(ffn, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, src, pos, ref_points, spatial_shapes):
        src = self.norm1(src + self.self_attn(src + pos, ref_points, src, spatial_shapes))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class TextEnhanceLayer(nn.Module):
    """transformer_vanilla.TransformerEncoderLayer with the eye self-attention
    mask (each text token attends only to itself) and sine position ids."""

    def __init__(self, dim: int = 256, heads: int = 4, ffn: int = 1024):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.linear1 = nn.Linear(dim, ffn)
        self.linear2 = nn.Linear(ffn, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, txt, pos, self_mask):
        """txt (B,N,C); pos (B,N,C); self_mask (B,N,N) True = blocked."""
        q = txt + pos
        txt = self.norm1(txt + self.self_attn(q, q, txt, attn_mask=self_mask[:, None]))
        return self.norm2(txt + self.linear2(F.relu(self.linear1(txt))))


class BiAttentionBlock(nn.Module):
    """fuse_modules.BiAttentionBlock (``fuse_modules.py:100-277``): pre-LN
    bidirectional image<->text attention with layer-scale gammas, the global
    stable-softmax max subtraction, and +-50000 clamps."""

    def __init__(self, v_dim: int = 256, l_dim: int = 256, embed_dim: int = 1024,
                 heads: int = 4):
        super().__init__()
        self.heads, self.embed_dim = heads, embed_dim
        self.layer_norm_v = nn.LayerNorm(v_dim, eps=1e-5)
        self.layer_norm_l = nn.LayerNorm(l_dim, eps=1e-5)
        self.attn = Namespace(
            v_proj=nn.Linear(v_dim, embed_dim), l_proj=nn.Linear(l_dim, embed_dim),
            values_v_proj=nn.Linear(v_dim, embed_dim), values_l_proj=nn.Linear(l_dim, embed_dim),
            out_v_proj=nn.Linear(embed_dim, v_dim), out_l_proj=nn.Linear(embed_dim, l_dim))
        self.gamma_v = nn.Parameter(torch.full((v_dim,), 1e-4))
        self.gamma_l = nn.Parameter(torch.full((l_dim,), 1e-4))

    def forward(self, v, l, text_pad_mask=None):
        """v (B,S,C) image tokens; l (B,N,C) text; text_pad_mask True = pad."""
        B, S, _ = v.shape
        N = l.shape[1]
        hd = self.embed_dim // self.heads
        a = self.attn
        vn, ln = self.layer_norm_v(v), self.layer_norm_l(l)
        q = (a.v_proj(vn) * hd ** -0.5).reshape(B, S, self.heads, hd)
        k = a.l_proj(ln).reshape(B, N, self.heads, hd)
        val_v = a.values_v_proj(vn).reshape(B, S, self.heads, hd)
        val_l = a.values_l_proj(ln).reshape(B, N, self.heads, hd)

        aw = torch.einsum("bshd,bnhd->bhsn", q, k)
        aw = (aw - aw.max()).clamp(-50000, 50000)  # stable_softmax_2d: global max
        aw_t = aw.transpose(-1, -2)  # (B,h,N,S) text->image weights
        aw_l = (aw_t - aw_t.max(-1, keepdim=True)[0]).clamp(-50000, 50000)
        p_l = aw_l.softmax(-1)  # no image padding at inference -> no mask
        if text_pad_mask is not None:
            aw = aw.masked_fill(text_pad_mask[:, None, None, :], float("-inf"))
        p_v = aw.softmax(-1)

        out_v = torch.einsum("bhsn,bnhd->bshd", p_v, val_l).reshape(B, S, self.embed_dim)
        out_l = torch.einsum("bhns,bshd->bnhd", p_l, val_v).reshape(B, N, self.embed_dim)
        return vn + self.gamma_v * a.out_v_proj(out_v), ln + self.gamma_l * a.out_l_proj(out_l)


class DeformDecoderLayer(nn.Module):
    """DeformableTransformerDecoderLayer (``deformable_transformer.py:1001-1137``):
    self-attn (group mask) -> text cross-attn -> deformable cross-attn -> FFN."""

    def __init__(self, dim: int = 256, heads: int = 8, ffn: int = 2048, levels: int = 4,
                 points: int = 4):
        super().__init__()
        self.cross_attn = MSDeformAttnModule(dim, heads, levels, points)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.ca_text = MultiheadAttention(dim, heads)
        self.catext_norm = nn.LayerNorm(dim, eps=1e-5)
        self.self_attn = MultiheadAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.linear1 = nn.Linear(dim, ffn)
        self.linear2 = nn.Linear(ffn, dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, tgt, query_pos, ref_points, memory, spatial_shapes,
                memory_text, text_pad_mask, self_attn_mask=None):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt, attn_mask=self_attn_mask))
        tgt = self.catext_norm(tgt + self.ca_text(tgt + query_pos, memory_text, memory_text,
                                                  key_padding_mask=text_pad_mask))
        tgt = self.norm1(tgt + self.cross_attn(tgt + query_pos, ref_points, memory,
                                               spatial_shapes))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


def contrastive_logits(x: torch.Tensor, text: torch.Tensor,
                       text_token_mask: torch.Tensor) -> torch.Tensor:
    """ContrastiveAssign (``unipose.py:587-635``): dot vs text embeddings,
    padded tokens -> -inf."""
    res = torch.einsum("bqc,bnc->bqn", x, text)
    return res.masked_fill(~text_token_mask[:, None, :], float("-inf"))


def gen_encoder_output_proposals(memory: torch.Tensor,
                                 spatial_shapes: Sequence[Tuple[int, int]]):
    """``utils.py:58-113`` with all-valid masks: per-token anchor boxes (cell
    center, wh = 0.05 * 2^level) in unsigmoid space, (1, S, 4); invalid
    (border) proposals -> +inf and their memory zeroed."""
    props = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        grid = np.stack([gx, gy], -1)  # (h, w, 2)
        grid = (grid + 0.5) / np.asarray([w, h], np.float32)
        wh = np.full_like(grid, 0.05 * (2.0 ** lvl))
        props.append(np.concatenate([grid, wh], -1).reshape(-1, 4))
    proposals = np.concatenate(props, 0)  # (S, 4)
    valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1, keepdims=True)
    uns = np.where(valid, np.log(proposals / (1 - proposals)), np.inf).astype(np.float32)
    out_mem = memory.masked_fill(~torch.from_numpy(valid).to(memory.device)[None], 0.0)
    return out_mem, torch.from_numpy(uns).to(memory.device)[None]


def keypoint_group_mask(kpt_mask: torch.Tensor, num_groups: int) -> torch.Tensor:
    """prepare_for_mask (``mask_generate.py:10-43``): (B, G*S, G*S) bool mask,
    True = blocked. Cross-group always blocked; within a group, tokens attend
    only to tokens with equal visibility flag. kpt_mask: (B, S) with S = 1 +
    num_body_points (leading 1 for the instance slot)."""
    B, S = kpt_mask.shape
    g = torch.arange(num_groups * S, device=kpt_mask.device) // S
    cross = g[:, None] != g[None, :]
    within_block = (kpt_mask[:, :, None] != kpt_mask[:, None, :]).repeat(1, num_groups,
                                                                         num_groups)
    return cross[None] | within_block


def keypoint_xyzxyz_to_xyxyzz(x: torch.Tensor):
    """``util/keypoint_ops.py``: (..., 3K) interleaved xyz -> (all xy, all z)."""
    return torch.stack([x[..., 0::3], x[..., 1::3]], dim=-1).flatten(-2), x[..., 2::3]


class UniPose(nn.Module):
    """UniPose (inference forward). See the module docstring."""

    def __init__(self, hidden_dim: int = 256, enc_layers: int = 6, dec_layers: int = 6,
                 heads: int = 8, levels: int = 4, points: int = 4, ffn_dim: int = 2048,
                 num_queries: int = 900, num_groups: int = 50, num_body_points: int = 68,
                 num_box_decoder_layers: int = 2, text_dim: int = 512,
                 swin_embed_dim: int = 96, swin_depths: Tuple[int, ...] = (2, 2, 6, 2),
                 swin_heads: Tuple[int, ...] = (3, 6, 12, 24)):
        super().__init__()
        C = hidden_dim
        self.hidden_dim, self.levels, self.num_queries = C, levels, num_queries
        self.num_groups, self.num_body_points = num_groups, num_body_points
        self.num_box_decoder_layers = num_box_decoder_layers

        self.projection = MLP(text_dim, C, C, 3)
        self.projection_kpt = MLP(text_dim, C, C, 3)
        self.backbone = nn.ModuleList([SwinTransformer(swin_embed_dim, swin_depths, swin_heads)])
        stage_dims = [swin_embed_dim * 2 ** i for i in (1, 2, 3)]
        self.input_proj = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(d, C, 1), nn.GroupNorm(32, C, eps=1e-6)) for d in stage_dims]
            + [nn.Sequential(nn.Conv2d(stage_dims[-1], C, 3, stride=2, padding=1),
                             nn.GroupNorm(32, C, eps=1e-6))])

        encoder = Namespace(
            # the JAX module builds the encoder's MSDeformAttn with its default
            # of 8 heads whatever ``heads`` is (the shipped geometry has 8)
            layers=nn.ModuleList([DeformEncoderLayer(C, ffn_dim, 8, levels, points)
                                  for _ in range(enc_layers)]),
            text_layers=nn.ModuleList([TextEnhanceLayer(C, heads // 2, ffn_dim // 2)
                                       for _ in range(enc_layers)]),
            fusion_layers=nn.ModuleList([BiAttentionBlock(C, C, ffn_dim // 2, heads // 2)
                                         for _ in range(enc_layers)]))
        decoder = Namespace(
            layers=nn.ModuleList([DeformDecoderLayer(C, heads, ffn_dim, levels, points)
                                  for _ in range(dec_layers)]),
            # the query sine embedding has 4 x 128 features whatever C is
            norm=nn.LayerNorm(C, eps=1e-5), ref_point_head=MLP(512, C, C, 2),
            hw=nn.Embedding(17, 2), hw_append=nn.Embedding(num_body_points - 17, 2))
        self.transformer = Namespace(
            encoder=encoder, decoder=decoder, tgt_embed=nn.Embedding(num_queries, C),
            enc_output=nn.Linear(C, C), enc_output_norm=nn.LayerNorm(C, eps=1e-5))
        self.transformer.level_embed = nn.Parameter(torch.randn(levels, C))

        # shared heads (dec_pred_*_embed_share = True in the build)
        self.bbox_embed = nn.ModuleList([MLP(C, C, 4, 3)])
        self.pose_embed = nn.ModuleList([MLP(C, C, 2, 3)])
        self.pose_hw_embed = nn.ModuleList([MLP(C, C, 2, 3)])

    def forward(
        self,
        image: torch.Tensor,  # (B, H, W, 3) normalized
        obj_text: torch.Tensor,  # (B, N_txt, text_dim) CLIP instance embeddings
        text_token_mask: torch.Tensor,  # (B, N_txt) bool, True = real token
        kpt_text: torch.Tensor,  # (B, K, text_dim) CLIP keypoint embeddings
        kpt_vis: torch.Tensor,  # (B, K) 1.0 = real keypoint slot
    ) -> Dict[str, torch.Tensor]:
        memory, txt, spatial_shapes = self.encode(image, obj_text, text_token_mask)
        return self.decode(memory, txt, spatial_shapes, text_token_mask, kpt_text, kpt_vis)

    def encode(self, image, obj_text, text_token_mask):
        """Backbone, input projections and the encoder: (memory (B, S, C),
        enhanced text (B, N_txt, C), the levels' (h, w))."""
        B, C, dev = image.shape[0], self.hidden_dim, image.device
        dtype = self.transformer.level_embed.dtype
        txt = self.projection(obj_text.to(dtype))  # (``unipose.py:115-117,340-342``)

        feats = [f.permute(0, 3, 1, 2) for f in self.backbone[0](image.to(dtype))]
        srcs = [proj(f) for proj, f in zip(self.input_proj, feats)]
        srcs.append(self.input_proj[len(feats)](feats[-1]))
        spatial_shapes = [(int(f.shape[2]), int(f.shape[3])) for f in srcs]
        src = torch.cat([f.flatten(2).transpose(1, 2) for f in srcs], dim=1)
        S = src.shape[1]

        pos = torch.from_numpy(np.concatenate(
            [sine_pos_embed_hw(h, w, C // 2) for h, w in spatial_shapes], 0)).to(dev)
        lvl = torch.cat([self.transformer.level_embed[i].expand(h * w, C)
                         for i, (h, w) in enumerate(spatial_shapes)], dim=0)
        pos = (pos + lvl)[None].to(dtype)

        # encoder reference points: own cell center at every level
        # (``deformable_transformer.py:584-596``, valid_ratios = 1)
        centers = []
        for h, w in spatial_shapes:
            gy, gx = np.meshgrid(
                np.linspace(0.5, h - 0.5, h, dtype=np.float32) / h,
                np.linspace(0.5, w - 0.5, w, dtype=np.float32) / w, indexing="ij")
            centers.append(np.stack([gx.ravel(), gy.ravel()], -1))
        centers = torch.from_numpy(np.concatenate(centers, 0)).to(device=dev, dtype=dtype)
        enc_ref = centers[None, :, None].expand(B, S, self.levels, 2)

        # text positions: sine embed of position_ids (1 real / 0 pad)
        pos_text = get_sine_pos_embed(text_token_mask.to(torch.float32)[..., None], C).to(dtype)
        n_txt = txt.shape[1]
        text_self_mask = ~torch.eye(n_txt, dtype=torch.bool, device=dev)[None]  # eye allowed
        text_pad = ~text_token_mask

        # encoder (``deformable_transformer.py:648-691``): fusion -> text
        # enhance -> deformable layer, per layer
        enc = self.transformer.encoder
        out = src
        for fusion, text_layer, layer in zip(enc.fusion_layers, enc.text_layers, enc.layers):
            out, txt = fusion(out, txt, text_pad)
            txt = text_layer(txt, pos_text, text_self_mask)
            out = layer(out, pos, enc_ref, spatial_shapes)
        return out, txt, spatial_shapes

    def select_queries(self, memory, txt, spatial_shapes, text_token_mask):
        """Two-stage proposal selection (``deformable_transformer.py:386-437``):
        the top-``num_queries`` encoder tokens' indices (B, Q) and their
        unsigmoid boxes (B, Q, 4)."""
        t = self.transformer
        out_mem, out_prop = gen_encoder_output_proposals(memory, spatial_shapes)
        out_mem = t.enc_output_norm(t.enc_output(out_mem))
        enc_logits = contrastive_logits(out_mem, txt, text_token_mask)
        enc_coord = self.bbox_embed[0](out_mem) + out_prop  # unsigmoid
        topk = top_k(enc_logits.max(-1)[0], self.num_queries)
        refpoint = torch.gather(enc_coord, 1, topk[..., None].expand(-1, -1, 4))
        return topk, refpoint.detach()

    def decode(self, memory, txt, spatial_shapes, text_token_mask, kpt_text, kpt_vis):
        B, C = memory.shape[0], self.hidden_dim
        K, G = self.num_body_points, self.num_groups
        slots = K + 1
        t, dec = self.transformer, self.transformer.decoder
        bbox_embed, pose_embed = self.bbox_embed[0], self.pose_embed[0]
        kpt_embed = self.projection_kpt(kpt_text.to(memory.dtype))
        text_pad = ~text_token_mask

        topk, refpoint = self.select_queries(memory, txt, spatial_shapes, text_token_mask)
        output = t.tgt_embed.weight[None].expand(B, -1, -1)

        # group-isolated mask for the expanded phase
        kpt_mask = torch.cat([torch.ones_like(kpt_vis[:, :1]), kpt_vis], dim=-1)  # (B, slots)
        attn_mask2 = keypoint_group_mask(kpt_mask, G)[:, None]  # (B,1,n,n)
        kpt_index = torch.tensor([x for x in range(G * slots) if x % slots != 0],
                                 device=memory.device)

        # decoder (``deformable_transformer.py:775-943``)
        reference_points = refpoint.sigmoid()
        intermediate, ref_list = [], [reference_points]
        sa_mask = None
        for layer_id, layer in enumerate(dec.layers):
            ref_input = reference_points[:, :, None].expand(-1, -1, self.levels, 4)
            query_pos = dec.ref_point_head(gen_sineembed_for_position(reference_points)
                                           .to(memory.dtype))
            output = layer(output, query_pos, ref_input, memory, spatial_shapes, txt, text_pad,
                           self_attn_mask=sa_mask)
            intermediate.append(dec.norm(output))

            if layer_id < self.num_box_decoder_layers:
                new_ref = (bbox_embed(output) + inverse_sigmoid(reference_points)).sigmoid()

            if layer_id == self.num_box_decoder_layers - 1:
                # expand top-G instances into (box + K keypoint) query groups
                cls = contrastive_logits(output, txt, text_token_mask)
                topg = top_k(cls.max(-1)[0], G)  # (B, G)
                box_ref = torch.gather(new_ref, 1, topg[..., None].expand(-1, -1, 4))
                box_out = torch.gather(output, 1, topg[..., None].expand(-1, -1, C))
                kpt_feat = kpt_embed[:, None].expand(B, G, K, C)  # queries = text embeds
                delta_xy = pose_embed(kpt_feat)[..., :2]
                kpt_xy = (inverse_sigmoid(box_ref[..., :2])[:, :, None] + delta_xy).sigmoid()
                hw_all = torch.cat([dec.hw.weight, dec.hw_append.weight], 0).sigmoid()
                kpt_wh = hw_all[None, None] * box_ref[..., 2:][:, :, None]
                kpt_ref = torch.cat([kpt_xy, kpt_wh], -1)  # (B,G,K,4)
                new_ref = torch.cat([box_ref[:, :, None], kpt_ref], dim=2).reshape(B, G * slots, 4)
                output = torch.cat([box_out[:, :, None], kpt_feat], dim=2).reshape(B, G * slots, C)
                sa_mask = attn_mask2

            if layer_id >= self.num_box_decoder_layers:
                ref_uns = inverse_sigmoid(reference_points)
                new_box = (bbox_embed(output[:, 0::slots]) + ref_uns[:, 0::slots]).sigmoid()
                out_kpt = output[:, kpt_index]
                d_xy = pose_embed(out_kpt)
                d_hw = self.pose_hw_embed[0](out_kpt)
                uns_kpt = ref_uns[:, kpt_index]
                uns_kpt = torch.cat([uns_kpt[..., :2] + d_xy[..., :2], uns_kpt[..., 2:] + d_hw], -1)
                kpt_ref = uns_kpt.sigmoid().reshape(B, G, K, 4)
                new_ref = torch.cat([new_box[:, :, None], kpt_ref], dim=2).reshape(B, G * slots, 4)

            reference_points = new_ref.detach()
            ref_list.append(new_ref)

        # final outputs (``unipose.py:431-497``, last decoder layer only)
        hs = intermediate[-1]
        ref_in = ref_list[-2]  # reference entering the last layer
        hs_box = hs[:, 0::slots]
        pred_boxes = (bbox_embed(hs_box) + inverse_sigmoid(ref_in[:, 0::slots])).sigmoid()
        pred_logits = contrastive_logits(hs_box, txt, text_token_mask)
        kpt_xy_uns = pose_embed(hs[:, kpt_index]) + inverse_sigmoid(ref_in[:, kpt_index][..., :2])
        xyv = torch.cat([kpt_xy_uns, torch.ones_like(kpt_xy_uns[..., :1])], -1).sigmoid()
        xy, z = keypoint_xyzxyz_to_xyxyzz(xyv.reshape(B, G, K * 3))
        return {
            "pred_logits": pred_logits,
            "pred_boxes": pred_boxes,
            "pred_keypoints": torch.cat([xy, z], -1),
            "query_indices": topk,  # (B, num_queries): the encoder tokens selected
            "group_indices": topg,  # (B, G): the box queries expanded into groups
        }


# ---------------------------------------------------------------------------
# host-side postprocess (sigmoid threshold + NMS — torchvision-free rebuild of
# ``inference_xpose_on_video.py:785-850``)
# ---------------------------------------------------------------------------


def postprocess(outputs, num_keypoints: int, score_threshold: float = 0.3,
                iou_threshold: float = 0.9):
    """outputs: dict from UniPose.forward (tensors or arrays); returns
    per-image dicts of numpy arrays."""
    def host(x):
        return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else \
            np.asarray(x, np.float32)

    logits = host(outputs["pred_logits"])  # (B, G, N)
    boxes = host(outputs["pred_boxes"])  # (B, G, 4) cxcywh
    kpts = host(outputs["pred_keypoints"])  # (B, G, 3K)
    results = []
    for b in range(logits.shape[0]):
        scores = 1.0 / (1.0 + np.exp(-logits[b].max(-1)))
        keep = scores > score_threshold
        bsel, ssel = boxes[b][keep], scores[keep]
        ksel = kpts[b][keep][:, : 2 * num_keypoints].reshape(-1, num_keypoints, 2)
        order = np.argsort(-ssel)
        bsel, ssel, ksel = bsel[order], ssel[order], ksel[order]
        picked = []
        for i in range(len(bsel)):
            if all(_iou_cxcywh(bsel[i], bsel[j]) <= iou_threshold for j in picked):
                picked.append(i)
        results.append({"scores": ssel[picked], "boxes": bsel[picked],
                        "keypoints": ksel[picked]})
    return results


def _iou_cxcywh(a, b) -> float:
    def to_xyxy(v):
        cx, cy, w, h = v
        return cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2

    ax0, ay0, ax1, ay1 = to_xyxy(a)
    bx0, by0, bx1, by1 = to_xyxy(b)
    ix = max(0.0, min(ax1, bx1) - max(ax0, bx0))
    iy = max(0.0, min(ay1, by1) - max(ay0, by0))
    inter = ix * iy
    ua = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter / max(ua, 1e-9)
