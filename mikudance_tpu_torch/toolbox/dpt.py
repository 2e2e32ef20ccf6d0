"""DPT-hybrid-MiDaS monocular depth estimation.

Port of ``mikudance_tpu/toolbox/dpt.py``: the depth model behind the
reference's depth tool (``tools/depth_from_image.py:16-50``, which runs HF
``Intel/dpt-hybrid-midas``): a BiT (ResNetv2, weight-standardized convs)
stem + 3 stages, a ViT-B/16 encoder over the /16 feature map, the DPT
reassemble + fusion neck, and the depth head.

Parameter names are those of ``transformers.DPTForDepthEstimation(is_hybrid=
True)`` (``dpt.embeddings.backbone.bit.encoder.stages.{s}.layers.{l}.conv1``,
``dpt.encoder.layer.{i}.attention.attention.query``,
``neck.fusion_stage.layers.{i}.residual_layer2.convolution1``,
``head.head.{0,2,4}``), so ``core.convert.convert_dpt`` reads this module's
``state_dict``; the released file loads with
``load_state_dict(live_state_dict(sd), strict=True)``, which drops the two
tensors the depth forward never reads (``dpt.layernorm`` and the deepest
fusion layer's ``residual_layer1``).

Architecture facts (transformers' modeling_dpt / modeling_bit, as the JAX
module replicates them):
- weight-standardized convs (per-out-channel, biased var, eps 1e-8) with
  TF-SAME dynamic padding; GroupNorm(32, eps 1e-5) + ReLU after each conv;
  non-preactivation bottleneck (shortcut downsample conv+GN, final ReLU).
- hybrid features = [BiT stage1 (/4), BiT stage2 (/8), ViT layer-9 tokens,
  ViT layer-12 tokens]; the final ``dpt.layernorm`` is not applied to the
  neck's features. The ViT's LayerNorm eps is 1e-12.
- readout_type "project": tokens concat broadcast-cls -> Linear + GELU.
- reassemble factors (1, 1, 1, 0.5): identity / stride-2 3x3 conv resize.
- fusion: pre-activation residual units, x2 bilinear upsample with
  align_corners=True, then 1x1 projection.
- head: 3x3 conv -> x2 bilinear (align_corners=True) -> 3x3 conv -> ReLU ->
  1x1 conv -> ReLU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ._modules import Namespace

# Intel/dpt-hybrid-midas normalization (DPTImageProcessor: rescale 1/255,
# mean 0.5, std 0.5, resize 384x384).
IMAGE_SIZE = 384
IMAGE_MEAN = 0.5
IMAGE_STD = 0.5

# Tensors of the released state_dict that the depth forward never reads.
DEAD_KEY_PREFIXES = ("dpt.layernorm.", "neck.fusion_stage.layers.0.residual_layer1.")


@dataclasses.dataclass(frozen=True)
class DPTHybridConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    patch_grid: int = 24  # 384 / 16
    bit_embed: int = 64
    bit_depths: Tuple[int, ...] = (3, 4, 9)
    bit_hidden: Tuple[int, ...] = (256, 512, 1024)
    neck_hidden: Tuple[int, ...] = (256, 512, 768, 768)
    fusion_hidden: int = 256
    vit_out_layers: Tuple[int, ...] = (8, 11)  # 0-based encoder layer outputs
    gn_groups: int = 32
    gn_eps: float = 1e-5
    ln_eps: float = 1e-12  # transformers DPTConfig.layer_norm_eps
    ws_eps: float = 1e-8


def live_state_dict(src: Mapping) -> Dict:
    """The released ``state_dict`` without the tensors the forward never reads."""
    return {k: v for k, v in src.items() if not k.startswith(DEAD_KEY_PREFIXES)}


def _same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """TF-SAME padding of an NCHW map for a k x k window at stride s."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad order: width first
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


class WSConv(nn.Conv2d):
    """Weight-standardized conv (BiT), no bias: the kernel normalized per out
    channel over (in, kh, kw) with biased variance, TF-SAME padding."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, eps: float = 1e-8):
        super().__init__(cin, cout, k, stride=stride, bias=False)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        mu = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = (w - mu) * torch.rsqrt(var + self.eps)
        return F.conv2d(_same_pad(x, self.kernel_size[0], self.stride[0]), w,
                        stride=self.stride)


class BitBottleneck(nn.Module):
    """Non-preactivation ResNetv2 bottleneck (HF BitBottleneckLayer)."""

    def __init__(self, cin: int, out_ch: int, stride: int, downsample: bool, cfg: DPTHybridConfig):
        super().__init__()
        mid = out_ch // 4

        def gn(c):
            return nn.GroupNorm(cfg.gn_groups, c, eps=cfg.gn_eps)

        if downsample:
            self.downsample = Namespace(conv=WSConv(cin, out_ch, 1, stride, cfg.ws_eps),
                                        norm=gn(out_ch))
        else:
            self.downsample = None
        self.conv1, self.norm1 = WSConv(cin, mid, 1, eps=cfg.ws_eps), gn(mid)
        self.conv2, self.norm2 = WSConv(mid, mid, 3, stride, cfg.ws_eps), gn(mid)
        self.conv3, self.norm3 = WSConv(mid, out_ch, 1, eps=cfg.ws_eps), gn(out_ch)

    def forward(self, x):
        shortcut = x
        if self.downsample is not None:
            shortcut = self.downsample.norm(self.downsample.conv(x))
        h = F.relu(self.norm1(self.conv1(x)))
        h = F.relu(self.norm2(self.conv2(h)))
        return F.relu(self.norm3(self.conv3(h)) + shortcut)


class ViTLayer(nn.Module):
    def __init__(self, cfg: DPTHybridConfig):
        super().__init__()
        C = cfg.hidden_size
        self.heads = cfg.num_heads
        self.layernorm_before = nn.LayerNorm(C, eps=cfg.ln_eps)
        self.attention = Namespace(
            attention=Namespace(query=nn.Linear(C, C), key=nn.Linear(C, C), value=nn.Linear(C, C)),
            output=Namespace(dense=nn.Linear(C, C)))
        self.layernorm_after = nn.LayerNorm(C, eps=cfg.ln_eps)
        self.intermediate = Namespace(dense=nn.Linear(C, cfg.mlp_dim))
        self.output = Namespace(dense=nn.Linear(cfg.mlp_dim, C))

    def forward(self, t):
        B, N, C = t.shape
        hd = C // self.heads
        h = self.layernorm_before(t)
        a = self.attention.attention
        q, k, v = (p(h).reshape(B, N, self.heads, hd).transpose(1, 2)
                   for p in (a.query, a.key, a.value))
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        o = torch.einsum("bhqk,bhkd->bhqd", s.softmax(-1), v).transpose(1, 2).reshape(B, N, C)
        t = t + self.attention.output.dense(o)
        h = F.gelu(self.intermediate.dense(self.layernorm_after(t)))
        return t + self.output.dense(h)


def upsample2x_ac(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample of an NCHW map with align_corners=True (the JAX
    module's ``_upsample2x_ac``): source coordinates i * (H-1) / (2H-1)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    """Pre-activation residual unit (DPTPreActResidualLayer)."""

    def __init__(self, ch: int):
        super().__init__()
        self.convolution1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.convolution2 = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return x + self.convolution2(F.relu(self.convolution1(F.relu(x))))


class FusionLayer(nn.Module):
    """DPTFeatureFusionLayer; the deepest one has no residual input, so no
    ``residual_layer1``."""

    def __init__(self, ch: int, with_residual: bool):
        super().__init__()
        self.residual_layer1 = ResidualConvUnit(ch) if with_residual else None
        self.residual_layer2 = ResidualConvUnit(ch)
        self.projection = nn.Conv2d(ch, ch, 1)

    def forward(self, fused, f=None):
        if f is not None:
            fused = fused + self.residual_layer1(f)
        return self.projection(upsample2x_ac(self.residual_layer2(fused)))


class DPTHybridDepth(nn.Module):
    """Full DPT-hybrid depth model: (B, 384, 384, 3) normalized pixels ->
    (B, 384, 384) predicted (relative, un-normalized) depth."""

    def __init__(self, cfg: DPTHybridConfig = DPTHybridConfig()):
        super().__init__()
        self.cfg = cfg
        C, nh = cfg.hidden_size, cfg.neck_hidden
        stages, cin = [], cfg.bit_embed
        for si, (depth, ch) in enumerate(zip(cfg.bit_depths, cfg.bit_hidden)):
            layers = []
            for li in range(depth):
                layers.append(BitBottleneck(cin, ch, (1 if si == 0 else 2) if li == 0 else 1,
                                            li == 0, cfg))
                cin = ch
            stages.append(Namespace(layers=nn.ModuleList(layers)))
        bit = Namespace(
            embedder=Namespace(convolution=WSConv(3, cfg.bit_embed, 7, 2, cfg.ws_eps),
                               norm=nn.GroupNorm(cfg.gn_groups, cfg.bit_embed, eps=cfg.gn_eps)),
            encoder=Namespace(stages=nn.ModuleList(stages)))
        embeddings = Namespace(backbone=Namespace(bit=bit),
                               projection=nn.Conv2d(cfg.bit_hidden[-1], C, 1))
        embeddings.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        embeddings.position_embeddings = nn.Parameter(torch.zeros(1, cfg.patch_grid ** 2 + 1, C))
        self.dpt = Namespace(embeddings=embeddings, encoder=Namespace(
            layer=nn.ModuleList([ViTLayer(cfg) for _ in range(cfg.num_layers)])))

        def reassemble_layer(i):
            if i < 2:
                return nn.Identity()
            return Namespace(projection=nn.Conv2d(C, nh[i], 1),
                             resize=nn.Conv2d(nh[i], nh[i], 3, stride=2, padding=1) if i == 3
                             else nn.Identity())

        self.neck = Namespace(
            reassemble_stage=Namespace(
                readout_projects=nn.ModuleList(
                    [nn.Identity() if i < 2 else nn.Sequential(nn.Linear(2 * C, C), nn.GELU())
                     for i in range(4)]),
                layers=nn.ModuleList([reassemble_layer(i) for i in range(4)])),
            convs=nn.ModuleList([nn.Conv2d(nh[i], cfg.fusion_hidden, 3, padding=1, bias=False)
                                 for i in range(4)]),
            fusion_stage=Namespace(layers=nn.ModuleList(
                [FusionLayer(cfg.fusion_hidden, i > 0) for i in range(4)])))
        Fh = cfg.fusion_hidden
        self.head = Namespace(head=nn.Sequential(
            nn.Conv2d(Fh, Fh // 2, 3, padding=1),
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
            nn.Conv2d(Fh // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU()))

    def backbone(self, x: torch.Tensor):
        """BiT stem + 3 stages on NCHW pixels: (/4 stage1, /8 stage2, /16 stage3)."""
        bit = self.dpt.embeddings.backbone.bit
        h = F.relu(bit.embedder.norm(bit.embedder.convolution(x)))
        # TF-SAME 3x3 stride-2 max pool, padded with -inf as flax pads it
        h = F.max_pool2d(_same_pad(h, 3, 2, float("-inf")), 3, stride=2)
        feats = []
        for stage in bit.encoder.stages:
            for layer in stage.layers:
                h = layer(h)
            feats.append(h)
        return feats

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        emb = self.dpt.embeddings
        s1, s2, s3 = self.backbone(pixels.permute(0, 3, 1, 2).to(emb.cls_token.dtype))

        # ViT over the /16 feature map
        t = emb.projection(s3)
        B, C, gh, gw = t.shape
        if gh != cfg.patch_grid or gw != cfg.patch_grid:
            raise ValueError(f"DPTHybridDepth is fixed to {cfg.patch_grid * 16}^2 inputs")
        t = torch.cat([emb.cls_token.expand(B, -1, -1), t.flatten(2).transpose(1, 2)], dim=1)
        t = t + emb.position_embeddings
        taps = {}
        for i, layer in enumerate(self.dpt.encoder.layer):
            t = layer(t)
            if i in cfg.vit_out_layers:
                taps[i] = t

        rs = self.neck.reassemble_stage

        def reassemble(tokens, idx):  # readout_type="project"
            cls_tok, tok = tokens[:, :1], tokens[:, 1:]
            tok = rs.readout_projects[idx](torch.cat([tok, cls_tok.expand_as(tok)], dim=-1))
            layer = rs.layers[idx]
            return layer.resize(layer.projection(tok.transpose(1, 2).reshape(B, C, gh, gw)))

        feats = [s1, s2, reassemble(taps[cfg.vit_out_layers[0]], 2),
                 reassemble(taps[cfg.vit_out_layers[1]], 3)]
        feats = [conv(f) for conv, f in zip(self.neck.convs, feats)]

        # fusion: deepest first; each merges, refines, upsamples x2, projects
        fused = None
        for layer, f in zip(self.neck.fusion_stage.layers, reversed(feats)):
            fused = layer(f) if fused is None else layer(fused, f)
        return self.head.head(fused)[:, 0]


def preprocess(image_rgb_uint8) -> torch.Tensor:
    """(H, W, 3) uint8 -> (1, 384, 384, 3) normalized fp32 on the CPU (bicubic
    resize, rescale 1/255, mean/std 0.5 — DPTImageProcessor for
    dpt-hybrid-midas)."""
    from PIL import Image

    img = Image.fromarray(np.asarray(image_rgb_uint8)).resize(
        (IMAGE_SIZE, IMAGE_SIZE), Image.BICUBIC)
    x = np.asarray(img, dtype=np.float32) / 255.0
    return torch.from_numpy((x - IMAGE_MEAN) / IMAGE_STD)[None]
