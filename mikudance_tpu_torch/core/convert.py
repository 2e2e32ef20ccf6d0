"""Reference ``state_dict`` <-> JAX parameter tree, both directions.

The forward converters (``convert_unet``, ``convert_vae_encoder``,
``convert_vae_decoder``, ``convert_clip_vision``, ``convert_temporal_decoder``
and their sub-tree helpers) are copied from the JAX package
(``mikudance_tpu/core/convert.py:29-390``); they are numpy only. The
port names its parameters in the reference checkpoint's key grammar
(diffusers UNet / VAE names), so a port ``state_dict`` goes through them to
the JAX tree, and a released ``.pth`` loads into the port with no converter.

The toolbox's converters (``convert_swin``, ``convert_unipose``,
``convert_clip_text``, ``convert_clip_text_hf``, ``convert_dpt``) are copied
from ``mikudance_tpu/core/convert.py:397-620`` as well; the toolbox networks
carry the XPose and Hugging Face key grammars those read.

The inverses (``unet_state_dict_from_jax``, ``vae_encoder_state_dict_from_jax``,
``vae_decoder_state_dict_from_jax``, ``temporal_decoder_state_dict_from_jax``,
``clip_vision_state_dict_from_jax``, ``swin_state_dict_from_jax``,
``unipose_state_dict_from_jax``, ``clip_text_state_dict_from_jax`` and
``dpt_state_dict_from_jax``) turn a JAX tree of numpy arrays back into a
``state_dict`` that loads into the port's modules with ``strict=True``.

Transform rules (forward; the inverses undo them):
- Conv2d weight (O, I, kh, kw) -> HWIO kernel (kh, kw, I, O)
- 1x1-conv projections that became Dense (spatial transformer
  proj_in/proj_out) -> squeeze spatial dims, transpose to (I, O)
- Conv3d (3,1,1) weight (O, I, 3, 1, 1) -> kernel (3, 1, I, O)
- Linear weight (O, I) -> kernel (I, O)
- Norm weight -> scale
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

from ..toolbox.swin import relative_position_index


def _t(x) -> np.ndarray:
    """torch tensor / array -> numpy float32 array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def conv_kernel(x) -> np.ndarray:
    return _t(x).transpose(2, 3, 1, 0)  # OIHW -> HWIO


def dense_kernel(x) -> np.ndarray:
    return _t(x).T  # (O, I) -> (I, O)


def conv1x1_as_dense(x) -> np.ndarray:
    a = _t(x)
    if a.ndim == 4:  # (O, I, 1, 1)
        a = a[:, :, 0, 0]
    return a.T


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


# --------------------------------------------------------------------------
# sub-tree converters (shared between the UNets)
# --------------------------------------------------------------------------

def _convert_resnet(src: Mapping, prefix: str, out: Dict, dst: Tuple[str, ...]):
    m = {
        "norm1.weight": ("norm1", "scale", _t),
        "norm1.bias": ("norm1", "bias", _t),
        "conv1.weight": ("conv1", "kernel", conv_kernel),
        "conv1.bias": ("conv1", "bias", _t),
        "time_emb_proj.weight": ("time_emb_proj", "kernel", dense_kernel),
        "time_emb_proj.bias": ("time_emb_proj", "bias", _t),
        "norm2.weight": ("norm2", "scale", _t),
        "norm2.bias": ("norm2", "bias", _t),
        "conv2.weight": ("conv2", "kernel", conv_kernel),
        "conv2.bias": ("conv2", "bias", _t),
        "conv_shortcut.weight": ("conv_shortcut", "kernel", conv_kernel),
        "conv_shortcut.bias": ("conv_shortcut", "bias", _t),
    }
    for k, (sub, leaf, fn) in m.items():
        key = f"{prefix}.{k}"
        if key in src:
            _set(out, dst + (sub, leaf), fn(src[key]))


def _convert_attention(src: Mapping, prefix: str, out: Dict, dst: Tuple[str, ...]):
    """diffusers Attention: to_q/k/v (no bias) + to_out.0 (bias)."""
    for name in ("to_q", "to_k", "to_v"):
        _set(out, dst + (name, "kernel"), dense_kernel(src[f"{prefix}.{name}.weight"]))
    _set(out, dst + ("to_out", "kernel"), dense_kernel(src[f"{prefix}.to_out.0.weight"]))
    _set(out, dst + ("to_out", "bias"), _t(src[f"{prefix}.to_out.0.bias"]))


def _convert_transformer_block(src: Mapping, prefix: str, out: Dict, dst: Tuple[str, ...]):
    """(Temporal)BasicTransformerBlock -> TransformerBlock."""
    for n in ("norm1", "norm2", "norm3"):
        _set(out, dst + (n, "scale"), _t(src[f"{prefix}.{n}.weight"]))
        _set(out, dst + (n, "bias"), _t(src[f"{prefix}.{n}.bias"]))
    _convert_attention(src, f"{prefix}.attn1", out, dst + ("attn1",))
    _convert_attention(src, f"{prefix}.attn2", out, dst + ("attn2",))
    _set(out, dst + ("ff", "proj", "kernel"), dense_kernel(src[f"{prefix}.ff.net.0.proj.weight"]))
    _set(out, dst + ("ff", "proj", "bias"), _t(src[f"{prefix}.ff.net.0.proj.bias"]))
    _set(out, dst + ("ff", "out", "kernel"), dense_kernel(src[f"{prefix}.ff.net.2.weight"]))
    _set(out, dst + ("ff", "out", "bias"), _t(src[f"{prefix}.ff.net.2.bias"]))


def _convert_spatial_transformer(src: Mapping, prefix: str, out: Dict, dst: Tuple[str, ...]):
    """Transformer2DModel/3D -> SpatialTransformer (1x1 convs become Dense)."""
    _set(out, dst + ("norm", "scale"), _t(src[f"{prefix}.norm.weight"]))
    _set(out, dst + ("norm", "bias"), _t(src[f"{prefix}.norm.bias"]))
    _set(out, dst + ("proj_in", "kernel"), conv1x1_as_dense(src[f"{prefix}.proj_in.weight"]))
    _set(out, dst + ("proj_in", "bias"), _t(src[f"{prefix}.proj_in.bias"]))
    _convert_transformer_block(src, f"{prefix}.transformer_blocks.0", out, dst + ("block",))
    _set(out, dst + ("proj_out", "kernel"), conv1x1_as_dense(src[f"{prefix}.proj_out.weight"]))
    _set(out, dst + ("proj_out", "bias"), _t(src[f"{prefix}.proj_out.bias"]))


def _convert_motion_module(src: Mapping, prefix: str, out: Dict, dst: Tuple[str, ...]):
    """motion_modules.{j}.temporal_transformer -> MotionModule."""
    p = f"{prefix}.temporal_transformer"
    _set(out, dst + ("norm", "scale"), _t(src[f"{p}.norm.weight"]))
    _set(out, dst + ("norm", "bias"), _t(src[f"{p}.norm.bias"]))
    _set(out, dst + ("proj_in", "kernel"), dense_kernel(src[f"{p}.proj_in.weight"]))
    _set(out, dst + ("proj_in", "bias"), _t(src[f"{p}.proj_in.bias"]))
    _set(out, dst + ("proj_out", "kernel"), dense_kernel(src[f"{p}.proj_out.weight"]))
    _set(out, dst + ("proj_out", "bias"), _t(src[f"{p}.proj_out.bias"]))
    for b in range(8):  # num transformer blocks (config uses 1)
        bp = f"{p}.transformer_blocks.{b}"
        if f"{bp}.ff_norm.weight" not in src:
            break
        for a in range(8):  # attention layers per block (config uses 2)
            ap = f"{bp}.attention_blocks.{a}"
            if f"{ap}.to_q.weight" not in src:
                break
            _set(out, dst + (f"blocks_{b}_norm_{a}", "scale"), _t(src[f"{bp}.norms.{a}.weight"]))
            _set(out, dst + (f"blocks_{b}_norm_{a}", "bias"), _t(src[f"{bp}.norms.{a}.bias"]))
            _convert_attention(src, ap, out, dst + (f"blocks_{b}_attn_{a}", "attn"))
        _set(out, dst + (f"blocks_{b}_ff_norm", "scale"), _t(src[f"{bp}.ff_norm.weight"]))
        _set(out, dst + (f"blocks_{b}_ff_norm", "bias"), _t(src[f"{bp}.ff_norm.bias"]))
        _set(out, dst + (f"blocks_{b}_ff", "proj", "kernel"), dense_kernel(src[f"{bp}.ff.net.0.proj.weight"]))
        _set(out, dst + (f"blocks_{b}_ff", "proj", "bias"), _t(src[f"{bp}.ff.net.0.proj.bias"]))
        _set(out, dst + (f"blocks_{b}_ff", "out", "kernel"), dense_kernel(src[f"{bp}.ff.net.2.weight"]))
        _set(out, dst + (f"blocks_{b}_ff", "out", "bias"), _t(src[f"{bp}.ff.net.2.bias"]))


def _convert_man(src: Mapping, prefix: str, out: Dict, dst: Tuple[str, ...]):
    _set(out, dst + ("mlp_shared", "kernel"), conv_kernel(src[f"{prefix}.mlp_shared.0.weight"]))
    _set(out, dst + ("mlp_shared", "bias"), _t(src[f"{prefix}.mlp_shared.0.bias"]))
    for n in ("mlp_gamma", "mlp_beta"):
        _set(out, dst + (n, "kernel"), conv_kernel(src[f"{prefix}.{n}.weight"]))
        _set(out, dst + (n, "bias"), _t(src[f"{prefix}.{n}.bias"]))


# --------------------------------------------------------------------------
# whole-model converters
# --------------------------------------------------------------------------

def convert_unet(
    src: Mapping, num_blocks: int = 4, layers_per_block: int = 2,
    with_motion: bool = False, with_man: bool = False, with_conv_out: bool = True,
) -> Dict:
    """diffusers-UNet-style state dict -> GuidanceUNet / DenoisingUNet params."""
    out: Dict[str, Any] = {}
    _set(out, ("conv_in", "kernel"), conv_kernel(src["conv_in.weight"]))
    _set(out, ("conv_in", "bias"), _t(src["conv_in.bias"]))
    for i in (1, 2):
        _set(out, ("time_embedding", f"linear_{i}", "kernel"),
             dense_kernel(src[f"time_embedding.linear_{i}.weight"]))
        _set(out, ("time_embedding", f"linear_{i}", "bias"),
             _t(src[f"time_embedding.linear_{i}.bias"]))

    for i in range(num_blocks):
        has_attn = i < num_blocks - 1
        for j in range(layers_per_block):
            _convert_resnet(src, f"down_blocks.{i}.resnets.{j}", out, (f"down_{i}_res_{j}",))
            if has_attn:
                _convert_spatial_transformer(
                    src, f"down_blocks.{i}.attentions.{j}", out, (f"down_{i}_attn_{j}",))
            if with_motion and f"down_blocks.{i}.motion_modules.{j}.temporal_transformer.norm.weight" in src:
                _convert_motion_module(
                    src, f"down_blocks.{i}.motion_modules.{j}", out, (f"down_{i}_motion_{j}",))
        if i < num_blocks - 1:
            _set(out, (f"down_{i}_down", "conv", "kernel"),
                 conv_kernel(src[f"down_blocks.{i}.downsamplers.0.conv.weight"]))
            _set(out, (f"down_{i}_down", "conv", "bias"),
                 _t(src[f"down_blocks.{i}.downsamplers.0.conv.bias"]))
        if with_man and f"man_blocks.{i}.mlp_gamma.weight" in src:
            _convert_man(src, f"man_blocks.{i}", out, (f"man_{i}",))

    _convert_resnet(src, "mid_block.resnets.0", out, ("mid_res_0",))
    _convert_spatial_transformer(src, "mid_block.attentions.0", out, ("mid_attn",))
    _convert_resnet(src, "mid_block.resnets.1", out, ("mid_res_1",))
    if with_motion and "mid_block.motion_modules.0.temporal_transformer.norm.weight" in src:
        _convert_motion_module(src, "mid_block.motion_modules.0", out, ("mid_motion",))

    for i in range(num_blocks):
        has_attn = i > 0
        for j in range(layers_per_block + 1):
            _convert_resnet(src, f"up_blocks.{i}.resnets.{j}", out, (f"up_{i}_res_{j}",))
            if has_attn:
                _convert_spatial_transformer(
                    src, f"up_blocks.{i}.attentions.{j}", out, (f"up_{i}_attn_{j}",))
            if with_motion and f"up_blocks.{i}.motion_modules.{j}.temporal_transformer.norm.weight" in src:
                _convert_motion_module(
                    src, f"up_blocks.{i}.motion_modules.{j}", out, (f"up_{i}_motion_{j}",))
        if i < num_blocks - 1:
            _set(out, (f"up_{i}_up", "conv", "kernel"),
                 conv_kernel(src[f"up_blocks.{i}.upsamplers.0.conv.weight"]))
            _set(out, (f"up_{i}_up", "conv", "bias"),
                 _t(src[f"up_blocks.{i}.upsamplers.0.conv.bias"]))

    if with_conv_out and "conv_out.weight" in src:
        _set(out, ("conv_norm_out", "scale"), _t(src["conv_norm_out.weight"]))
        _set(out, ("conv_norm_out", "bias"), _t(src["conv_norm_out.bias"]))
        _set(out, ("conv_out", "kernel"), conv_kernel(src["conv_out.weight"]))
        _set(out, ("conv_out", "bias"), _t(src["conv_out.bias"]))
    return out


def _convert_vae_resnet(src: Mapping, prefix: str, out: Dict, dst: Tuple[str, ...]):
    _convert_resnet(src, prefix, out, dst)  # same key set minus time_emb_proj


def _convert_vae_attention(src: Mapping, prefix: str, out: Dict, dst: Tuple[str, ...]):
    _set(out, dst + ("group_norm", "scale"), _t(src[f"{prefix}.group_norm.weight"]))
    _set(out, dst + ("group_norm", "bias"), _t(src[f"{prefix}.group_norm.bias"]))
    for n in ("to_q", "to_k", "to_v"):
        _set(out, dst + (n, "kernel"), dense_kernel(src[f"{prefix}.{n}.weight"]))
        _set(out, dst + (n, "bias"), _t(src[f"{prefix}.{n}.bias"]))
    _set(out, dst + ("to_out", "kernel"), dense_kernel(src[f"{prefix}.to_out.0.weight"]))
    _set(out, dst + ("to_out", "bias"), _t(src[f"{prefix}.to_out.0.bias"]))


def convert_vae_encoder(src: Mapping, num_blocks: int = 4, layers_per_block: int = 2) -> Dict:
    out: Dict[str, Any] = {}
    _set(out, ("conv_in", "kernel"), conv_kernel(src["encoder.conv_in.weight"]))
    _set(out, ("conv_in", "bias"), _t(src["encoder.conv_in.bias"]))
    for i in range(num_blocks):
        for j in range(layers_per_block):
            _convert_vae_resnet(src, f"encoder.down_blocks.{i}.resnets.{j}", out, (f"down_{i}_res_{j}",))
        if i < num_blocks - 1:
            _set(out, (f"down_{i}_down", "conv", "kernel"),
                 conv_kernel(src[f"encoder.down_blocks.{i}.downsamplers.0.conv.weight"]))
            _set(out, (f"down_{i}_down", "conv", "bias"),
                 _t(src[f"encoder.down_blocks.{i}.downsamplers.0.conv.bias"]))
    _convert_vae_resnet(src, "encoder.mid_block.resnets.0", out, ("mid_res_0",))
    _convert_vae_attention(src, "encoder.mid_block.attentions.0", out, ("mid_attn",))
    _convert_vae_resnet(src, "encoder.mid_block.resnets.1", out, ("mid_res_1",))
    _set(out, ("conv_norm_out", "scale"), _t(src["encoder.conv_norm_out.weight"]))
    _set(out, ("conv_norm_out", "bias"), _t(src["encoder.conv_norm_out.bias"]))
    _set(out, ("conv_out", "kernel"), conv_kernel(src["encoder.conv_out.weight"]))
    _set(out, ("conv_out", "bias"), _t(src["encoder.conv_out.bias"]))
    _set(out, ("quant_conv", "kernel"), conv_kernel(src["quant_conv.weight"]))
    _set(out, ("quant_conv", "bias"), _t(src["quant_conv.bias"]))
    return out


def convert_vae_decoder(src: Mapping, num_blocks: int = 4, layers_per_block: int = 2) -> Dict:
    out: Dict[str, Any] = {}
    _set(out, ("post_quant_conv", "kernel"), conv_kernel(src["post_quant_conv.weight"]))
    _set(out, ("post_quant_conv", "bias"), _t(src["post_quant_conv.bias"]))
    _set(out, ("conv_in", "kernel"), conv_kernel(src["decoder.conv_in.weight"]))
    _set(out, ("conv_in", "bias"), _t(src["decoder.conv_in.bias"]))
    _convert_vae_resnet(src, "decoder.mid_block.resnets.0", out, ("mid_res_0",))
    _convert_vae_attention(src, "decoder.mid_block.attentions.0", out, ("mid_attn",))
    _convert_vae_resnet(src, "decoder.mid_block.resnets.1", out, ("mid_res_1",))
    for i in range(num_blocks):
        for j in range(layers_per_block + 1):
            _convert_vae_resnet(src, f"decoder.up_blocks.{i}.resnets.{j}", out, (f"up_{i}_res_{j}",))
        if i < num_blocks - 1:
            _set(out, (f"up_{i}_up", "conv", "kernel"),
                 conv_kernel(src[f"decoder.up_blocks.{i}.upsamplers.0.conv.weight"]))
            _set(out, (f"up_{i}_up", "conv", "bias"),
                 _t(src[f"decoder.up_blocks.{i}.upsamplers.0.conv.bias"]))
    _set(out, ("conv_norm_out", "scale"), _t(src["decoder.conv_norm_out.weight"]))
    _set(out, ("conv_norm_out", "bias"), _t(src["decoder.conv_norm_out.bias"]))
    _set(out, ("conv_out", "kernel"), conv_kernel(src["decoder.conv_out.weight"]))
    _set(out, ("conv_out", "bias"), _t(src["decoder.conv_out.bias"]))
    return out


def convert_clip_vision(src: Mapping, num_layers: int = 24) -> Dict:
    """Hugging Face ``CLIPVisionModelWithProjection`` keys -> CLIPVisionTower params."""
    out: Dict[str, Any] = {}
    _set(out, ("class_embedding",), _t(src["vision_model.embeddings.class_embedding"]))
    _set(out, ("patch_embedding", "kernel"),
         conv_kernel(src["vision_model.embeddings.patch_embedding.weight"]))
    _set(out, ("position_embedding",), _t(src["vision_model.embeddings.position_embedding.weight"]))
    for n in ("pre_layrnorm", "post_layernorm"):
        _set(out, (n, "scale"), _t(src[f"vision_model.{n}.weight"]))
        _set(out, (n, "bias"), _t(src[f"vision_model.{n}.bias"]))
    for i in range(num_layers):
        p = f"vision_model.encoder.layers.{i}"
        d = f"layers_{i}"
        for n in ("layer_norm1", "layer_norm2"):
            _set(out, (d, n, "scale"), _t(src[f"{p}.{n}.weight"]))
            _set(out, (d, n, "bias"), _t(src[f"{p}.{n}.bias"]))
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _set(out, (d, n, "kernel"), dense_kernel(src[f"{p}.self_attn.{n}.weight"]))
            _set(out, (d, n, "bias"), _t(src[f"{p}.self_attn.{n}.bias"]))
        for n in ("fc1", "fc2"):
            _set(out, (d, n, "kernel"), dense_kernel(src[f"{p}.mlp.{n}.weight"]))
            _set(out, (d, n, "bias"), _t(src[f"{p}.mlp.{n}.bias"]))
    _set(out, ("visual_projection", "kernel"), dense_kernel(src["visual_projection.weight"]))
    return out


def merge_state_dicts(base: Mapping, extra: Mapping) -> Dict:
    """strict=False-style merge: extra keys override base
    (`unet_3d_mix.py:637-684` motion-module merge)."""
    out = dict(base)
    out.update(extra)
    return out


def conv_temporal_kernel(x) -> np.ndarray:
    """torch Conv3d (O, I, 3, 1, 1) -> (3, 1, I, O)."""
    a = _t(x)[:, :, :, 0, :]  # (O, I, 3, 1)
    return a.transpose(2, 3, 1, 0)


def _convert_st_resblock(src: Mapping, prefix: str, out: Dict, dst: Tuple[str, ...]):
    """SpatioTemporalResBlock -> spatial_* + temporal_res_block + mix_factor."""
    sp = f"{prefix}.spatial_res_block"
    m = {
        "norm1.weight": ("spatial_norm1", "scale", _t),
        "norm1.bias": ("spatial_norm1", "bias", _t),
        "conv1.weight": ("spatial_conv1", "kernel", conv_kernel),
        "conv1.bias": ("spatial_conv1", "bias", _t),
        "norm2.weight": ("spatial_norm2", "scale", _t),
        "norm2.bias": ("spatial_norm2", "bias", _t),
        "conv2.weight": ("spatial_conv2", "kernel", conv_kernel),
        "conv2.bias": ("spatial_conv2", "bias", _t),
        "conv_shortcut.weight": ("spatial_conv_shortcut", "kernel", conv_kernel),
        "conv_shortcut.bias": ("spatial_conv_shortcut", "bias", _t),
    }
    for k, (sub, leaf, fn) in m.items():
        key = f"{sp}.{k}"
        if key in src:
            _set(out, dst + (sub, leaf), fn(src[key]))
    tp = f"{prefix}.temporal_res_block"
    for n in ("norm1", "norm2"):
        _set(out, dst + ("temporal_res_block", n, "scale"), _t(src[f"{tp}.{n}.weight"]))
        _set(out, dst + ("temporal_res_block", n, "bias"), _t(src[f"{tp}.{n}.bias"]))
    for n in ("conv1", "conv2"):
        _set(out, dst + ("temporal_res_block", n, "conv", "kernel"),
             conv_temporal_kernel(src[f"{tp}.{n}.weight"]))
        _set(out, dst + ("temporal_res_block", n, "conv", "bias"), _t(src[f"{tp}.{n}.bias"]))
    _set(out, dst + ("mix_factor",), _t(src[f"{prefix}.time_mixer.mix_factor"]).reshape(1))


def convert_temporal_decoder(src: Mapping, num_blocks: int = 4, layers_per_block: int = 2) -> Dict:
    """AutoencoderKLTemporalDecoder ``decoder.*`` keys -> TemporalDecoder params."""
    out: Dict[str, Any] = {}
    _set(out, ("conv_in", "kernel"), conv_kernel(src["decoder.conv_in.weight"]))
    _set(out, ("conv_in", "bias"), _t(src["decoder.conv_in.bias"]))
    _convert_st_resblock(src, "decoder.mid_block.resnets.0", out, ("mid_res_0",))
    _convert_vae_attention(src, "decoder.mid_block.attentions.0", out, ("mid_attn",))
    _convert_st_resblock(src, "decoder.mid_block.resnets.1", out, ("mid_res_1",))
    for i in range(num_blocks):
        for j in range(layers_per_block + 1):
            _convert_st_resblock(src, f"decoder.up_blocks.{i}.resnets.{j}", out,
                                 (f"up_{i}_res_{j}",))
        if i < num_blocks - 1:
            _set(out, (f"up_{i}_up", "conv", "kernel"),
                 conv_kernel(src[f"decoder.up_blocks.{i}.upsamplers.0.conv.weight"]))
            _set(out, (f"up_{i}_up", "conv", "bias"),
                 _t(src[f"decoder.up_blocks.{i}.upsamplers.0.conv.bias"]))
    _set(out, ("conv_norm_out", "scale"), _t(src["decoder.conv_norm_out.weight"]))
    _set(out, ("conv_norm_out", "bias"), _t(src["decoder.conv_norm_out.bias"]))
    _set(out, ("conv_out", "kernel"), conv_kernel(src["decoder.conv_out.weight"]))
    _set(out, ("conv_out", "bias"), _t(src["decoder.conv_out.bias"]))
    # time_conv_out lives inside the decoder module in diffusers'
    # AutoencoderKLTemporalDecoder; accept a pre-stripped dict too.
    tk = "decoder.time_conv_out" if "decoder.time_conv_out.weight" in src else "time_conv_out"
    _set(out, ("time_conv_out", "conv", "kernel"),
         conv_temporal_kernel(src[f"{tk}.weight"]))
    _set(out, ("time_conv_out", "conv", "bias"), _t(src[f"{tk}.bias"]))
    return out


# --------------------------------------------------------------------------
# UniPose (XPose) checkpoint converter
# --------------------------------------------------------------------------

def _convert_ln(src: Mapping, prefix: str, out: Dict, dst: Tuple[str, ...]):
    _set(out, dst + ("scale",), _t(src[f"{prefix}.weight"]))
    _set(out, dst + ("bias",), _t(src[f"{prefix}.bias"]))


def _convert_dense(src: Mapping, prefix: str, out: Dict, dst: Tuple[str, ...]):
    _set(out, dst + ("kernel",), dense_kernel(src[f"{prefix}.weight"]))
    if f"{prefix}.bias" in src:
        _set(out, dst + ("bias",), _t(src[f"{prefix}.bias"]))


def _convert_mha(src: Mapping, prefix: str, out: Dict, dst: Tuple[str, ...]):
    """torch nn.MultiheadAttention packed in_proj -> q/k/v/out Dense."""
    w = _t(src[f"{prefix}.in_proj_weight"])  # (3C, C)
    b = _t(src[f"{prefix}.in_proj_bias"])
    C = w.shape[1]
    for i, n in enumerate(("q_proj", "k_proj", "v_proj")):
        _set(out, dst + (n, "kernel"), w[i * C:(i + 1) * C].T)
        _set(out, dst + (n, "bias"), b[i * C:(i + 1) * C])
    _convert_dense(src, f"{prefix}.out_proj", out, dst + ("out_proj",))


def _convert_mlp(src: Mapping, prefix: str, out: Dict, dst: Tuple[str, ...],
                 num_layers: int = 3):
    for k in range(num_layers):
        _convert_dense(src, f"{prefix}.layers.{k}", out, dst + (f"layers_{k}",))


def _convert_deform_attn(src: Mapping, prefix: str, out: Dict, dst: Tuple[str, ...]):
    for n in ("value_proj", "sampling_offsets", "attention_weights", "output_proj"):
        _convert_dense(src, f"{prefix}.{n}", out, dst + (n,))


def convert_swin(src: Mapping, prefix: str = "backbone.0",
                 depths: Tuple[int, ...] = (2, 2, 6, 2),
                 out_indices: Tuple[int, ...] = (1, 2, 3)) -> Dict:
    """Swin-T detection backbone (`swin_transformer.py:429+`) -> SwinTransformer."""
    out: Dict[str, Any] = {}
    _set(out, ("patch_embed", "kernel"), conv_kernel(src[f"{prefix}.patch_embed.proj.weight"]))
    _set(out, ("patch_embed", "bias"), _t(src[f"{prefix}.patch_embed.proj.bias"]))
    _convert_ln(src, f"{prefix}.patch_embed.norm", out, ("patch_norm",))
    for i, depth in enumerate(depths):
        for j in range(depth):
            bp = f"{prefix}.layers.{i}.blocks.{j}".lstrip(".")
            dst = (f"stage_{i}_block_{j}",)
            _convert_ln(src, f"{bp}.norm1", out, dst + ("norm1",))
            _convert_ln(src, f"{bp}.norm2", out, dst + ("norm2",))
            _set(out, dst + ("attn", "relative_position_bias_table"),
                 _t(src[f"{bp}.attn.relative_position_bias_table"]))
            _convert_dense(src, f"{bp}.attn.qkv", out, dst + ("attn", "qkv"))
            _convert_dense(src, f"{bp}.attn.proj", out, dst + ("attn", "proj"))
            _convert_dense(src, f"{bp}.mlp.fc1", out, dst + ("fc1",))
            _convert_dense(src, f"{bp}.mlp.fc2", out, dst + ("fc2",))
        if i < len(depths) - 1:
            _convert_ln(src, f"{prefix}.layers.{i}.downsample.norm", out,
                        (f"merge_{i}", "norm"))
            _convert_dense(src, f"{prefix}.layers.{i}.downsample.reduction", out,
                           (f"merge_{i}", "reduction"))
    for k in out_indices:
        _convert_ln(src, f"{prefix}.norm{k}", out, (f"out_norm_{k}",))
    return out


def convert_unipose(src: Mapping, enc_layers: int = 6, dec_layers: int = 6,
                    num_levels: int = 4,
                    depths: Tuple[int, ...] = (2, 2, 6, 2),
                    out_indices: Tuple[int, ...] = (1, 2, 3)) -> Dict:
    """Released UniPose checkpoint (`unipose.py:505` build; keys as saved by
    the reference training, 'module.' prefix already stripped) -> the Flax
    ``toolbox.unipose.UniPose`` param tree.

    Skipped-by-design keys (dead at inference): label_enc, pos_proj, padding,
    clip_model.* (`unipose.py:421-426` multiplies them by 0.0), and the
    duplicate shared-head entries (bbox_embed.1..5, transformer.decoder.*_embed,
    transformer.enc_out_bbox_embed) which alias bbox_embed.0 tensors.
    """
    out: Dict[str, Any] = {}
    out["backbone"] = convert_swin(src, "backbone.0", depths, out_indices)

    for i in range(num_levels):
        _set(out, (f"input_proj_{i}", "kernel"), conv_kernel(src[f"input_proj.{i}.0.weight"]))
        _set(out, (f"input_proj_{i}", "bias"), _t(src[f"input_proj.{i}.0.bias"]))
        _convert_ln(src, f"input_proj.{i}.1", out, (f"input_proj_norm_{i}",))

    _set(out, ("level_embed",), _t(src["transformer.level_embed"]))
    _set(out, ("tgt_embed",), _t(src["transformer.tgt_embed.weight"]))
    _set(out, ("hw",), _t(src["transformer.decoder.hw.weight"]))
    _set(out, ("hw_append",), _t(src["transformer.decoder.hw_append.weight"]))
    _convert_dense(src, "transformer.enc_output", out, ("enc_output",))
    _convert_ln(src, "transformer.enc_output_norm", out, ("enc_output_norm",))
    _convert_ln(src, "transformer.decoder.norm", out, ("decoder_norm",))
    _convert_mlp(src, "transformer.decoder.ref_point_head", out,
                 ("ref_point_head",), num_layers=2)

    for i in range(enc_layers):
        ep = f"transformer.encoder.layers.{i}"
        _convert_deform_attn(src, f"{ep}.self_attn", out, (f"enc_{i}", "self_attn"))
        for n in ("norm1", "norm2"):
            _convert_ln(src, f"{ep}.{n}", out, (f"enc_{i}", n))
        for n in ("linear1", "linear2"):
            _convert_dense(src, f"{ep}.{n}", out, (f"enc_{i}", n))

        tp = f"transformer.encoder.text_layers.{i}"
        _convert_mha(src, f"{tp}.self_attn", out, (f"text_{i}", "self_attn"))
        for n in ("norm1", "norm2"):
            _convert_ln(src, f"{tp}.{n}", out, (f"text_{i}", n))
        for n in ("linear1", "linear2"):
            _convert_dense(src, f"{tp}.{n}", out, (f"text_{i}", n))

        fp = f"transformer.encoder.fusion_layers.{i}"
        _convert_ln(src, f"{fp}.layer_norm_v", out, (f"fusion_{i}", "layer_norm_v"))
        _convert_ln(src, f"{fp}.layer_norm_l", out, (f"fusion_{i}", "layer_norm_l"))
        for n in ("v_proj", "l_proj", "values_v_proj", "values_l_proj",
                  "out_v_proj", "out_l_proj"):
            _convert_dense(src, f"{fp}.attn.{n}", out, (f"fusion_{i}", n))
        _set(out, (f"fusion_{i}", "gamma_v"), _t(src[f"{fp}.gamma_v"]))
        _set(out, (f"fusion_{i}", "gamma_l"), _t(src[f"{fp}.gamma_l"]))

    for i in range(dec_layers):
        dp = f"transformer.decoder.layers.{i}"
        _convert_deform_attn(src, f"{dp}.cross_attn", out, (f"dec_{i}", "cross_attn"))
        _convert_mha(src, f"{dp}.self_attn", out, (f"dec_{i}", "self_attn"))
        _convert_mha(src, f"{dp}.ca_text", out, (f"dec_{i}", "ca_text"))
        for n in ("norm1", "norm2", "norm3", "catext_norm"):
            _convert_ln(src, f"{dp}.{n}", out, (f"dec_{i}", n))
        for n in ("linear1", "linear2"):
            _convert_dense(src, f"{dp}.{n}", out, (f"dec_{i}", n))

    _convert_mlp(src, "bbox_embed.0", out, ("bbox_embed",))
    _convert_mlp(src, "pose_embed.0", out, ("pose_embed",))
    _convert_mlp(src, "pose_hw_embed.0", out, ("pose_hw_embed",))
    _convert_mlp(src, "projection", out, ("projection",))
    _convert_mlp(src, "projection_kpt", out, ("projection_kpt",))
    return out


def convert_clip_text(src: Mapping, num_layers: int = 12) -> Dict:
    """OpenAI CLIP (ViT-B/32) text tower -> toolbox.clip_text.CLIPTextEncoder.
    Keys as in the released CLIP state dict (`clip.load` model)."""
    out: Dict[str, Any] = {}
    _set(out, ("token_embedding",), _t(src["token_embedding.weight"]))
    _set(out, ("positional_embedding",), _t(src["positional_embedding"]))
    for i in range(num_layers):
        p = f"transformer.resblocks.{i}"
        d = f"layers_{i}"
        _convert_ln(src, f"{p}.ln_1", out, (f"{d}_ln_1",))
        _convert_ln(src, f"{p}.ln_2", out, (f"{d}_ln_2",))
        _set(out, (f"{d}_attn_in", "kernel"), dense_kernel(src[f"{p}.attn.in_proj_weight"]))
        _set(out, (f"{d}_attn_in", "bias"), _t(src[f"{p}.attn.in_proj_bias"]))
        _convert_dense(src, f"{p}.attn.out_proj", out, (f"{d}_attn_out",))
        _convert_dense(src, f"{p}.mlp.c_fc", out, (f"{d}_fc",))
        _convert_dense(src, f"{p}.mlp.c_proj", out, (f"{d}_proj",))
    _convert_ln(src, "ln_final", out, ("ln_final",))
    _set(out, ("text_projection",), _t(src["text_projection"]))
    return out


def convert_clip_text_hf(src: Mapping, num_layers: int = 12) -> Dict:
    """transformers-format CLIP text tower (openai/clip-vit-base-patch32
    pytorch_model.bin) -> CLIPTextEncoder. Same math as the openai-format
    converter above (quick_gelu, EOT pooling); only key names differ."""
    out: Dict[str, Any] = {}
    pre = "text_model."
    _set(out, ("token_embedding",), _t(src[f"{pre}embeddings.token_embedding.weight"]))
    _set(out, ("positional_embedding",),
         _t(src[f"{pre}embeddings.position_embedding.weight"]))
    for i in range(num_layers):
        p = f"{pre}encoder.layers.{i}"
        d = f"layers_{i}"
        _convert_ln(src, f"{p}.layer_norm1", out, (f"{d}_ln_1",))
        _convert_ln(src, f"{p}.layer_norm2", out, (f"{d}_ln_2",))
        # pack hf q/k/v into the fused attn_in Dense (q;k;v column order)
        qw = _t(src[f"{p}.self_attn.q_proj.weight"])
        kw = _t(src[f"{p}.self_attn.k_proj.weight"])
        vw = _t(src[f"{p}.self_attn.v_proj.weight"])
        qb = _t(src[f"{p}.self_attn.q_proj.bias"])
        kb = _t(src[f"{p}.self_attn.k_proj.bias"])
        vb = _t(src[f"{p}.self_attn.v_proj.bias"])
        _set(out, (f"{d}_attn_in", "kernel"), np.concatenate([qw, kw, vw], 0).T)
        _set(out, (f"{d}_attn_in", "bias"), np.concatenate([qb, kb, vb], 0))
        _convert_dense(src, f"{p}.self_attn.out_proj", out, (f"{d}_attn_out",))
        _convert_dense(src, f"{p}.mlp.fc1", out, (f"{d}_fc",))
        _convert_dense(src, f"{p}.mlp.fc2", out, (f"{d}_proj",))
    _convert_ln(src, f"{pre}final_layer_norm", out, ("ln_final",))
    _set(out, ("text_projection",), dense_kernel(src["text_projection.weight"]))
    return out


def _convert_conv(src: Mapping, prefix: str, out: Dict, dst: Tuple[str, ...]):
    _set(out, dst + ("kernel",), conv_kernel(src[f"{prefix}.weight"]))
    if f"{prefix}.bias" in src:
        _set(out, dst + ("bias",), _t(src[f"{prefix}.bias"]))


def convert_dpt(src: Mapping, depths: Tuple[int, ...] = (3, 4, 9),
                num_layers: int = 12) -> Dict:
    """transformers DPTForDepthEstimation(is_hybrid=True) state dict
    (Intel/dpt-hybrid-midas) -> toolbox.dpt.DPTHybridDepth param tree.

    Layout notes: BiT weight-standardized convs keep raw kernels (the
    standardization is applied at forward time on both sides); the ViT patch
    projection and fusion projections stay 1x1 convs; the reassemble
    projections become Dense. `dpt.layernorm` is skipped — the depth neck
    consumes raw (pre-final-layernorm) encoder states, so those weights are
    dead for depth estimation (modeling_dpt.DPTForDepthEstimation.forward).
    """
    out: Dict[str, Any] = {}
    bit = "dpt.embeddings.backbone.bit"
    _set(out, ("bit", "stem_conv", "kernel"),
         conv_kernel(src[f"{bit}.embedder.convolution.weight"]))
    _convert_ln(src, f"{bit}.embedder.norm", out, ("bit", "stem_norm"))
    for s, depth in enumerate(depths):
        for l in range(depth):
            p = f"{bit}.encoder.stages.{s}.layers.{l}"
            d = ("bit", f"stage{s}_layer{l}")
            if f"{p}.downsample.conv.weight" in src:
                _set(out, d + ("down_conv", "kernel"),
                     conv_kernel(src[f"{p}.downsample.conv.weight"]))
                _convert_ln(src, f"{p}.downsample.norm", out, d + ("down_norm",))
            for n in (1, 2, 3):
                _set(out, d + (f"conv{n}", "kernel"),
                     conv_kernel(src[f"{p}.conv{n}.weight"]))
                _convert_ln(src, f"{p}.norm{n}", out, d + (f"norm{n}",))

    _convert_conv(src, "dpt.embeddings.projection", out, ("projection",))
    _set(out, ("cls_token",), _t(src["dpt.embeddings.cls_token"]))
    _set(out, ("pos_embed",), _t(src["dpt.embeddings.position_embeddings"]))
    for i in range(num_layers):
        p = f"dpt.encoder.layer.{i}"
        d = (f"layer{i}",)
        _convert_ln(src, f"{p}.layernorm_before", out, d + ("ln1",))
        _convert_ln(src, f"{p}.layernorm_after", out, d + ("ln2",))
        _convert_dense(src, f"{p}.attention.attention.query", out, d + ("q",))
        _convert_dense(src, f"{p}.attention.attention.key", out, d + ("k",))
        _convert_dense(src, f"{p}.attention.attention.value", out, d + ("v",))
        _convert_dense(src, f"{p}.attention.output.dense", out, d + ("out",))
        _convert_dense(src, f"{p}.intermediate.dense", out, d + ("fc1",))
        _convert_dense(src, f"{p}.output.dense", out, d + ("fc2",))

    for i in (2, 3):
        _convert_dense(src, f"neck.reassemble_stage.readout_projects.{i}.0",
                       out, (f"readout{i}",))
        rp = f"neck.reassemble_stage.layers.{i}.projection"
        _set(out, (f"reassemble{i}_proj", "kernel"), conv1x1_as_dense(src[f"{rp}.weight"]))
        _set(out, (f"reassemble{i}_proj", "bias"), _t(src[f"{rp}.bias"]))
    _convert_conv(src, "neck.reassemble_stage.layers.3.resize", out,
                  ("reassemble3_resize",))
    for i in range(4):
        _set(out, (f"neck_conv{i}", "kernel"),
             conv_kernel(src[f"neck.convs.{i}.weight"]))
        p = f"neck.fusion_stage.layers.{i}"
        _convert_conv(src, f"{p}.projection", out, (f"fusion{i}_proj",))
        # fusion layer 0 (deepest) has no residual input; its residual_layer1
        # exists in the torch checkpoint but is never called — skip it.
        for r in ((2,) if i == 0 else (1, 2)):
            for c in (1, 2):
                _convert_conv(src, f"{p}.residual_layer{r}.convolution{c}", out,
                              (f"fusion{i}_res{r}", f"conv{c}"))
    _convert_conv(src, "head.head.0", out, ("head0",))
    _convert_conv(src, "head.head.2", out, ("head2",))
    _convert_conv(src, "head.head.4", out, ("head4",))
    return out


# --------------------------------------------------------------------------
# inverses: JAX param tree -> reference-grammar state_dict
# --------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _oihw(x) -> np.ndarray:
    return _np(np.asarray(x).transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _oi(x) -> np.ndarray:
    return _np(np.asarray(x).T)  # (I, O) -> (O, I)


def _oi11(x) -> np.ndarray:
    return _oi(x)[:, :, None, None]  # Dense (I, O) -> 1x1 conv (O, I, 1, 1)


def _get(tree: Mapping, path: Tuple[str, ...]):
    for k in path:
        if not isinstance(tree, Mapping) or k not in tree:
            return None
        tree = tree[k]
    return tree


# (state_dict key suffix, JAX sub-path, inverse transform)
_RESNET_RULES = tuple(
    (f"{n}.{leaf}", (n, "scale" if leaf == "weight" and n.startswith("norm") else
                     "kernel" if leaf == "weight" else "bias"),
     _np if leaf == "bias" or n.startswith("norm") else
     _oi if n == "time_emb_proj" else _oihw)
    for n in ("norm1", "conv1", "time_emb_proj", "norm2", "conv2", "conv_shortcut")
    for leaf in ("weight", "bias")
)


def _norm_rules(n: str, dst: str):
    return ((f"{n}.weight", (dst, "scale"), _np), (f"{n}.bias", (dst, "bias"), _np))


def _dense_rules(n: str, dst: Tuple[str, ...], bias: bool = True, fn=_oi):
    rules = ((f"{n}.weight", dst + ("kernel",), fn),)
    return rules + (((f"{n}.bias", dst + ("bias",), _np),) if bias else ())


_ATTENTION_RULES = (
    _dense_rules("to_q", ("to_q",), bias=False)
    + _dense_rules("to_k", ("to_k",), bias=False)
    + _dense_rules("to_v", ("to_v",), bias=False)
    + _dense_rules("to_out.0", ("to_out",))
)

_VAE_ATTENTION_RULES = (
    _norm_rules("group_norm", "group_norm")
    + _dense_rules("to_q", ("to_q",)) + _dense_rules("to_k", ("to_k",))
    + _dense_rules("to_v", ("to_v",)) + _dense_rules("to_out.0", ("to_out",))
)


def _prefixed(rules, key_prefix: str, path_prefix: Tuple[str, ...]):
    return tuple((f"{key_prefix}.{k}", path_prefix + p, fn) for k, p, fn in rules)


_TRANSFORMER_BLOCK_RULES = (
    _norm_rules("norm1", "norm1") + _norm_rules("norm2", "norm2")
    + _norm_rules("norm3", "norm3")
    + _prefixed(_ATTENTION_RULES, "attn1", ("attn1",))
    + _prefixed(_ATTENTION_RULES, "attn2", ("attn2",))
    + _dense_rules("ff.net.0.proj", ("ff", "proj"))
    + _dense_rules("ff.net.2", ("ff", "out"))
)

_SPATIAL_TRANSFORMER_RULES = (
    _norm_rules("norm", "norm")
    + _dense_rules("proj_in", ("proj_in",), fn=_oi11)
    + _prefixed(_TRANSFORMER_BLOCK_RULES, "transformer_blocks.0", ("block",))
    + _dense_rules("proj_out", ("proj_out",), fn=_oi11)
)

_MAN_RULES = (
    _dense_rules("mlp_shared.0", ("mlp_shared",), fn=_oihw)
    + _dense_rules("mlp_gamma", ("mlp_gamma",), fn=_oihw)
    + _dense_rules("mlp_beta", ("mlp_beta",), fn=_oihw)
)


def _emit(tree: Mapping, rules, prefix: str, dst: Tuple[str, ...], out: Dict):
    """Write every rule whose JAX leaf exists in ``tree`` under ``dst``."""
    for key, path, fn in rules:
        leaf = _get(tree, dst + path)
        if leaf is not None:
            out[f"{prefix}.{key}" if prefix else key] = fn(leaf)


def _motion_rules(tree: Mapping, dst: Tuple[str, ...]):
    rules = (
        _norm_rules("norm", "norm") + _dense_rules("proj_in", ("proj_in",))
        + _dense_rules("proj_out", ("proj_out",))
    )
    b = 0
    while _get(tree, dst + (f"blocks_{b}_ff_norm",)) is not None:
        bp = f"transformer_blocks.{b}"
        a = 0
        while _get(tree, dst + (f"blocks_{b}_norm_{a}",)) is not None:
            rules += _norm_rules(f"{bp}.norms.{a}", f"blocks_{b}_norm_{a}")
            rules += _prefixed(_ATTENTION_RULES, f"{bp}.attention_blocks.{a}",
                               (f"blocks_{b}_attn_{a}", "attn"))
            a += 1
        rules += _norm_rules(f"{bp}.ff_norm", f"blocks_{b}_ff_norm")
        rules += _dense_rules(f"{bp}.ff.net.0.proj", (f"blocks_{b}_ff", "proj"))
        rules += _dense_rules(f"{bp}.ff.net.2", (f"blocks_{b}_ff", "out"))
        b += 1
    return _prefixed(rules, "temporal_transformer", ())


def unet_state_dict_from_jax(
    tree: Mapping, num_blocks: int = 4, layers_per_block: int = 2
) -> Dict[str, np.ndarray]:
    """GuidanceUNet / DenoisingUNet param tree -> reference-grammar state_dict.

    Inverse of ``convert_unet``: motion modules, MAN blocks and the output
    head are emitted when the tree has them."""
    tree = tree.get("params", tree)
    out: Dict[str, np.ndarray] = {}
    _emit(tree, _dense_rules("conv_in", ("conv_in",), fn=_oihw), "", (), out)
    for i in (1, 2):
        _emit(tree, _dense_rules(f"linear_{i}", (f"linear_{i}",)), "time_embedding",
              ("time_embedding",), out)

    def motion(name: str, prefix: str):
        if name in tree:
            _emit(tree, _motion_rules(tree, (name,)), prefix, (name,), out)

    for i in range(num_blocks):
        for j in range(layers_per_block):
            _emit(tree, _RESNET_RULES, f"down_blocks.{i}.resnets.{j}", (f"down_{i}_res_{j}",), out)
            _emit(tree, _SPATIAL_TRANSFORMER_RULES, f"down_blocks.{i}.attentions.{j}",
                  (f"down_{i}_attn_{j}",), out)
            motion(f"down_{i}_motion_{j}", f"down_blocks.{i}.motion_modules.{j}")
        _emit(tree, _dense_rules("conv", ("conv",), fn=_oihw),
              f"down_blocks.{i}.downsamplers.0", (f"down_{i}_down",), out)
        _emit(tree, _MAN_RULES, f"man_blocks.{i}", (f"man_{i}",), out)

    _emit(tree, _RESNET_RULES, "mid_block.resnets.0", ("mid_res_0",), out)
    _emit(tree, _SPATIAL_TRANSFORMER_RULES, "mid_block.attentions.0", ("mid_attn",), out)
    _emit(tree, _RESNET_RULES, "mid_block.resnets.1", ("mid_res_1",), out)
    motion("mid_motion", "mid_block.motion_modules.0")

    for i in range(num_blocks):
        for j in range(layers_per_block + 1):
            _emit(tree, _RESNET_RULES, f"up_blocks.{i}.resnets.{j}", (f"up_{i}_res_{j}",), out)
            _emit(tree, _SPATIAL_TRANSFORMER_RULES, f"up_blocks.{i}.attentions.{j}",
                  (f"up_{i}_attn_{j}",), out)
            motion(f"up_{i}_motion_{j}", f"up_blocks.{i}.motion_modules.{j}")
        _emit(tree, _dense_rules("conv", ("conv",), fn=_oihw),
              f"up_blocks.{i}.upsamplers.0", (f"up_{i}_up",), out)

    _emit(tree, _norm_rules("conv_norm_out", "conv_norm_out")
          + _dense_rules("conv_out", ("conv_out",), fn=_oihw), "", (), out)
    return out


def vae_encoder_state_dict_from_jax(
    tree: Mapping, num_blocks: int = 4, layers_per_block: int = 2
) -> Dict[str, np.ndarray]:
    """Encoder param tree -> ``encoder.*`` + ``quant_conv.*`` keys."""
    tree = tree.get("params", tree)
    out: Dict[str, np.ndarray] = {}
    conv = _dense_rules("conv", ("conv",), fn=_oihw)
    _emit(tree, _dense_rules("conv_in", ("conv_in",), fn=_oihw), "encoder", (), out)
    for i in range(num_blocks):
        for j in range(layers_per_block):
            _emit(tree, _RESNET_RULES, f"encoder.down_blocks.{i}.resnets.{j}",
                  (f"down_{i}_res_{j}",), out)
        _emit(tree, conv, f"encoder.down_blocks.{i}.downsamplers.0", (f"down_{i}_down",), out)
    _emit(tree, _RESNET_RULES, "encoder.mid_block.resnets.0", ("mid_res_0",), out)
    _emit(tree, _VAE_ATTENTION_RULES, "encoder.mid_block.attentions.0", ("mid_attn",), out)
    _emit(tree, _RESNET_RULES, "encoder.mid_block.resnets.1", ("mid_res_1",), out)
    _emit(tree, _norm_rules("conv_norm_out", "conv_norm_out")
          + _dense_rules("conv_out", ("conv_out",), fn=_oihw), "encoder", (), out)
    _emit(tree, _dense_rules("quant_conv", ("quant_conv",), fn=_oihw), "", (), out)
    return out


def vae_decoder_state_dict_from_jax(
    tree: Mapping, num_blocks: int = 4, layers_per_block: int = 2
) -> Dict[str, np.ndarray]:
    """Decoder param tree -> ``post_quant_conv.*`` + ``decoder.*`` keys."""
    tree = tree.get("params", tree)
    out: Dict[str, np.ndarray] = {}
    conv = _dense_rules("conv", ("conv",), fn=_oihw)
    _emit(tree, _dense_rules("post_quant_conv", ("post_quant_conv",), fn=_oihw), "", (), out)
    _emit(tree, _dense_rules("conv_in", ("conv_in",), fn=_oihw), "decoder", (), out)
    _emit(tree, _RESNET_RULES, "decoder.mid_block.resnets.0", ("mid_res_0",), out)
    _emit(tree, _VAE_ATTENTION_RULES, "decoder.mid_block.attentions.0", ("mid_attn",), out)
    _emit(tree, _RESNET_RULES, "decoder.mid_block.resnets.1", ("mid_res_1",), out)
    for i in range(num_blocks):
        for j in range(layers_per_block + 1):
            _emit(tree, _RESNET_RULES, f"decoder.up_blocks.{i}.resnets.{j}",
                  (f"up_{i}_res_{j}",), out)
        _emit(tree, conv, f"decoder.up_blocks.{i}.upsamplers.0", (f"up_{i}_up",), out)
    _emit(tree, _norm_rules("conv_norm_out", "conv_norm_out")
          + _dense_rules("conv_out", ("conv_out",), fn=_oihw), "decoder", (), out)
    return out


def _oi311(x) -> np.ndarray:
    """(3, 1, I, O) temporal kernel -> torch Conv3d (O, I, 3, 1, 1)."""
    return _np(np.asarray(x).transpose(3, 2, 0, 1))[..., None]


_ST_RESBLOCK_RULES = (
    tuple((f"spatial_res_block.{n}.{leaf}",
           (f"spatial_{n}", "scale" if n.startswith("norm") and leaf == "weight" else
            "kernel" if leaf == "weight" else "bias"),
           _np if leaf == "bias" or n.startswith("norm") else _oihw)
          for n in ("norm1", "conv1", "norm2", "conv2", "conv_shortcut")
          for leaf in ("weight", "bias"))
    + _prefixed(_norm_rules("norm1", "norm1") + _norm_rules("norm2", "norm2")
                + _dense_rules("conv1", ("conv1", "conv"), fn=_oi311)
                + _dense_rules("conv2", ("conv2", "conv"), fn=_oi311),
                "temporal_res_block", ("temporal_res_block",))
    + (("time_mixer.mix_factor", ("mix_factor",), _np),)
)


def temporal_decoder_state_dict_from_jax(
    tree: Mapping, num_blocks: int = 4, layers_per_block: int = 2
) -> Dict[str, np.ndarray]:
    """TemporalDecoder param tree -> ``decoder.*`` keys (inverse of
    ``convert_temporal_decoder``)."""
    tree = tree.get("params", tree)
    out: Dict[str, np.ndarray] = {}
    _emit(tree, _dense_rules("conv_in", ("conv_in",), fn=_oihw), "decoder", (), out)
    _emit(tree, _ST_RESBLOCK_RULES, "decoder.mid_block.resnets.0", ("mid_res_0",), out)
    _emit(tree, _VAE_ATTENTION_RULES, "decoder.mid_block.attentions.0", ("mid_attn",), out)
    _emit(tree, _ST_RESBLOCK_RULES, "decoder.mid_block.resnets.1", ("mid_res_1",), out)
    for i in range(num_blocks):
        for j in range(layers_per_block + 1):
            _emit(tree, _ST_RESBLOCK_RULES, f"decoder.up_blocks.{i}.resnets.{j}",
                  (f"up_{i}_res_{j}",), out)
        _emit(tree, _dense_rules("conv", ("conv",), fn=_oihw),
              f"decoder.up_blocks.{i}.upsamplers.0", (f"up_{i}_up",), out)
    _emit(tree, _norm_rules("conv_norm_out", "conv_norm_out")
          + _dense_rules("conv_out", ("conv_out",), fn=_oihw)
          + _dense_rules("time_conv_out", ("time_conv_out", "conv"), fn=_oi311),
          "decoder", (), out)
    return out


def clip_vision_state_dict_from_jax(tree: Mapping) -> Dict[str, np.ndarray]:
    """CLIPVisionTower param tree -> Hugging Face keys (inverse of
    ``convert_clip_vision``); layers are emitted while the tree has them."""
    tree = tree.get("params", tree)
    out: Dict[str, np.ndarray] = {}
    emb = "vision_model.embeddings"
    out[f"{emb}.class_embedding"] = _np(tree["class_embedding"])
    out[f"{emb}.patch_embedding.weight"] = _oihw(tree["patch_embedding"]["kernel"])
    out[f"{emb}.position_embedding.weight"] = _np(tree["position_embedding"])
    _emit(tree, _norm_rules("pre_layrnorm", "pre_layrnorm")
          + _norm_rules("post_layernorm", "post_layernorm"), "vision_model", (), out)
    layer_rules = (
        _norm_rules("layer_norm1", "layer_norm1") + _norm_rules("layer_norm2", "layer_norm2")
        + sum((_dense_rules(f"self_attn.{n}", (n,))
               for n in ("q_proj", "k_proj", "v_proj", "out_proj")), ())
        + _dense_rules("mlp.fc1", ("fc1",)) + _dense_rules("mlp.fc2", ("fc2",))
    )
    i = 0
    while f"layers_{i}" in tree:
        _emit(tree, layer_rules, f"vision_model.encoder.layers.{i}", (f"layers_{i}",), out)
        i += 1
    _emit(tree, _dense_rules("visual_projection", ("visual_projection",), bias=False), "", (), out)
    return out


# --------------------------------------------------------------------------
# inverses of the toolbox converters (Swin, UniPose, CLIP-text, DPT)
# --------------------------------------------------------------------------

def _ln_rules(key: str, dst: Tuple[str, ...]):
    return ((f"{key}.weight", dst + ("scale",), _np), (f"{key}.bias", dst + ("bias",), _np))


def _mha_state(tree: Mapping, dst: Tuple[str, ...], prefix: str, out: Dict) -> None:
    """q/k/v/out Dense -> torch ``nn.MultiheadAttention``'s packed ``in_proj``."""
    node = _get(tree, dst)
    out[f"{prefix}.in_proj_weight"] = _np(np.concatenate(
        [np.asarray(node[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj")], 0))
    out[f"{prefix}.in_proj_bias"] = _np(np.concatenate(
        [np.asarray(node[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")], 0))
    _emit(tree, _dense_rules("out_proj", ("out_proj",)), prefix, dst, out)


def _mlp_rules(key: str, dst: Tuple[str, ...], num_layers: int = 3):
    return sum((_dense_rules(f"{key}.layers.{k}", dst + (f"layers_{k}",))
                for k in range(num_layers)), ())


_DEFORM_RULES = sum((_dense_rules(n, (n,)) for n in
                     ("value_proj", "sampling_offsets", "attention_weights", "output_proj")), ())


def swin_state_dict_from_jax(tree: Mapping, prefix: str = "backbone.0") -> Dict[str, np.ndarray]:
    """SwinTransformer param tree -> reference keys (inverse of ``convert_swin``),
    with each block's ``attn.relative_position_index`` buffer (the window read
    off the bias table's size). Stages and blocks are emitted while the tree
    has them."""
    tree = tree.get("params", tree)
    out: Dict[str, np.ndarray] = {}
    _emit(tree, _dense_rules("patch_embed.proj", ("patch_embed",), fn=_oihw)
          + _ln_rules("patch_embed.norm", ("patch_norm",)), prefix, (), out)
    block_rules = (
        _ln_rules("norm1", ("norm1",)) + _ln_rules("norm2", ("norm2",))
        + (("attn.relative_position_bias_table", ("attn", "relative_position_bias_table"), _np),)
        + _dense_rules("attn.qkv", ("attn", "qkv")) + _dense_rules("attn.proj", ("attn", "proj"))
        + _dense_rules("mlp.fc1", ("fc1",)) + _dense_rules("mlp.fc2", ("fc2",)))
    i = 0
    while f"stage_{i}_block_0" in tree:
        j = 0
        while f"stage_{i}_block_{j}" in tree:
            bp = f"{prefix}.layers.{i}.blocks.{j}".lstrip(".")
            _emit(tree, block_rules, bp, (f"stage_{i}_block_{j}",), out)
            n = tree[f"stage_{i}_block_{j}"]["attn"]["relative_position_bias_table"].shape[0]
            window = (int(round(n ** 0.5)) + 1) // 2
            out[f"{bp}.attn.relative_position_index"] = relative_position_index(window)
            j += 1
        _emit(tree, _ln_rules("downsample.norm", ("norm",))
              + _dense_rules("downsample.reduction", ("reduction",), bias=False),
              f"{prefix}.layers.{i}".lstrip("."), (f"merge_{i}",), out)
        if f"out_norm_{i}" in tree:
            _emit(tree, _ln_rules(f"norm{i}", (f"out_norm_{i}",)), prefix, (), out)
        i += 1
    return out


def unipose_state_dict_from_jax(tree: Mapping) -> Dict[str, np.ndarray]:
    """UniPose param tree -> the reference checkpoint's live keys (inverse of
    ``convert_unipose``); layers are emitted while the tree has them."""
    tree = tree.get("params", tree)
    out = swin_state_dict_from_jax(tree["backbone"], "backbone.0")
    i = 0
    while f"input_proj_{i}" in tree:
        _emit(tree, _dense_rules(f"input_proj.{i}.0", (f"input_proj_{i}",), fn=_oihw)
              + _ln_rules(f"input_proj.{i}.1", (f"input_proj_norm_{i}",)), "", (), out)
        i += 1
    t = "transformer"
    out[f"{t}.level_embed"] = _np(tree["level_embed"])
    out[f"{t}.tgt_embed.weight"] = _np(tree["tgt_embed"])
    out[f"{t}.decoder.hw.weight"] = _np(tree["hw"])
    out[f"{t}.decoder.hw_append.weight"] = _np(tree["hw_append"])
    _emit(tree, _dense_rules("enc_output", ("enc_output",))
          + _ln_rules("enc_output_norm", ("enc_output_norm",))
          + _ln_rules("decoder.norm", ("decoder_norm",))
          + _mlp_rules("decoder.ref_point_head", ("ref_point_head",), 2), t, (), out)
    ffn = (_ln_rules("norm1", ("norm1",)) + _ln_rules("norm2", ("norm2",))
           + _dense_rules("linear1", ("linear1",)) + _dense_rules("linear2", ("linear2",)))
    i = 0
    while f"enc_{i}" in tree:
        ep = f"{t}.encoder.layers.{i}"
        _emit(tree, _prefixed(_DEFORM_RULES, "self_attn", ("self_attn",)) + ffn, ep,
              (f"enc_{i}",), out)
        tp = f"{t}.encoder.text_layers.{i}"
        _mha_state(tree, (f"text_{i}", "self_attn"), f"{tp}.self_attn", out)
        _emit(tree, ffn, tp, (f"text_{i}",), out)
        fp = f"{t}.encoder.fusion_layers.{i}"
        _emit(tree, _ln_rules("layer_norm_v", ("layer_norm_v",))
              + _ln_rules("layer_norm_l", ("layer_norm_l",))
              + sum((_dense_rules(f"attn.{n}", (n,)) for n in
                     ("v_proj", "l_proj", "values_v_proj", "values_l_proj", "out_v_proj",
                      "out_l_proj")), ())
              + (("gamma_v", ("gamma_v",), _np), ("gamma_l", ("gamma_l",), _np)),
              fp, (f"fusion_{i}",), out)
        i += 1
    i = 0
    while f"dec_{i}" in tree:
        dp = f"{t}.decoder.layers.{i}"
        _emit(tree, _prefixed(_DEFORM_RULES, "cross_attn", ("cross_attn",)) + ffn
              + _ln_rules("norm3", ("norm3",)) + _ln_rules("catext_norm", ("catext_norm",)),
              dp, (f"dec_{i}",), out)
        _mha_state(tree, (f"dec_{i}", "self_attn"), f"{dp}.self_attn", out)
        _mha_state(tree, (f"dec_{i}", "ca_text"), f"{dp}.ca_text", out)
        i += 1
    _emit(tree, _mlp_rules("bbox_embed.0", ("bbox_embed",))
          + _mlp_rules("pose_embed.0", ("pose_embed",))
          + _mlp_rules("pose_hw_embed.0", ("pose_hw_embed",))
          + _mlp_rules("projection", ("projection",))
          + _mlp_rules("projection_kpt", ("projection_kpt",)), "", (), out)
    return out


def clip_text_state_dict_from_jax(tree: Mapping) -> Dict[str, np.ndarray]:
    """CLIPTextEncoder param tree -> Hugging Face keys (inverse of
    ``convert_clip_text_hf``: the packed ``attn_in`` splits into q/k/v);
    layers are emitted while the tree has them."""
    tree = tree.get("params", tree)
    pre = "text_model"
    out: Dict[str, np.ndarray] = {
        f"{pre}.embeddings.token_embedding.weight": _np(tree["token_embedding"]),
        f"{pre}.embeddings.position_embedding.weight": _np(tree["positional_embedding"]),
    }
    i = 0
    while f"layers_{i}_ln_1" in tree:
        p, d = f"{pre}.encoder.layers.{i}", f"layers_{i}"
        _emit(tree, _ln_rules("layer_norm1", (f"{d}_ln_1",))
              + _ln_rules("layer_norm2", (f"{d}_ln_2",))
              + _dense_rules("self_attn.out_proj", (f"{d}_attn_out",))
              + _dense_rules("mlp.fc1", (f"{d}_fc",)) + _dense_rules("mlp.fc2", (f"{d}_proj",)),
              p, (), out)
        packed = tree[f"{d}_attn_in"]
        kernel, bias = np.asarray(packed["kernel"]), np.asarray(packed["bias"])
        C = kernel.shape[0]
        for j, n in enumerate(("q_proj", "k_proj", "v_proj")):
            out[f"{p}.self_attn.{n}.weight"] = _oi(kernel[:, j * C:(j + 1) * C])
            out[f"{p}.self_attn.{n}.bias"] = _np(bias[j * C:(j + 1) * C])
        i += 1
    _emit(tree, _ln_rules("final_layer_norm", ("ln_final",)), pre, (), out)
    out["text_projection.weight"] = _oi(tree["text_projection"])
    return out


def dpt_state_dict_from_jax(tree: Mapping) -> Dict[str, np.ndarray]:
    """DPTHybridDepth param tree -> ``DPTForDepthEstimation`` keys (inverse of
    ``convert_dpt``); stages, layers and ViT layers are emitted while the tree
    has them."""
    tree = tree.get("params", tree)
    out: Dict[str, np.ndarray] = {}
    bit = "dpt.embeddings.backbone.bit"
    _emit(tree, (("embedder.convolution.weight", ("stem_conv", "kernel"), _oihw),)
          + _ln_rules("embedder.norm", ("stem_norm",)), bit, ("bit",), out)
    bottleneck = (
        (("downsample.conv.weight", ("down_conv", "kernel"), _oihw),)
        + _ln_rules("downsample.norm", ("down_norm",))
        + sum(((((f"conv{n}.weight", (f"conv{n}", "kernel"), _oihw),)
                + _ln_rules(f"norm{n}", (f"norm{n}",))) for n in (1, 2, 3)), ()))
    s = 0
    while f"stage{s}_layer0" in tree["bit"]:
        l = 0
        while f"stage{s}_layer{l}" in tree["bit"]:
            _emit(tree, bottleneck, f"{bit}.encoder.stages.{s}.layers.{l}",
                  ("bit", f"stage{s}_layer{l}"), out)
            l += 1
        s += 1
    _emit(tree, _dense_rules("dpt.embeddings.projection", ("projection",), fn=_oihw), "", (), out)
    out["dpt.embeddings.cls_token"] = _np(tree["cls_token"])
    out["dpt.embeddings.position_embeddings"] = _np(tree["pos_embed"])
    vit = (_ln_rules("layernorm_before", ("ln1",)) + _ln_rules("layernorm_after", ("ln2",))
           + _dense_rules("attention.attention.query", ("q",))
           + _dense_rules("attention.attention.key", ("k",))
           + _dense_rules("attention.attention.value", ("v",))
           + _dense_rules("attention.output.dense", ("out",))
           + _dense_rules("intermediate.dense", ("fc1",)) + _dense_rules("output.dense", ("fc2",)))
    i = 0
    while f"layer{i}" in tree:
        _emit(tree, vit, f"dpt.encoder.layer.{i}", (f"layer{i}",), out)
        i += 1
    rs = "neck.reassemble_stage"
    for i in (2, 3):
        _emit(tree, _dense_rules(f"{rs}.readout_projects.{i}.0", (f"readout{i}",))
              + _dense_rules(f"{rs}.layers.{i}.projection", (f"reassemble{i}_proj",), fn=_oi11),
              "", (), out)
    _emit(tree, _dense_rules(f"{rs}.layers.3.resize", ("reassemble3_resize",), fn=_oihw), "", (),
          out)
    for i in range(4):
        p = f"neck.fusion_stage.layers.{i}"
        _emit(tree, _dense_rules(f"neck.convs.{i}", (f"neck_conv{i}",), bias=False, fn=_oihw)
              + _dense_rules(f"{p}.projection", (f"fusion{i}_proj",), fn=_oihw)
              + sum((_dense_rules(f"{p}.residual_layer{r}.convolution{c}",
                                  (f"fusion{i}_res{r}", f"conv{c}"), fn=_oihw)
                     for r in (1, 2) for c in (1, 2)), ()), "", (), out)
    for i in (0, 2, 4):
        _emit(tree, _dense_rules(f"head.head.{i}", (f"head{i}",), fn=_oihw), "", (), out)
    return out


# --------------------------------------------------------------------------
# training: both UNets at once, and the trainable mask in either naming
# --------------------------------------------------------------------------

def train_params_to_jax(guide_sd: Mapping, den_sd: Mapping, num_blocks: int = 4,
                        layers_per_block: int = 2) -> Dict[str, Dict]:
    """The two port modules' ``state_dict``s -> the JAX ``TrainState.params``
    layout ``{"guide": tree, "den": tree}`` (numpy fp32 leaves)."""
    return {
        "guide": convert_unet(guide_sd, num_blocks, layers_per_block, with_man=True,
                              with_conv_out=False),
        "den": convert_unet(den_sd, num_blocks, layers_per_block, with_motion=True),
    }


def train_params_from_jax(params: Mapping, num_blocks: int = 4,
                          layers_per_block: int = 2) -> Dict[str, Dict[str, np.ndarray]]:
    """``{"guide": tree, "den": tree}`` -> ``{"guide": state_dict, "den":
    state_dict}``; also maps a tree of gradients onto the port's names (the
    transforms are permutations)."""
    return {net: unet_state_dict_from_jax(params[net], num_blocks, layers_per_block)
            for net in ("guide", "den")}


def unet_key_paths(state_dict: Mapping, num_blocks: int = 4,
                   layers_per_block: int = 2) -> Dict[str, Tuple[str, ...]]:
    """{state_dict key: path of its leaf in the JAX tree}, found by sending
    every tensor through ``convert_unet`` filled with its own index."""
    keys = list(state_dict)
    marked = {k: np.full(tuple(state_dict[k].shape), i, np.float32) for i, k in enumerate(keys)}
    tree = convert_unet(marked, num_blocks, layers_per_block, with_motion=True, with_man=True)
    out: Dict[str, Tuple[str, ...]] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out[keys[int(np.asarray(node).flat[0])]] = path

    walk(tree, ())
    return out


def trainable_mask_to_jax(mask: Mapping[str, bool], guide_sd: Mapping, den_sd: Mapping,
                          num_blocks: int = 4, layers_per_block: int = 2) -> Dict[str, Dict]:
    """The port's ``{"guide.<key>" / "den.<key>": bool}`` -> the JAX mask tree
    ``{"guide": ..., "den": ...}`` over the same tensors."""
    out: Dict[str, Dict] = {}
    for net, sd in (("guide", guide_sd), ("den", den_sd)):
        tree: Dict[str, Any] = {}
        for key, path in unet_key_paths(sd, num_blocks, layers_per_block).items():
            _set(tree, path, bool(mask[f"{net}.{key}"]))
        out[net] = tree
    return out


def trainable_mask_from_jax(mask: Mapping, guide_sd: Mapping, den_sd: Mapping,
                            num_blocks: int = 4, layers_per_block: int = 2) -> Dict[str, bool]:
    """The JAX mask tree -> the port's flat ``{name: bool}``."""
    out: Dict[str, bool] = {}
    for net, sd in (("guide", guide_sd), ("den", den_sd)):
        for key, path in unet_key_paths(sd, num_blocks, layers_per_block).items():
            out[f"{net}.{key}"] = bool(_get(mask[net], path))
    return out
