"""Reference ``state_dict`` <-> JAX parameter tree, both directions.

The forward converters (``convert_unet``, ``convert_vae_encoder``,
``convert_vae_decoder``, ``convert_clip_vision``, ``convert_temporal_decoder``
and their sub-tree helpers) are copied from the JAX package
(``mikudance_tpu/core/convert.py:29-390``); they are numpy only. The
port names its parameters in the reference checkpoint's key grammar
(diffusers UNet / VAE names), so a port ``state_dict`` goes through them to
the JAX tree, and a released ``.pth`` loads into the port with no converter.

The inverses (``unet_state_dict_from_jax``, ``vae_encoder_state_dict_from_jax``,
``vae_decoder_state_dict_from_jax``, ``temporal_decoder_state_dict_from_jax``
and ``clip_vision_state_dict_from_jax``) turn a JAX tree of numpy arrays back
into a ``state_dict`` that loads into the port's modules with ``strict=True``.

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
