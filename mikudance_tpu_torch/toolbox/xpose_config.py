"""Reference-style XPose model-config loader.

The port's own copy of ``mikudance_tpu/toolbox/xpose_config.py``. The
reference builds UniPose variants from python config files with
mmengine-style ``_base_`` inheritance (``XPose/util/config.py:16,113-170``)
and loads them via ``Config.fromfile`` at
``inference_xpose_on_image.py:404``; the shipped geometry lives in
``config_model/UniPose_SwinT.py`` (which itself inherits
``coco_transformer.py``).

This module rebuilds that surface without mmengine: ``load_model_config``
execs a config file plus its ``_base_`` chain into one plain dict, and
``unipose_kwargs`` maps the reference's key grammar onto
:class:`mikudance_tpu_torch.toolbox.unipose.UniPose` constructor kwargs.
Config variants the rebuild deliberately does not implement (key-aware
deformable attention, non-``'standard'`` two-stage, non-``'sa'`` decoder
self-attention, resnet backbones — all unused by every released UniPose
checkpoint) are rejected EXPLICITLY with the offending key named.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

BASE_KEY = "_base_"
DELETE_KEY = "_delete_"

# Swin geometry per backbone tag (`swin_transformer.py:653-683`). The
# window size is fixed at 7 for the 224-pretrained variants and 12 for
# the 384 ones.
SWIN_VARIANTS: Dict[str, Dict[str, Any]] = {
    "swin_T_224_1k": dict(embed_dim=96, depths=(2, 2, 6, 2),
                          heads=(3, 6, 12, 24), window=7),
    "swin_B_224_22k": dict(embed_dim=128, depths=(2, 2, 18, 2),
                           heads=(4, 8, 16, 32), window=7),
    "swin_B_384_22k": dict(embed_dim=128, depths=(2, 2, 18, 2),
                           heads=(4, 8, 16, 32), window=12),
    "swin_L_224_22k": dict(embed_dim=192, depths=(2, 2, 18, 2),
                           heads=(6, 12, 24, 48), window=7),
    "swin_L_384_22k": dict(embed_dim=192, depths=(2, 2, 18, 2),
                           heads=(6, 12, 24, 48), window=12),
}


def _exec_config_file(path: str) -> Dict[str, Any]:
    """Execute one python config file and return its public bindings."""
    with open(path) as f:
        src = f.read()
    ns: Dict[str, Any] = {}
    exec(compile(src, path, "exec"), ns)  # noqa: S102 - config files are code
    return {
        k: v for k, v in ns.items()
        if not k.startswith("__") and not callable(v) and not isinstance(v, type(os))
    }


def _merge(child: Dict[str, Any], base: Dict[str, Any]) -> Dict[str, Any]:
    """child wins; nested dicts merge recursively unless ``_delete_`` is set
    (``util/config.py:155-175`` semantics)."""
    out = dict(base)
    for k, v in child.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            v = dict(v)
            if v.pop(DELETE_KEY, False):
                out[k] = v
            else:
                out[k] = _merge(v, out[k])
        else:
            out[k] = v
    return out


def load_model_config(path: str) -> Dict[str, Any]:
    """Load a reference-style model config, resolving its ``_base_`` chain.

    ``_base_`` may be a string or a list of strings, resolved relative to
    the config file's own directory; later bases override earlier ones and
    the child overrides all bases (``util/config.py:113-135``).
    """
    cfg = _exec_config_file(path)
    bases = cfg.pop(BASE_KEY, [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for b in bases:
        merged = _merge(load_model_config(os.path.join(os.path.dirname(path), b)),
                        merged)
    return _merge(cfg, merged)


# (key, required value or tuple of allowed values, why) — graph-topology
# switches the rebuild pins to the released checkpoints' values.
_PINNED: List[tuple] = [
    ("modelname", ("UniPose",), "only UniPose is rebuilt"),
    ("two_stage_type", ("standard",),
     "non-standard two-stage changes the query-selection graph"),
    ("decoder_sa_type", ("sa",),
     "ca_label/ca_content decoder self-attention is not rebuilt"),
    ("use_deformable_box_attn", (False, None),
     "roi-align box attention is not rebuilt"),
    ("binary_query_selection", (False, None),
     "binary query selection is not rebuilt"),
    ("use_text_enhancer", (True, None), "the text enhancer is always on"),
    ("use_fusion_layer", (True, None), "the fusion layers are always on"),
    ("num_patterns", (0, None), "pattern embeddings are not rebuilt"),
    ("unic_layers", (0, None), "unicoder layers are not rebuilt"),
    ("return_interm_indices", ([1, 2, 3], (1, 2, 3), None),
     "the input-proj stack assumes swin stages 1-3 + one extra level"),
]


def unipose_kwargs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Map a loaded config dict onto ``UniPose(...)`` kwargs.

    Key grammar follows ``build_unipose`` + ``build_deformable_transformer``
    consumption (``unipose.py:505-600``): ``nheads`` -> heads,
    ``num_feature_levels`` -> levels, ``enc_n_points``/``dec_n_points`` ->
    points (must agree — the rebuild shares one sampling-point count),
    ``dim_feedforward`` -> ffn_dim, ``num_select`` -> num_groups,
    ``backbone`` -> the Swin geometry table above.
    """
    def _matches(v, allowed):
        for a in allowed:
            if isinstance(a, (list, tuple)) and isinstance(v, (list, tuple)):
                if list(v) == list(a):
                    return True
            elif v == a:
                return True
            elif v is None and a is None:
                return True
        return False

    for key, allowed, why in _PINNED:
        v = cfg.get(key, None)
        if not _matches(v, allowed):
            raise ValueError(
                f"unsupported XPose config: {key}={v!r} ({why}); "
                f"the rebuild supports {key} in {allowed}"
            )

    backbone = cfg.get("backbone", "swin_T_224_1k")
    if backbone not in SWIN_VARIANTS:
        raise ValueError(
            f"unsupported XPose backbone {backbone!r}: the rebuild ships "
            f"the Swin family only ({sorted(SWIN_VARIANTS)}); the reference's "
            "resnet50/101 path is unused by every released UniPose checkpoint"
        )
    swin = SWIN_VARIANTS[backbone]

    enc_p = cfg.get("enc_n_points", 4)
    dec_p = cfg.get("dec_n_points", 4)
    if enc_p != dec_p:
        raise ValueError(
            f"unsupported XPose config: enc_n_points={enc_p} != dec_n_points="
            f"{dec_p}; the rebuild shares one sampling-point count"
        )

    kwargs: Dict[str, Any] = dict(
        hidden_dim=cfg.get("hidden_dim", 256),
        enc_layers=cfg.get("enc_layers", 6),
        dec_layers=cfg.get("dec_layers", 6),
        heads=cfg.get("nheads", 8),
        levels=cfg.get("num_feature_levels", 4),
        points=enc_p,
        ffn_dim=cfg.get("dim_feedforward", 2048),
        num_queries=cfg.get("num_queries", 900),
        num_groups=cfg.get("num_select", 50),
        num_body_points=cfg.get("num_body_points", 68),
        swin_embed_dim=swin["embed_dim"],
        swin_depths=tuple(swin["depths"]),
        swin_heads=tuple(swin["heads"]),
    )
    if "num_box_decoder_layers" in cfg:  # not in shipped configs; honor if set
        kwargs["num_box_decoder_layers"] = cfg["num_box_decoder_layers"]
    return kwargs


def build_unipose_from_config(path: str, dtype=None):
    """``Config.fromfile`` + ``build_unipose`` in one call
    (``inference_xpose_on_image.py:404,636``), returning the port's module
    (cast to ``dtype`` when one is given)."""
    from .unipose import UniPose

    model = UniPose(**unipose_kwargs(load_model_config(path)))
    return model if dtype is None else model.to(dtype=dtype)
