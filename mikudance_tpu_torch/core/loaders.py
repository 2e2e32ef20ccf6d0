"""Checkpoint loading: reference .pth / .bin / .safetensors files into the
port's modules.

The load sequence of the reference CLI (`scripts/inference_video.py:61-119`):

- guidance ("reference") UNet: the released ``reference_unet-*.pth`` is
  complete and loads strictly;
- denoising UNet: SD weights (2-D, key-identical), then the AnimateDiff-style
  ``motion_module-*.pth`` merged over them, then ``denoising_unet-*.pth`` over
  both (`unet_3d_mix.py:600-691`);
- VAE, temporal decoder, CLIP tower: diffusers / Hugging Face files.

The port's parameters carry the reference's names, so a file loads with
``load_state_dict(strict=True)`` once it is cut to the keys the module has:
the cut ``core.convert.convert_unet`` makes by reading only what its flags
(``with_man``, ``with_conv_out``, ``with_motion``) ask for. A key the module
needs and the file lacks raises.

SDXL-width UNets (``configs.SDXL_UNET``) read SDXL's grammar by the same
rule: their modules carry its names and shapes (``transformer_blocks.0..9``
under each attention, ``add_embedding.linear_1/2``, 2-D ``proj_in`` /
``proj_out``).

Where a path is absent the module keeps its random initialisation (PyTorch's
default, drawn under a seed of its own), so the whole pipeline can be driven
without weights. In place of a path, a ``{key: tensor}`` mapping already in
memory (a state dict with the reference's names, e.g. the SD-width gate's
twins, ``scripts/_oracle.py``) loads by the same strict rule. Modules are
built on ``device`` (``None``: the card; raises where there is none) and
cast to ``dtype``.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from ..models.clip_vision import CLIPVisionTower
from ..models.unet import DenoisingUNet, GuidanceUNet
from ..models.vae import Decoder, Encoder
from ..models.vae_temporal import TemporalDecoder
from .configs import (CLIPVisionConfig, DenoisingUNetConfig, GuidanceUNetConfig,
                      MotionModuleConfig, UNetConfig, VAEConfig)
from .convert import merge_state_dicts
from .params import cast_params, resolve_device


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A .pth / .bin / .safetensors file as {key: CPU tensor}; pickled files
    are read with ``weights_only=True`` and a ``"state_dict"`` wrapper is
    opened."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return dict(load_file(path, device="cpu"))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


# A checkpoint: a file path, or a state dict already in memory.
Source = Union[str, Mapping[str, torch.Tensor], None]


def state_dict_of(src: Source) -> Optional[Mapping[str, torch.Tensor]]:
    """A mapping as it is, a file that exists loaded, else None."""
    if isinstance(src, Mapping):
        return src
    return load_torch_state_dict(src) if src and os.path.exists(src) else None


def _find_weights(dirpath: str, names=("diffusion_pytorch_model", "model", "pytorch_model")):
    for n in names:
        for ext in (".safetensors", ".bin"):
            p = os.path.join(dirpath, n + ext)
            if os.path.exists(p):
                return p
    return None


def _dir_weights(dirpath: Optional[str]) -> Optional[str]:
    return _find_weights(dirpath) if dirpath and os.path.isdir(dirpath) else None


def _build(make, seed: int, generator: Optional[torch.Generator], device) -> nn.Module:
    """``make()`` on ``device`` under PyTorch's default init, drawn from the
    generator's seed (or ``seed``); the global generators are left as they were."""
    dev = resolve_device(device)
    cuda = [dev] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda), torch.device(dev):
        torch.manual_seed(seed if generator is None else generator.initial_seed())
        return make().eval()


def _finish(module: nn.Module, sd: Optional[Mapping[str, torch.Tensor]], dtype) -> nn.Module:
    """Strict load of the module's own keys out of ``sd`` (if any), then the cast."""
    if sd is not None:
        module.load_state_dict({k: sd[k] for k in module.state_dict() if k in sd}, strict=True)
    return cast_params(module, dtype)


def load_guidance(reference_unet_path: Source, use_man: bool = True,
                  dtype=torch.float32, device=None,
                  generator: Optional[torch.Generator] = None,
                  unet_config: Optional[UNetConfig] = None,
                  remat: bool = False) -> GuidanceUNet:
    """GuidanceUNet from the released reference_unet file, or random init.
    ``remat``: per-block rematerialisation for training (the reference's
    ``enable_gradient_checkpointing``)."""
    cfg = GuidanceUNetConfig(use_man=use_man, unet=unet_config or UNetConfig())
    model = _build(lambda: GuidanceUNet(cfg, remat=remat), 0, generator, device)
    return _finish(model, state_dict_of(reference_unet_path), dtype)


def load_denoising(denoising_unet_path: Source, motion_module_path: Source = None,
                   sd_unet_path: Source = None, use_motion: bool = True,
                   dtype=torch.float32, device=None,
                   generator: Optional[torch.Generator] = None,
                   unet_config: Optional[UNetConfig] = None,
                   motion_config: Optional[MotionModuleConfig] = None,
                   remat: bool = False) -> DenoisingUNet:
    """DenoisingUNet from SD UNet -> motion module -> denoising UNet files
    merged in that order (later files override), or random init where the
    denoising file is absent. ``motion_config``: the reference's
    ``unet_additional_kwargs.motion_module_kwargs``; the defaults are the
    released checkpoints'. ``remat``: per-block rematerialisation for training."""
    u = unet_config or UNetConfig()
    cfg = DenoisingUNetConfig(unet=u, motion=motion_config or MotionModuleConfig(
        enabled=use_motion, num_attention_heads=u.attention_heads))
    model = _build(lambda: DenoisingUNet(cfg, remat=remat), 1, generator, device)
    sd = None
    den_sd = state_dict_of(denoising_unet_path)
    if den_sd is not None:
        sd = dict(state_dict_of(sd_unet_path) or {})
        motion_sd = state_dict_of(motion_module_path)
        if motion_sd is not None:
            sd = merge_state_dicts(sd, motion_sd)
        sd = merge_state_dicts(sd, den_sd)
    return _finish(model, sd, dtype)


def load_vae(vae_dir: Union[str, Mapping[str, torch.Tensor], None], dtype=torch.float32,
             device=None, generator: Optional[torch.Generator] = None,
             config: Optional[VAEConfig] = None) -> Tuple[Encoder, Decoder]:
    """The SD VAE's encoder and decoder from a diffusers directory (or a state
    dict of the whole autoencoder), or random init."""
    cfg = config or VAEConfig()
    enc, dec = _build(lambda: nn.ModuleList([Encoder(cfg), Decoder(cfg)]), 2, generator, device)
    if isinstance(vae_dir, Mapping):
        sd = vae_dir
    else:
        wfile = _dir_weights(vae_dir)
        sd = load_torch_state_dict(wfile) if wfile else None
    return _finish(enc, sd, dtype), _finish(dec, sd, dtype)


def load_clip(image_encoder_dir: Optional[str], dtype=torch.float32, device=None,
              generator: Optional[torch.Generator] = None,
              config: Optional[CLIPVisionConfig] = None) -> CLIPVisionTower:
    tower = _build(lambda: CLIPVisionTower(config or CLIPVisionConfig()), 3, generator, device)
    wfile = _dir_weights(image_encoder_dir)
    return _finish(tower, load_torch_state_dict(wfile) if wfile else None, dtype)


def load_temporal_decoder(vae_dir: Optional[str], dtype=torch.float32, device=None,
                          generator: Optional[torch.Generator] = None,
                          config: Optional[VAEConfig] = None) -> TemporalDecoder:
    """The temporal VAE decoder (the CLI's ``--video_decoder``)."""
    dec = _build(lambda: TemporalDecoder(config or VAEConfig()), 4, generator, device)
    wfile = _dir_weights(vae_dir)
    return _finish(dec, load_torch_state_dict(wfile) if wfile else None, dtype)
