"""Seeded random networks and inputs at the serving geometry, for the
profile script and ``chip_smoke.py`` (no checkpoints are needed).

- ``seeded_modules(seed, device, make)``: modules under PyTorch's init and a
  seed, every all-zero tensor refilled, cast to bf16;
- ``build_bundle(seed, device)``: the SD1.5-width video bundle (guidance UNet
  with MAN, denoising UNet with motion modules, SD VAE);
- ``make_inputs(seed, frames, height, width)``: a request's uint8 media,
  zero scene motion, CLIP tokens and noise.
"""

from __future__ import annotations

import numpy as np
import torch


def seeded_modules(seed: int, device, make):
    """``make()`` builds modules under PyTorch's default init and a seed; every
    tensor that starts at zero (biases, norm shifts, the motion modules'
    proj_out) is refilled with seeded N(0, 1e-2) so that every branch, K3's
    included, reaches the output. Then cast to bf16."""
    from ..core.params import cast_params

    torch.manual_seed(seed)
    with torch.device(device):
        mods = make()
    g = torch.Generator(device=device).manual_seed(seed + 1)
    with torch.no_grad():
        for m in mods:
            for p in m.parameters():
                if not p.any():
                    p.normal_(0.0, 1e-2, generator=g)
            cast_params(m.eval(), torch.bfloat16)
    return mods


def build_bundle(seed: int, device):
    """SD1.5-width guidance UNet (MAN), denoising UNet (motion modules) and SD
    VAE, random seeded weights in bf16."""
    from ..core.configs import DenoisingUNetConfig, GuidanceUNetConfig
    from ..models.unet import DenoisingUNet, GuidanceUNet
    from ..models.vae import Decoder, Encoder
    from ..pipelines.video import ModelBundle

    return ModelBundle(*seeded_modules(seed, device, lambda: [
        GuidanceUNet(GuidanceUNetConfig()), DenoisingUNet(DenoisingUNetConfig()),
        Encoder(), Decoder()]))


def make_inputs(seed: int, frames: int, height: int, width: int):
    """uint8 media as a serving request brings it; absent face/hand streams
    arrive as black frames; scene motion zero; CLIP tokens and noise N(0, 1)."""
    rng = np.random.default_rng(seed)
    h, w = height // 8, width // 8
    return (rng.integers(0, 256, (height, width, 3), dtype=np.uint8),
            rng.integers(0, 256, (height, width, 3), dtype=np.uint8),
            rng.integers(0, 256, (frames, height, width, 3), dtype=np.uint8),
            np.zeros((frames, height, width, 3), np.uint8),
            np.zeros((frames, height, width, 3), np.uint8),
            np.zeros((frames, h, w, 2), np.float32),
            rng.normal(0, 1, (1, 257, 768)).astype(np.float32),
            rng.normal(0, 1, (frames, h, w, 4)).astype(np.float32))
