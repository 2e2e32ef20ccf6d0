"""The port's video sampler end to end against the JAX package's, on the CPU.

A tiny bundle gets seeded weights in the port (every zero-initialised tensor
refilled, so the motion modules' temporal attention reaches the video); the
JAX bundle gets the same weights through the JAX package's converters. Both
pipelines sample the same numpy inputs: final latents agree within 1e-3 and
decoded uint8 frames within one level.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mikudance_tpu.core import convert as jconvert
from mikudance_tpu.core.configs import (ContextConfig, DenoisingUNetConfig, GuidanceUNetConfig,
                                        MotionModuleConfig, PipelineConfig, UNetConfig,
                                        VAEConfig)
from mikudance_tpu.models import unet as junet
from mikudance_tpu.models import vae as jvae
from mikudance_tpu.pipelines import video as jvideo
from mikudance_tpu_torch.models import unet, vae
from mikudance_tpu_torch.pipelines import video

TINY = UNetConfig(block_out_channels=(32, 64, 96, 96), attention_heads=4)
TINY_VAE = VAEConfig(block_out_channels=(16, 32, 32, 32), norm_num_groups=8)
T, H, W = 5, 64, 64
h, w = H // 8, W // 8
# 3-frame windows with overlap 1 over 5 frames: three windows, wrap-around,
# frames covered twice — the fusion's counter division is exercised.
CONFIG = PipelineConfig(width=W, height=H, num_inference_steps=3, guidance_scale=3.5,
                        context=ContextConfig(frames=3, overlap=1))


def seeded(module, seed):
    """PyTorch's init under a seed, zero tensors refilled from numpy, and every
    weight matrix or kernel halved: a random network at full init scale
    amplifies fp32 rounding (a 1e-6 change of the noise moves its latents by
    5e-5 over three CFG steps), halved it stays far below the tolerance."""
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.copy_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
            if p.ndim > 1:
                p.mul_(0.5)
    return module.eval()


@pytest.fixture(scope="module")
def pipes():
    guide = seeded(unet.GuidanceUNet(GuidanceUNetConfig(unet=TINY, use_man=True)), 0)
    den_cfg = DenoisingUNetConfig(unet=TINY, motion=MotionModuleConfig(num_attention_heads=4))
    den = seeded(unet.DenoisingUNet(den_cfg), 1)
    enc, dec = seeded(vae.Encoder(TINY_VAE), 2), seeded(vae.Decoder(TINY_VAE), 3)
    port = video.VideoPipeline(video.ModelBundle(guide, den, enc, dec), CONFIG)

    jbundle = jvideo.ModelBundle(
        junet.GuidanceUNet(GuidanceUNetConfig(unet=TINY, use_man=True)),
        {"params": jconvert.convert_unet(guide.state_dict(), with_man=True,
                                         with_conv_out=False)},
        junet.DenoisingUNet(den_cfg),
        {"params": jconvert.convert_unet(den.state_dict(), with_motion=True)},
        jvae.Encoder(TINY_VAE), {"params": jconvert.convert_vae_encoder(enc.state_dict())},
        jvae.Decoder(TINY_VAE), {"params": jconvert.convert_vae_decoder(dec.state_dict())},
    )
    return port, jvideo.VideoPipeline(jbundle, CONFIG)


def inputs(seed):
    """uint8 media as the serving path gets it, with all-black face and hand
    streams (the absent-stream collapse), plus scene motion, CLIP tokens and
    the initial noise."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
            rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
            rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8),
            np.zeros((T, H, W, 3), np.uint8),
            np.zeros((T, H, W, 3), np.uint8),
            rng.normal(0, 0.1, (T, h, w, 2)).astype(np.float32),
            rng.normal(0, 1, (1, 5, 768)).astype(np.float32),
            rng.normal(0, 1, (T, h, w, 4)).astype(np.float32))


def test_latents_and_video_match_jax(pipes):
    port, jpipe = pipes
    args = inputs(0)
    want = np.asarray(jpipe(*args, decode=False))
    got = port(*args, decode=False)
    assert got.dtype == torch.float32 and got.shape == (T, h, w, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)

    want_v = np.asarray(jpipe(*args, to_host=True))
    got_v = port(*args, to_host=True)
    assert isinstance(got_v, np.ndarray) and got_v.dtype == np.uint8
    assert got_v.shape == want_v.shape == (T, H, W, 3)
    assert np.abs(got_v.astype(np.int16) - want_v.astype(np.int16)).max() <= 1
    # round(), not floor(): all but rounding-boundary pixels are identical
    assert np.mean(got_v == want_v) > 0.999
    # the device-resident decode is the same frames as the host decode
    np.testing.assert_array_equal(port(*args).numpy(), got_v)


def test_float_inputs_and_present_streams(pipes):
    """The float input path with real face/hand streams (no collapse),
    against JAX."""
    port, jpipe = pipes
    rng = np.random.default_rng(1)
    ref = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
    skel, pose, face, hand = (rng.uniform(0, 1, s).astype(np.float32)
                              for s in ((H, W, 3), (T, H, W, 3), (T, H, W, 3), (T, H, W, 3)))
    rest = inputs(1)[5:]
    want = np.asarray(jpipe(ref, skel, pose, face, hand, *rest, decode=False))
    got = port(ref, skel, pose, face, hand, *rest, decode=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_guidance_context_tiling_matches_jax():
    windows = np.array([[0, 1, 2, 3], [2, 3, 4, 0]])
    c = np.random.default_rng(2).normal(size=(1, 2, 3)).astype(np.float32)
    for mode in ("reference_inference", "cond"):
        want = jvideo.guidance_context_for_windows(windows, jnp.asarray(c), jnp.zeros_like(c), mode)
        got = video.guidance_context_for_windows(windows, torch.from_numpy(c),
                                                 torch.zeros(1, 2, 3), mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("change,item", [
    (dict(bank_mode="per_step"), "item 8"),
    (dict(bank_mode="cached_q8"), "item 8"),
    (dict(cached_bank_positions=4), "item 8"),
    (dict(max_denoise_frame_batch=4), "item 8"),
    (dict(interpolation_factor=2), "item 9"),
])
def test_paths_not_ported_raise(pipes, change, item):
    port = pipes[0]
    cfg = PipelineConfig(width=W, height=H, context=ContextConfig(frames=3, overlap=1), **change)
    with pytest.raises(NotImplementedError, match=item):
        video.VideoPipeline(port.bundle, cfg)(*inputs(0))


def test_import_leaves_jax_flax_triton_out():
    """The port and every submodule import without JAX, Flax, Triton or the
    JAX package (the machine with the card has none of them)."""
    code = (
        "import importlib, pkgutil, sys, mikudance_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'triton', 'mikudance_tpu')]\n"
        "print(len(list(pkgutil.walk_packages(p.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
