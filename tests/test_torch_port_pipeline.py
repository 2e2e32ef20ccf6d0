"""The port's pipelines end to end against the JAX package's, on the CPU.

A tiny bundle gets seeded weights in the port (every zero-initialised tensor
refilled, so the motion modules' temporal attention reaches the video); the
JAX bundle gets the same weights through the JAX package's converters. Both
video pipelines (SD decoder; temporal decoder with latent interpolation) and
both image pipelines sample the same numpy inputs: final latents agree within
1e-3 and decoded uint8 frames within one level. Scene motion and latent
interpolation are held to the JAX functions at 1e-5. A pipeline runs on the
CPU only when asked by name.
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
from mikudance_tpu.models import vae_temporal as jvae_temporal
from mikudance_tpu.pipelines import image as jimage
from mikudance_tpu.pipelines import interpolation as jinterp
from mikudance_tpu.pipelines import scene_motion as jscene
from mikudance_tpu.pipelines import video as jvideo
from mikudance_tpu_torch.models import clip_vision, unet, vae, vae_temporal
from mikudance_tpu_torch.pipelines import image, interpolation, scene_motion, video

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
    port = video.VideoPipeline(video.ModelBundle(guide, den, enc, dec), CONFIG, device="cpu")

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
])
def test_paths_not_ported_raise(pipes, change, item):
    """The bank tiers of ROADMAP item 8 raise."""
    port = pipes[0]
    cfg = PipelineConfig(width=W, height=H, context=ContextConfig(frames=3, overlap=1), **change)
    pipe = video.VideoPipeline(port.bundle, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        pipe(*inputs(0))


# ----------------------------------------------- temporal decoder, interpolation

@pytest.fixture(scope="module")
def temporal_pipes(pipes):
    """The same UNets and encoder with the temporal decoder (its 16-frame
    chunk cut to 4, so that the 9 interpolated frames end in a remainder
    chunk of one) and ``interpolation_factor = 2``."""
    port, jpipe = pipes
    dec = seeded(vae_temporal.TemporalDecoder(TINY_VAE), 4)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for name, p in dec.named_parameters():
            if name.endswith("mix_factor"):
                p.copy_(torch.from_numpy(rng.uniform(-2, 2, p.shape).astype(np.float32)))
    dec.decode_chunk = 4
    cfg = PipelineConfig(width=W, height=H, num_inference_steps=3, guidance_scale=3.5,
                         context=ContextConfig(frames=3, overlap=1), interpolation_factor=2)
    b = port.bundle
    tport = video.VideoPipeline(video.ModelBundle(b.guide, b.den, b.vae_enc, dec), cfg,
                                device="cpu")
    jb = jpipe.bundle
    jbundle = jvideo.ModelBundle(
        jb.guide, jb.guide_params, jb.den, jb.den_params, jb.vae_enc, jb.vae_enc_params,
        jvae_temporal.TemporalDecoder(TINY_VAE, decode_chunk=4),
        {"params": jconvert.convert_temporal_decoder(dec.state_dict())})
    return tport, jvideo.VideoPipeline(jbundle, cfg)


def test_temporal_decoder_and_interpolation_match_jax(temporal_pipes):
    port, jpipe = temporal_pipes
    args = inputs(2)
    n = 2 * (T - 1) + 1
    want = np.asarray(jpipe(*args, decode=False))
    got = port(*args, decode=False)
    assert got.shape == want.shape == (n, h, w, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
    want_v = np.asarray(jpipe(*args, to_host=True))
    got_v = port(*args, to_host=True)
    assert got_v.shape == want_v.shape == (n, H, W, 3) and got_v.dtype == np.uint8
    assert np.abs(got_v.astype(np.int16) - want_v.astype(np.int16)).max() <= 1
    assert np.mean(got_v == want_v) > 0.999
    np.testing.assert_array_equal(port(*args).numpy(), got_v)


@pytest.mark.parametrize("mode", ["slerp", "lerp"])
@pytest.mark.parametrize("factor", [1, 2, 3])
def test_interpolate_latents_matches_jax(mode, factor):
    x = np.random.default_rng(factor).normal(size=(4, 3, 5, 4)).astype(np.float32)
    want = np.asarray(jinterp.interpolate_latents(jnp.asarray(x), factor, mode))
    got = interpolation.interpolate_latents(torch.from_numpy(x), factor, mode)
    assert got.shape == want.shape == (3 * 2 ** (factor - 1) + 1, 3, 5, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.numpy()[:: 2 ** (factor - 1)], x)  # the frames stay


@pytest.mark.parametrize("case", ["near-parallel", "opposite", "orthogonal"])
def test_slerp_matches_jax(case):
    """Above the 0.9995 dot threshold slerp is lerp; elsewhere the arc."""
    rng = np.random.default_rng(7)
    v0 = rng.normal(size=(2, 1, 64)).astype(np.float32)
    if case == "near-parallel":
        v1 = (1.3 * v0 + 1e-3 * rng.normal(size=v0.shape)).astype(np.float32)
    elif case == "opposite":
        v1 = (-0.7 * v0 + 0.2 * rng.normal(size=v0.shape)).astype(np.float32)
    else:
        v1 = rng.normal(size=v0.shape).astype(np.float32)
    ts = np.array([0.25, 0.5, 0.75], np.float32)
    got = interpolation.slerp(torch.from_numpy(v0), torch.from_numpy(v1),
                              torch.from_numpy(ts)[None, :, None]).numpy()
    for i in range(2):
        for j, tt in enumerate(ts):
            want = jinterp.slerp(jnp.asarray(v0[i, 0]), jnp.asarray(v1[i, 0]), float(tt))
            np.testing.assert_allclose(got[i, j], np.asarray(want), atol=1e-5, rtol=0)
            if case == "near-parallel":
                lerped = interpolation.lerp(torch.from_numpy(v0[i, 0]),
                                            torch.from_numpy(v1[i, 0]), float(tt))
                np.testing.assert_allclose(got[i, j], lerped.numpy(), atol=1e-6, rtol=0)


# ------------------------------------------------------------- scene motion

def cameras(seed, frames):
    rng = np.random.default_rng(seed)
    c2w = np.tile(np.eye(4), (frames, 1, 1))
    yaw = np.cumsum(rng.normal(0.02, 0.01, frames))
    c2w[:, 0, 0], c2w[:, 0, 2] = np.cos(yaw), np.sin(yaw)
    c2w[:, 2, 0], c2w[:, 2, 2] = -np.sin(yaw), np.cos(yaw)
    c2w[:, :3, 3] = np.cumsum(rng.uniform(-1, 1, (frames, 3)), axis=0)
    return np.linalg.inv(c2w).astype(np.float32), c2w.astype(np.float32)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (5, 12), (1, 3)])
def test_scene_motion_flow_matches_jax(hw):
    """Even and odd latent sizes (the grid starts at -(w + 1) // 2 for odd w)."""
    w2c, c2w = cameras(sum(hw), 5)
    depth = np.random.default_rng(1).uniform(0, 1, hw).astype(np.float32)
    want = np.asarray(jscene.scene_motion_flow(jnp.asarray(w2c), jnp.asarray(c2w),
                                               jnp.asarray(depth)))
    got = scene_motion.scene_motion_flow(w2c, c2w, depth, device="cpu")
    assert got.shape == (5,) + hw + (2,) and got.dtype == torch.float32
    assert not got[0].any() and got[1:].abs().max() > 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    twin = scene_motion.scene_motion_flow_np(w2c, c2w, depth)
    np.testing.assert_array_equal(twin, jscene.scene_motion_flow_np(w2c, c2w, depth))
    np.testing.assert_allclose(got.numpy(), twin, atol=1e-4, rtol=0)
    # tensors in, same numbers out, on the tensors' device
    again = scene_motion.scene_motion_flow(*map(torch.from_numpy, (w2c, c2w, depth)))
    np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("case", ["still camera", "non-finite"])
def test_scene_motion_flow_is_zero(case):
    w2c = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    c2w = w2c.copy()
    if case == "non-finite":
        c2w[1, 0, 0] = np.inf
    depth = np.full((4, 6), 0.5, np.float32)
    got = scene_motion.scene_motion_flow(w2c, c2w, depth, device="cpu").numpy()
    # a still camera leaves rounding residue (1e-6 in fp32), nothing else
    np.testing.assert_allclose(got, np.zeros((3, 4, 6, 2), np.float32), atol=1e-5, rtol=0)
    np.testing.assert_allclose(scene_motion.scene_motion_flow_np(w2c, c2w, depth), got,
                               atol=1e-5, rtol=0)
    if case == "non-finite":
        assert not got.any()
    assert scene_motion.DEFAULT_K == jscene.DEFAULT_K


# ------------------------------------------------------------ image pipeline

@pytest.fixture(scope="module")
def image_pipes(pipes):
    """Stage 1: guidance UNet without MAN, denoising UNet without motion
    modules; the VAE of the video bundle."""
    port, jpipe = pipes
    gcfg = GuidanceUNetConfig(unet=TINY, use_man=False)
    dcfg = DenoisingUNetConfig(unet=TINY, motion=MotionModuleConfig(enabled=False))
    guide, den = seeded(unet.GuidanceUNet(gcfg), 5), seeded(unet.DenoisingUNet(dcfg), 6)
    assert not hasattr(guide, "man_blocks") and not den.with_motion
    b, jb = port.bundle, jpipe.bundle
    cfg = PipelineConfig(width=W, height=H, num_inference_steps=3, guidance_scale=3.5)
    iport = image.ImagePipeline(video.ModelBundle(guide, den, b.vae_enc, b.vae_dec), cfg,
                                device="cpu")
    jbundle = jvideo.ModelBundle(
        junet.GuidanceUNet(gcfg),
        {"params": jconvert.convert_unet(guide.state_dict(), with_conv_out=False)},
        junet.DenoisingUNet(dcfg), {"params": jconvert.convert_unet(den.state_dict())},
        jb.vae_enc, jb.vae_enc_params, jb.vae_dec, jb.vae_dec_params)
    return iport, jimage.ImagePipeline(jbundle, cfg)


def image_inputs(seed):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
    rest = [rng.uniform(0, 1, (H, W, 3)).astype(np.float32) for _ in range(4)]
    return (ref, *rest, rng.normal(0, 1, (1, 5, 768)).astype(np.float32),
            rng.normal(0, 1, (1, h, w, 4)).astype(np.float32))


def test_image_pipeline_matches_jax(image_pipes):
    port, jpipe = image_pipes
    args = image_inputs(3)
    want = np.asarray(jpipe(*args, decode=False))
    got = port(*args, decode=False)
    assert got.dtype == torch.float32 and got.shape == (1, h, w, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
    want_i, got_i = np.asarray(jpipe(*args)), port(*args).numpy()
    assert got_i.shape == want_i.shape == (1, H, W, 3) and got_i.dtype == np.uint8
    assert np.abs(got_i.astype(np.int16) - want_i.astype(np.int16)).max() <= 1
    assert np.mean(got_i == want_i) > 0.999


def test_image_pipeline_takes_uint8_and_a_motion_denoiser(pipes, image_pipes):
    """uint8 pictures are scaled on the device as in the video pipeline; a
    denoiser with motion modules runs at T = 1 (temporal attention over one
    frame)."""
    port, _ = image_pipes
    args = image_inputs(4)
    as_u8 = [np.round((args[0] + 1) * 127.5).astype(np.uint8)] + [
        np.round(a * 255).astype(np.uint8) for a in args[1:5]]
    back = [as_u8[0].astype(np.float32) / 127.5 - 1] + [a.astype(np.float32) / 255
                                                         for a in as_u8[1:]]
    np.testing.assert_allclose(port(*as_u8, *args[5:], decode=False).numpy(),
                               port(*back, *args[5:], decode=False).numpy(), atol=1e-5, rtol=0)
    b = pipes[0].bundle
    motion_pipe = image.ImagePipeline(b, port.config, device="cpu")  # MAN skipped: no flow
    out = motion_pipe(*args, num_inference_steps=1, decode=False)
    assert out.shape == (1, h, w, 4) and bool(torch.isfinite(out).all())


# --------------------------------------------------------------- device rule

@pytest.mark.parametrize("entry", ["video", "image", "clip", "scene_motion"])
def test_no_device_and_no_card_raises(pipes, entry):
    """An entry point given no device runs on the card; where there is none it
    raises and does not quietly run on the CPU. ``device="cpu"`` runs."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    bundle = pipes[0].bundle
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if entry == "video":
            video.VideoPipeline(bundle, CONFIG)
        elif entry == "image":
            image.ImagePipeline(bundle, CONFIG)
        elif entry == "clip":
            clip_vision.clip_image_tokens(None, np.zeros((8, 8, 3), np.uint8))
        else:
            eye = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
            scene_motion.scene_motion_flow(eye, eye, np.zeros((4, 4), np.float32))
    assert video.VideoPipeline(bundle, CONFIG, device="cpu").device == torch.device("cpu")
    assert image.ImagePipeline(bundle, CONFIG, device="cpu").device == torch.device("cpu")


def test_clip_context_through_the_bundle(pipes):
    from mikudance_tpu.core.configs import CLIPVisionConfig

    b = pipes[0].bundle
    with pytest.raises(ValueError, match="no CLIP tower"):
        pipes[0].clip_context(np.zeros((8, 8, 3), np.uint8))
    tower = seeded(clip_vision.CLIPVisionTower(CLIPVisionConfig(
        image_size=28, hidden_size=64, intermediate_size=128, num_layers=1, num_heads=4,
        projection_dim=768)), 8)
    pipe = video.VideoPipeline(video.ModelBundle(b.guide, b.den, b.vae_enc, b.vae_dec, tower),
                               CONFIG, device="cpu")
    picture = np.random.default_rng(8).integers(0, 256, (H, W, 3), dtype=np.uint8)
    tokens = pipe.clip_context(picture)
    assert tokens.shape == (1, 5, 768) and tokens.dtype == np.float32
    out = pipe(*inputs(0)[:6], tokens, inputs(0)[7], num_inference_steps=1, decode=False)
    assert bool(torch.isfinite(out).all())


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
