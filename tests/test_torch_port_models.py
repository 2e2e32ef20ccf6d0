"""The PyTorch port's modules against the JAX package, on the CPU, in fp32.

Each port module gets seeded weights (PyTorch init, every zero-initialised
tensor refilled from numpy so no branch is silently off), its ``state_dict``
goes through the JAX package's converter, and both packages run the same
numpy inputs. Tolerances are those of ``tests/test_torch_parity.py``: 2e-4
per module, 1e-3 for the tiny UNets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mikudance_tpu.core import convert as jconvert
from mikudance_tpu.core.configs import (CLIPVisionConfig, DenoisingUNetConfig,
                                        GuidanceUNetConfig, MotionModuleConfig, UNetConfig,
                                        VAEConfig)
from mikudance_tpu.diffusion import ddim as jddim
from mikudance_tpu.models import clip_vision as jclip
from mikudance_tpu.models import layers as jlayers
from mikudance_tpu.models import man as jman
from mikudance_tpu.models import motion_module as jmotion
from mikudance_tpu.models import resnet as jresnet
from mikudance_tpu.models import unet as junet
from mikudance_tpu.models import vae as jvae
from mikudance_tpu.models import vae_temporal as jvae_temporal
from mikudance_tpu.utils import media as jmedia
from mikudance_tpu.pipelines import context as jcontext
from mikudance_tpu_torch.core import convert
from mikudance_tpu_torch.diffusion import ddim
from mikudance_tpu_torch.models import (clip_vision, layers, man, motion_module, resnet, unet,
                                        vae, vae_temporal)
from mikudance_tpu_torch.pipelines import context

TINY = UNetConfig(block_out_channels=(32, 64, 96, 96), attention_heads=4)
TINY_VAE = VAEConfig(block_out_channels=(16, 32, 32, 32), norm_num_groups=8)
TINY_DEN = DenoisingUNetConfig(unet=TINY, motion=MotionModuleConfig(num_attention_heads=4))
TINY_GUIDE = GuidanceUNetConfig(unet=TINY, use_man=True)
TINY_CLIP = CLIPVisionConfig(image_size=28, patch_size=14, hidden_size=64, intermediate_size=128,
                             num_layers=2, num_heads=4, projection_dim=32)


def seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """PyTorch's default init under a seed, then every all-zero tensor (biases,
    norm shifts, the motion modules' zero-init proj_out) refilled with
    seeded normals."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.copy_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
    return module.eval()


def build(cls, *args, seed=0):
    torch.manual_seed(seed)
    return seeded(cls(*args), seed)


def randn(rng, *shape, scale=1.0):
    return (rng.normal(0, scale, shape)).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, atol, name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = float(np.max(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))))
    assert err < atol, f"{name}: max abs err {err:.2e} >= {atol}"


def sub_sd(module, prefix):
    return {f"{prefix}.{k}": v for k, v in module.state_dict().items()}


# ------------------------------------------------------------------ bridge

@pytest.mark.parametrize("which", ["guidance", "denoising", "vae_encoder", "vae_decoder",
                                   "temporal_decoder", "clip_vision"])
def test_weight_bridge_round_trips(which):
    """port state_dict -> JAX tree -> inverse -> strict load: the inverse's
    convert equals the JAX tree exactly, and the reloaded module's
    state_dict equals the original bit for bit."""
    if which == "guidance":
        mod = build(unet.GuidanceUNet, TINY_GUIDE)
        fwd = lambda sd: jconvert.convert_unet(sd, with_man=True, with_conv_out=False)  # noqa: E731
        inv, fresh = convert.unet_state_dict_from_jax, unet.GuidanceUNet(TINY_GUIDE)
    elif which == "denoising":
        mod = build(unet.DenoisingUNet, TINY_DEN)
        fwd = lambda sd: jconvert.convert_unet(sd, with_motion=True)  # noqa: E731
        inv, fresh = convert.unet_state_dict_from_jax, unet.DenoisingUNet(TINY_DEN)
    elif which == "vae_encoder":
        mod = build(vae.Encoder, TINY_VAE)
        fwd, inv, fresh = (jconvert.convert_vae_encoder, convert.vae_encoder_state_dict_from_jax,
                           vae.Encoder(TINY_VAE))
    elif which == "vae_decoder":
        mod = build(vae.Decoder, TINY_VAE)
        fwd, inv, fresh = (jconvert.convert_vae_decoder, convert.vae_decoder_state_dict_from_jax,
                           vae.Decoder(TINY_VAE))
    elif which == "temporal_decoder":
        mod = build(vae_temporal.TemporalDecoder, TINY_VAE)
        fwd, inv, fresh = (jconvert.convert_temporal_decoder,
                           convert.temporal_decoder_state_dict_from_jax,
                           vae_temporal.TemporalDecoder(TINY_VAE))
    else:
        mod = build(clip_vision.CLIPVisionTower, TINY_CLIP)
        fwd = lambda sd: jconvert.convert_clip_vision(sd, num_layers=2)  # noqa: E731
        inv, fresh = convert.clip_vision_state_dict_from_jax, clip_vision.CLIPVisionTower(TINY_CLIP)
    sd = mod.state_dict()
    tree = fwd(sd)
    back = inv(tree)
    jax.tree_util.tree_map(np.testing.assert_array_equal, fwd(back), tree)
    fresh.load_state_dict({k: torch.from_numpy(v) for k, v in back.items()}, strict=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
    # the port's own forward converters are the JAX package's
    jax.tree_util.tree_map(np.testing.assert_array_equal, tree,
                           {"guidance": lambda s: convert.convert_unet(s, with_man=True,
                                                                       with_conv_out=False),
                            "denoising": lambda s: convert.convert_unet(s, with_motion=True),
                            "vae_encoder": convert.convert_vae_encoder,
                            "vae_decoder": convert.convert_vae_decoder,
                            "temporal_decoder": convert.convert_temporal_decoder,
                            "clip_vision": lambda s: convert.convert_clip_vision(s, 2)}[which](sd))


# ----------------------------------------------------------------- modules

@torch.no_grad()
def test_resnet_block():
    rng = np.random.default_rng(1)
    tm = build(resnet.ResnetBlock, 32, 64, 128)
    x, temb = randn(rng, 2, 8, 8, 32), randn(rng, 2, 128)
    params = {}
    jconvert._convert_resnet(sub_sd(tm, "r"), "r", params, ())
    want = jresnet.ResnetBlock(64).apply({"params": params}, jnp.asarray(x), jnp.asarray(temb))
    close(tm(t(x), t(temb)), want, 2e-4, "resnet")


@torch.no_grad()
def test_downsample_and_upsample_padding():
    """UNet Downsample pads (1, 1) at stride 2; Upsample is nearest 2x + conv."""
    rng = np.random.default_rng(2)
    x = randn(rng, 2, 7, 9, 16)
    for tm, jm in ((build(resnet.Downsample, 16), jresnet.Downsample(16)),
                   (build(resnet.Upsample, 16), jresnet.Upsample(16))):
        params = {"conv": {"kernel": jconvert.conv_kernel(tm.conv.weight),
                           "bias": jconvert._t(tm.conv.bias)}}
        want = jm.apply({"params": params}, jnp.asarray(x))
        got = tm(t(x))
        assert got.shape == want.shape
        close(got, want, 2e-4, type(tm).__name__)


@torch.no_grad()
@pytest.mark.parametrize("mode", ["write", "read"])
def test_spatial_transformer(mode):
    """Write mode returns the bank; read mode adds projected bank K/V to the
    self-attention and takes hoisted cross-attention K/V."""
    rng = np.random.default_rng(3)
    tm = build(layers.SpatialTransformer, 64, 4, 768)
    params = {}
    jconvert._convert_spatial_transformer(sub_sd(tm, "a"), "a", params, ())
    jm = jlayers.SpatialTransformer(64, 4)
    x, ctx = randn(rng, 2, 8, 8, 64), randn(rng, 2, 5, 768)
    if mode == "write":
        want, bank_w = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx), write=True)
        got, bank_g = tm(t(x), t(ctx), write=True)
        close(bank_g, bank_w, 2e-4, "bank")
    else:
        ref_kv = (randn(rng, 2, 64, 64), randn(rng, 2, 64, 64))
        ctx_kv = (randn(rng, 2, 5, 64), randn(rng, 2, 5, 64))
        want, _ = jm.apply({"params": params}, jnp.asarray(x), None,
                           ref_kv=tuple(map(jnp.asarray, ref_kv)),
                           ctx_kv=tuple(map(jnp.asarray, ctx_kv)))
        got, _ = tm(t(x), None, ref_kv=tuple(map(t, ref_kv)), ctx_kv=tuple(map(t, ctx_kv)))
    close(got, want, 2e-4, f"spatial transformer {mode}")


@torch.no_grad()
def test_layer_norm_is_one_pass_and_gelu_is_erf():
    """The one-pass variance E[x^2] - E[x]^2 and the erf GELU, against the
    JAX layers."""
    rng = np.random.default_rng(4)
    x = randn(rng, 3, 7, 32) + 3.0
    ln = build(layers.LayerNorm, 32)
    jp = {"params": {"scale": jnp.asarray(ln.weight.numpy()), "bias": jnp.asarray(ln.bias.numpy())}}
    close(ln(t(x)), jlayers.FusedLayerNorm(32).apply(jp, jnp.asarray(x)), 1e-5, "layer norm")
    # Rows 4096 +- 1/64: in fp32 every partial sum of x^2 is exact and E[x^2]
    # equals E[x]^2, so the one-pass variance is exactly 0 (a two-pass one
    # would give 2^-12): outputs of about +-4.9 instead of +-1.
    row = (4096.0 + np.tile([1.0, -1.0], 16) / 64).astype(np.float32)[None, None]
    want = jlayers.FusedLayerNorm(32).apply(jp, jnp.asarray(row))
    assert np.abs((np.asarray(want) - ln.bias.numpy()) / ln.weight.numpy()).min() > 4.0
    close(ln(t(row)), want, 1e-3, "layer norm, one-pass variance")

    ff = build(layers.GEGLUFeedForward, 32)
    p = {"proj": {"kernel": jconvert.dense_kernel(ff.net[0].proj.weight),
                  "bias": jconvert._t(ff.net[0].proj.bias)},
         "out": {"kernel": jconvert.dense_kernel(ff.net[2].weight),
                 "bias": jconvert._t(ff.net[2].bias)}}
    want = jlayers.GEGLUFeedForward(32).apply({"params": p}, jnp.asarray(x))
    close(ff(t(x)), want, 2e-4, "GEGLU")


@torch.no_grad()
@pytest.mark.parametrize("which", ["spatial_transformer", "motion_module", "vae_resnet",
                                   "unet_resnet"])
def test_group_norm_epsilons(which):
    """Inputs with variance ~1e-6 make GroupNorm's eps (1e-6 in the spatial
    transformer, motion module and VAE; 1e-5 in the UNet resnets) change
    the output by a large factor, so a wrong eps cannot pass."""
    rng = np.random.default_rng(11)
    if which == "spatial_transformer":
        tm, x = build(layers.SpatialTransformer, 64, 4, 768), randn(rng, 2, 4, 4, 64, scale=1e-3)
        params = {}
        jconvert._convert_spatial_transformer(sub_sd(tm, "a"), "a", params, ())
        ctx = randn(rng, 2, 5, 768)
        want, _ = jlayers.SpatialTransformer(64, 4).apply({"params": params}, jnp.asarray(x),
                                                          jnp.asarray(ctx))
        got, _ = tm(t(x), t(ctx))
    elif which == "motion_module":
        tm, x = build(motion_module.MotionModule, 64, 4), randn(rng, 1, 4, 2, 2, 64, scale=1e-3)
        params = {}
        jconvert._convert_motion_module(sub_sd(tm, "m"), "m", params, ())
        want = jmotion.MotionModule(64, heads=4).apply({"params": params}, jnp.asarray(x))
        got = tm(t(x))
    elif which == "vae_resnet":
        tm, x = build(vae.VAEResnetBlock, 32, 32, 8), randn(rng, 2, 4, 4, 32, scale=1e-3)
        params = {}
        jconvert._convert_vae_resnet(sub_sd(tm, "r"), "r", params, ())
        want = jvae.VAEResnetBlock(32, 8).apply({"params": params}, jnp.asarray(x))
        got = tm(t(x))
    else:
        tm, x = build(resnet.ResnetBlock, 32, 32, 128), randn(rng, 2, 4, 4, 32, scale=1e-3)
        params = {}
        jconvert._convert_resnet(sub_sd(tm, "r"), "r", params, ())
        temb = randn(rng, 2, 128)
        want = jresnet.ResnetBlock(32).apply({"params": params}, jnp.asarray(x), jnp.asarray(temb))
        got = tm(t(x), t(temb))
    close(got, want, 2e-4, which)


@torch.no_grad()
def test_motion_module():
    rng = np.random.default_rng(5)
    tm = build(motion_module.MotionModule, 64, 4)
    assert tm.temporal_transformer.proj_out.weight.abs().min() > 0  # refilled
    params = {}
    jconvert._convert_motion_module(sub_sd(tm, "m"), "m", params, ())
    x = randn(rng, 2, 6, 4, 4, 64)  # (B, T, H, W, C)
    want = jmotion.MotionModule(64, heads=4, max_len=32).apply({"params": params}, jnp.asarray(x))
    close(tm(t(x)), want, 2e-4, "motion module")


@torch.no_grad()
def test_man_block():
    rng = np.random.default_rng(6)
    tm = build(man.MANBlock, 64)
    params = {}
    jconvert._convert_man(sub_sd(tm, "man"), "man", params, ())
    x, m = randn(rng, 2, 8, 8, 64), randn(rng, 2, 5, 7, 2)  # non-divisible resize
    want = jman.MANBlock().apply({"params": params}, jnp.asarray(x), jnp.asarray(m))
    close(tm(t(x), t(m)), want, 2e-4, "MAN")


@torch.no_grad()
def test_vae_encoder_and_decoder():
    rng = np.random.default_rng(7)
    enc, dec = build(vae.Encoder, TINY_VAE), build(vae.Decoder, TINY_VAE, seed=1)
    x, z = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32), randn(rng, 2, 4, 4, 4)
    want = jvae.Encoder(TINY_VAE).apply(
        {"params": jconvert.convert_vae_encoder(enc.state_dict())}, jnp.asarray(x))
    got = enc(t(x))
    assert got.shape == (2, 4, 4, 8)
    close(got, want, 2e-4, "vae encoder")
    want = jvae.Decoder(TINY_VAE).apply(
        {"params": jconvert.convert_vae_decoder(dec.state_dict())}, jnp.asarray(z))
    close(dec(t(z)), want, 2e-4, "vae decoder")


@torch.no_grad()
@pytest.mark.parametrize("batch", [1, 2])
def test_clip_vision_tower(batch):
    """Hugging Face key grammar (``pre_layrnorm`` as spelt there), quick GELU,
    16-heads-style attention on the plain route, full token sequence out."""
    rng = np.random.default_rng(12)
    tm = build(clip_vision.CLIPVisionTower, TINY_CLIP)
    assert "vision_model.pre_layrnorm.weight" in tm.state_dict()
    assert "vision_model.encoder.layers.1.self_attn.out_proj.bias" in tm.state_dict()
    params = jconvert.convert_clip_vision(tm.state_dict(), num_layers=2)
    x = randn(rng, batch, 28, 28, 3)
    want = jclip.CLIPVisionTower(TINY_CLIP).apply({"params": params}, jnp.asarray(x))
    got = tm(t(x))
    assert got.shape == (batch, 5, 32)
    close(got, want, 2e-4, "clip tower")
    close(clip_vision.quick_gelu(t(x)), jclip.quick_gelu(jnp.asarray(x)), 1e-6, "quick gelu")


@pytest.mark.parametrize("kind", ["pil", "array"])
def test_clip_preprocessing(kind):
    """A PIL picture goes through PIL's bicubic resize exactly as the JAX
    package's ``to_clip_input``; an array through torch's antialiased bicubic,
    within one uint8 level of it (the two round at different places)."""
    from PIL import Image

    rng = np.random.default_rng(13)
    ramp = np.add.outer(np.arange(90), np.arange(120))[..., None] + rng.integers(0, 40, (90, 120, 3))
    img = ramp.astype(np.uint8)
    want = jmedia.to_clip_input(Image.fromarray(img))
    np.testing.assert_array_equal(clip_vision.CLIP_IMAGE_MEAN, jclip.CLIP_IMAGE_MEAN)
    np.testing.assert_array_equal(clip_vision.CLIP_IMAGE_STD, jclip.CLIP_IMAGE_STD)
    if kind == "pil":
        np.testing.assert_allclose(clip_vision.to_clip_input(Image.fromarray(img)), want, atol=1e-6)
    else:
        got = clip_vision.to_clip_input(img)
        assert got.shape == (1, 224, 224, 3) and got.dtype == np.float32
        levels = np.abs(got - want) * 255.0 * clip_vision.CLIP_IMAGE_STD
        assert levels.max() <= 1.0 + 1e-3


@torch.no_grad()
def test_clip_image_tokens_helper():
    """Picture -> tokens on the host, as ``scripts/inference_video.py`` does it."""
    from PIL import Image

    rng = np.random.default_rng(14)
    tm = build(clip_vision.CLIPVisionTower, TINY_CLIP)
    img = Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8))
    params = jconvert.convert_clip_vision(tm.state_dict(), num_layers=2)
    pixels = np.asarray(Image.fromarray(np.asarray(img)).resize((28, 28), Image.BICUBIC),
                        np.float32) / 255.0
    pixels = ((pixels - jclip.CLIP_IMAGE_MEAN) / jclip.CLIP_IMAGE_STD)[None]
    want = jclip.CLIPVisionTower(TINY_CLIP).apply({"params": params}, jnp.asarray(pixels))
    got = clip_vision.clip_image_tokens(tm, img, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == (1, 5, 32)
    close(got, want, 2e-4, "clip tokens")


def temporal_decoder(seed):
    """A tiny temporal decoder with every mix factor away from 0.5 and a
    non-zero ``time_conv_out`` (PyTorch's init leaves it so)."""
    tm = build(vae_temporal.TemporalDecoder, TINY_VAE, seed=seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if name.endswith("mix_factor"):
                p.copy_(t(rng.uniform(-2, 2, p.shape).astype(np.float32)))
    assert tm.decoder.time_conv_out.weight.abs().min() > 0
    return tm, {"params": jconvert.convert_temporal_decoder(tm.state_dict())}


@torch.no_grad()
@pytest.mark.parametrize("frames", [1, 4, 5])
def test_temporal_decoder(frames):
    """One chunk: the joint GroupNorms over frames, the (3,1,1) temporal
    convolutions, the learned blend and ``time_conv_out``."""
    tm, params = temporal_decoder(15)
    z = randn(np.random.default_rng(frames), frames, 4, 4, 4)
    want = jvae_temporal.TemporalDecoder(TINY_VAE).apply(params, jnp.asarray(z))
    got = tm(t(z))
    assert got.shape == (frames, 32, 32, 3)
    close(got, want, 2e-4, "temporal decoder")


@torch.no_grad()
def test_temporal_decoder_parts():
    rng = np.random.default_rng(16)
    conv = build(vae_temporal.TemporalConv, 8, 12)
    x = randn(rng, 5, 3, 4, 8)
    p = {"conv": {"kernel": jconvert.conv_temporal_kernel(conv.weight),
                  "bias": jconvert._t(conv.bias)}}
    close(conv(t(x)), jvae_temporal.TemporalConv(12).apply({"params": p}, jnp.asarray(x)),
          2e-4, "temporal conv")
    # the temporal block pools its norms over frames: frames are not independent
    blk = build(vae_temporal.TemporalResnetBlock, 16, 4)
    x = randn(rng, 3, 4, 4, 16) + np.arange(3, dtype=np.float32)[:, None, None, None]
    assert (blk(t(x))[:1] - blk(t(x[:1]))).abs().max() > 1e-3


@torch.no_grad()
@pytest.mark.parametrize("frames,chunk", [(8, 4), (6, 4), (3, 4)])
def test_temporal_decoder_chunks_and_remainder(frames, chunk):
    """``decode_frames`` with the 16-frame chunk cut to 4: whole chunks, then
    the remainder decoded as it is, never zero-padded."""
    from mikudance_tpu.pipelines import video as jvideo
    from mikudance_tpu_torch.pipelines import video

    tm, params = temporal_decoder(17)
    tm.decode_chunk = chunk
    assert vae_temporal.TemporalDecoder.decode_chunk == 16 and tm.frames_coupled
    z = randn(np.random.default_rng(frames), frames, 4, 4, 4)
    want = jvideo.decode_frames(jvae_temporal.TemporalDecoder(TINY_VAE, decode_chunk=chunk),
                                params, jnp.asarray(z))
    got = video.decode_frames(tm, t(z))
    assert got.shape == (frames, 32, 32, 3)
    close(got, want, 2e-4, "chunked temporal decode")


# ------------------------------------------------------ schedule, windows

def test_ddim_schedule_and_step():
    js = jddim.DDIMSchedule.create()
    ts = ddim.DDIMSchedule.create()
    np.testing.assert_array_equal(ts.alphas_cumprod, np.asarray(js.alphas_cumprod))
    for steps in (4, 20):
        for a, b in zip(ddim.inference_step_pairs(ts, steps), jddim.inference_step_pairs(js, steps)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(8)
    out, x = randn(rng, 3, 4, 4, 4), randn(rng, 3, 4, 4, 4)
    for step, prev in ((999, 949), (49, -1)):
        want = js.step(jnp.asarray(out), jnp.asarray(step), jnp.asarray(prev), jnp.asarray(x))
        close(ts.step(t(out), step, prev, t(x)), want, 2e-4, f"ddim step {step}")


@pytest.mark.parametrize("frames,size,overlap", [(16, 30, 8), (5, 3, 1), (77, 16, 4), (64, 24, 8)])
def test_window_matrix(frames, size, overlap):
    got = context.window_matrix(frames, size, 1, overlap)
    np.testing.assert_array_equal(got, jcontext.window_matrix(frames, size, 1, overlap))
    np.testing.assert_array_equal(context.frame_counts(got, frames),
                                  jcontext.frame_counts(got, frames))


# ----------------------------------------------------------------- UNets

@torch.no_grad()
def test_tiny_guidance_unet_banks():
    rng = np.random.default_rng(9)
    tm = build(unet.GuidanceUNet, TINY_GUIDE)
    params = jconvert.convert_unet(tm.state_dict(), with_man=True, with_conv_out=False)
    x, mmap, ctx = randn(rng, 2, 16, 16, 20), randn(rng, 2, 16, 16, 2), randn(rng, 2, 5, 768)
    t0 = np.zeros((2,), np.int32)
    want = jax.jit(junet.GuidanceUNet(TINY_GUIDE).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(mmap), jnp.asarray(t0), jnp.asarray(ctx))
    got = tm(t(x), t(mmap), t(t0), t(ctx))
    assert set(got) == set(want) == set(unet.bank_keys(TINY))
    for k in got:
        close(got[k], want[k], 1e-3, f"guidance bank {k}")


@torch.no_grad()
def test_tiny_denoising_unet_with_hoisted_kv():
    """Banks and CLIP context projected once (precompute_*_kv), then the 3-D
    UNet with motion modules, as the sampler runs it."""
    rng = np.random.default_rng(10)
    tm = build(unet.DenoisingUNet, TINY_DEN)
    params = {"params": jconvert.convert_unet(tm.state_dict(), with_motion=True)}
    B, T, H, W = 2, 3, 16, 16
    x, ctx = randn(rng, B, T, H, W, 4), randn(rng, B, 5, 768)
    ts = np.array([500, 20], np.int32)
    sizes = {"down_0": (256, 32), "down_1": (64, 64), "down_2": (16, 96), "mid": (4, 96),
             "up_1": (16, 96), "up_2": (64, 64), "up_3": (256, 32)}
    banks = {k: randn(rng, B * T, *sizes["mid" if k == "mid" else k.rsplit("_", 1)[0]])
             for k in unet.bank_keys(TINY)}

    jbanks_kv = junet.precompute_reference_kv(params, {k: jnp.asarray(v) for k, v in banks.items()},
                                              jnp.float32)
    jctx_kv = junet.precompute_context_kv(params, jnp.asarray(ctx), unet.bank_keys(TINY), jnp.float32)
    want = jax.jit(lambda p, *a, **kw: junet.DenoisingUNet(TINY_DEN).apply(p, *a, **kw))(
        params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
        banks_kv=jbanks_kv, ctx_kv=jctx_kv)

    banks_kv = unet.precompute_reference_kv(tm, {k: t(v) for k, v in banks.items()}, torch.float32)
    ctx_kv = unet.precompute_context_kv(tm, t(ctx), unet.bank_keys(TINY), torch.float32)
    for k in banks_kv:
        close(banks_kv[k][0], jbanks_kv[k][0], 2e-4, f"bank K {k}")
        close(ctx_kv[k][1], jctx_kv[k][1], 2e-4, f"context V {k}")
    got = tm(t(x), t(ts), banks_kv=banks_kv, ctx_kv=ctx_kv)
    assert got.shape == (B, T, H, W, 4)
    close(got, want, 1e-3, "denoising unet")
