"""The port's row-major configuration against the JAX package, on the CPU.

The JAX package's "whole-loop row-major" configuration is three module
switches: ``models.layers.PALLAS_CHAIN`` (the transformer-block interior as a
chain of ``fused_layer_norm`` / ``fused_linear`` / attention),
``kernels.conv2d.PREFER_PALLAS`` (stride-1 3x3 convs through ``conv3x3_fused``)
and ``kernels.flash_attention.TRANSPOSED_FULLC`` / ``NEUTRAL_FULLC`` off
(packed-heads self-attention through ``flash_attention_fullc``). The port has
the same switches, set together by ``kernels.row_major()``, and the kernels
K7 (linear), K8 (conv), K10 / K11 (anchored attention) behind them.

Here, with inputs from numpy seeds:

- each plain version against the Pallas kernel in interpret mode
  (atol = rtol = 2e-2: bf16 operands and one bf16 rounding of the result; the
  conv at the 3e-2 / 5e-2 of ``tests/test_conv2d.py``, whose kernel rounds
  fp32 inputs to bf16);
- the modules that hold a kernel against their JAX counterparts in fp32 with
  the switch patched on both sides, at 2e-4, counting that both sides really
  went through the switched path (on the CPU the JAX entry points take their
  plain references, as the port's take their plain versions);
- the tiny video pipeline inside ``row_major()`` against the JAX pipeline
  with the three switches patched (latents at 1e-3) and against the port's
  own default configuration (1e-4: the same function, other order of fp32
  additions).

The JAX switches are patched with ``monkeypatch`` and the JAX caches cleared
around it: a function traced with a switch off does not see it flipped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mikudance_tpu.kernels.conv2d as jconv2d
import mikudance_tpu.kernels.flash_attention as jfa
import mikudance_tpu.kernels.linear as jlinear
from mikudance_tpu.core import convert as jconvert
from mikudance_tpu.core.configs import (ContextConfig, DenoisingUNetConfig, GuidanceUNetConfig,
                                        MotionModuleConfig, PipelineConfig, UNetConfig,
                                        VAEConfig)
from mikudance_tpu.models import layers as jlayers
from mikudance_tpu.models import man as jman
from mikudance_tpu.models import resnet as jresnet
from mikudance_tpu.models import unet as junet
from mikudance_tpu.models import vae as jvae
from mikudance_tpu.pipelines import video as jvideo
from mikudance_tpu_torch.kernels import conv2d, row_major
from mikudance_tpu_torch.kernels import flash_attention as fa
from mikudance_tpu_torch.kernels import linear
from mikudance_tpu_torch.models import layers, man, resnet, unet, vae
from mikudance_tpu_torch.pipelines import video

ATOL = RTOL = 2e-2  # bf16 kernel against its plain version


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, atol, name):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = float(np.max(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))))
    assert err < atol, f"{name}: max abs err {err:.2e} >= {atol}"


def seeded(module, seed, shrink=1.0):
    """PyTorch's init under a seed, every all-zero tensor refilled from numpy;
    ``shrink`` scales the weight matrices (see test_torch_port_pipeline.py)."""
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.copy_(t(rng.normal(0, 0.05, p.shape).astype(np.float32)))
            if p.ndim > 1:
                p.mul_(shrink)
    return module.eval()


def build(cls, *args, seed=0):
    torch.manual_seed(seed)
    return seeded(cls(*args), seed)


def sub_sd(module, prefix):
    return {f"{prefix}.{k}": v for k, v in module.state_dict().items()}


def counting(monkeypatch, module, name):
    """Wrap ``module.name`` to count its calls; returns the list of calls."""
    calls, fn = [], getattr(module, name)

    def wrapper(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.fixture
def jax_row_major(monkeypatch):
    """The JAX package's three switches flipped for one test, with nothing
    traced before or after it kept."""
    jax.clear_caches()
    monkeypatch.setattr(jlayers, "PALLAS_CHAIN", True)
    monkeypatch.setattr(jconv2d, "PREFER_PALLAS", True)
    monkeypatch.setattr(jfa, "TRANSPOSED_FULLC", False)
    monkeypatch.setattr(jfa, "NEUTRAL_FULLC", False)
    yield
    jax.clear_caches()


# ------------------------------------------- plain versions vs Pallas, interpret

@pytest.mark.parametrize("bias,residual,dtype,lead", [
    (True, False, "bfloat16", (64,)), (True, True, "bfloat16", (3, 32)),
    (False, True, "bfloat16", (64,)), (False, False, "bfloat16", (2, 4, 8)),
    (True, True, "float32", (64,)),
])
def test_k7_plain_matches_pallas_linear(bias, residual, dtype, lead):
    """``fused_linear(x, w, b, r, True)`` as tests/test_fused_norm_linear.py runs
    it; the port's weight is the ``nn.Linear`` layout, the JAX kernel's
    transposed."""
    rng = np.random.default_rng(7)
    cin, cout = 320, 128
    x = rng.normal(0, 1, lead + (cin,)).astype(np.float32)
    w = rng.normal(0, 0.05, (cin, cout)).astype(np.float32)
    b = rng.normal(0, 0.5, (cout,)).astype(np.float32) if bias else None
    r = rng.normal(0, 1, lead + (cout,)).astype(np.float32) if residual else None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlinear.fused_linear(jnp.asarray(x, jd), jnp.asarray(w),
                                None if b is None else jnp.asarray(b),
                                None if r is None else jnp.asarray(r, jd), True)
    got = linear.fused_linear(t(x).to(td), t(w.T.copy()).to(td), None if b is None else t(b),
                              None if r is None else t(r).to(td))
    assert got.dtype == td and got.shape == lead + (cout,)
    tol = ATOL if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    # the two roundings, in order: the cast comes before the residual
    if residual and dtype == "bfloat16":
        y = linear.linear_plain(t(x).to(td), t(w.T.copy()).to(td), None if b is None else t(b))
        assert torch.equal(got, y + t(r).to(td))


@pytest.mark.parametrize("shape,cout,dtype,tol", [
    ((2, 12, 8, 32), 48, "float32", 3e-2),     # W = 8
    ((1, 6, 24, 64), 64, "float32", 3e-2),     # W = 24: no multiple of 16
    ((1, 6, 16, 64), 8, "float32", 3e-2),      # a narrow output, as a conv_out
    ((2, 8, 8, 32), 32, "bfloat16", 5e-2),
])
def test_k8_plain_matches_pallas_conv(shape, cout, dtype, tol):
    """``conv3x3_fused(x, w, b, True)`` as tests/test_conv2d.py runs it; the
    port's weight is torch's OIHW, the JAX kernel's HWIO."""
    rng = np.random.default_rng(11)
    cin = shape[-1]
    x = rng.normal(0, 1, shape).astype(np.float32)
    w = rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32)
    b = rng.normal(0, 0.1, (cout,)).astype(np.float32)
    want = jconv2d.conv3x3_fused(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w),
                                 jnp.asarray(b), True)
    oihw = t(w.transpose(3, 2, 0, 1).copy())
    got = conv2d.conv3x3_fused(t(x).to(getattr(torch, dtype)), oihw, t(b))
    assert got.shape == shape[:3] + (cout,) and got.is_contiguous()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    # the packed copy K8 reads is the taps-outermost view of the same weight
    packed = conv2d.pack_weight(oihw)
    assert packed.shape == (3, 3, cout, cin) and packed.is_contiguous()
    np.testing.assert_array_equal(packed.numpy(), w.transpose(0, 1, 3, 2))


@pytest.mark.parametrize("hd,heads,variant,q_scale", [
    (40, 4, "resident", 1.0), (80, 2, "resident", 1.0),
    (40, 4, "stream", 1.0), (80, 2, "stream", 1.0),
    (40, 4, "resident", 4.0), (80, 2, "stream", 4.0),   # the clamp bites
])
def test_k10_k11_plain_matches_pallas_fullc(hd, heads, variant, q_scale, monkeypatch):
    """``flash_attention_fullc(..., interpret=True)``: resident as it routes
    by itself at this size, streamed with its byte limit set to 0 (as
    tests/test_flash_attention.py forces its routes). With q four times as
    large most rows' scores all lie more than 100 log2 units under the anchor:
    the clamp makes those rows uniform averages of v, which the exact softmax
    is not, and the plain version follows the kernel there."""
    B, S, C = 1, 256, hd * heads
    rng = np.random.default_rng(hd + heads)
    q, k, v = (rng.normal(size=(B, S, C)).astype(np.float32) for _ in range(3))
    q *= q_scale
    if variant == "stream":
        monkeypatch.setattr(jfa, "FULLC_RESIDENT_BYTES", 0)
        monkeypatch.setattr(jfa, "_flash_kernel_fullc_resident", None)
    else:
        monkeypatch.setattr(jfa, "_flash_kernel_fullc_stream", None)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jfa.flash_attention_fullc(jq, jk, jv, heads, 1.0 / np.sqrt(hd), q_block=128,
                                     k_block=128, interpret=True)
    tq, tk, tv = (t(a).to(torch.bfloat16) for a in (q, k, v))
    got = fa.flash_attention_fullc_anchored(tq, tk, tv, heads)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, C)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)
    excursion = fa.anchor_excursion(tq, tk, heads)
    exact = fa.dot_product_attention(tq, tk, tv, heads).float()
    if q_scale == 1.0:  # the clamp idle: the softmax
        assert excursion < fa.EXP_CLAMP
        torch.testing.assert_close(got.float(), exact, atol=ATOL, rtol=RTOL)
    else:               # and not the softmax where it bites
        assert excursion > fa.EXP_CLAMP
        assert (got.float() - exact).abs().max() > 0.5


def test_byte_rule_matches_jax():
    """K10 takes the 2304-token level at C = 640, K11 the 9216-token level at
    C = 320, as the JAX package routes them."""
    assert fa.FULLC_RESIDENT_BYTES == jfa.FULLC_RESIDENT_BYTES and fa.LANES == jfa.LANES
    assert fa.EXP_CLAMP == jfa._EXP_CLAMP
    for S, C, heads in ((2304, 640, 8), (9216, 320, 8), (1024, 320, 8), (4096, 320, 8),
                        (4096, 640, 8), (5184, 320, 8), (2304, 1280, 8)):
        assert fa._lane_padded_bytes(S, C) == jfa._lane_padded_bytes(S, C)
        assert fa._can_fuse_ones(C, heads) == jfa._can_fuse_ones(C, heads)
        Cv = C + heads if jfa._can_fuse_ones(C, heads) else C
        want = (jfa._lane_padded_bytes(S, C) + jfa._lane_padded_bytes(S, Cv)
                <= jfa.FULLC_RESIDENT_BYTES)
        assert fa.fullc_resident(S, C, heads) == want
    assert fa.fullc_resident(2304, 640, 8) and not fa.fullc_resident(9216, 320, 8)


# ------------------------------------------------ modules that hold a kernel

@torch.no_grad()
@pytest.mark.parametrize("banks", ["ref_kv", "none"])
def test_transformer_block_chain(banks, monkeypatch, jax_row_major):
    """The read-mode block with ``PALLAS_CHAIN`` on both sides: eight products
    through ``fused_linear`` on each, with the bank K/V as residuals, or with
    none (the uncond pass of the streamed tiers)."""
    rng = np.random.default_rng(3)
    tm = build(layers.SpatialTransformer, 64, 4, 768)
    params = {}
    jconvert._convert_spatial_transformer(sub_sd(tm, "a"), "a", params, ())
    x = rng.normal(size=(2, 8, 8, 64)).astype(np.float32)
    ref_kv = None
    if banks == "ref_kv":
        ref_kv = tuple(rng.normal(size=(2, 64, 64)).astype(np.float32) for _ in range(2))
    ctx_kv = tuple(rng.normal(size=(2, 5, 64)).astype(np.float32) for _ in range(2))
    jcalls = counting(monkeypatch, jlinear, "fused_linear")
    want, _ = jlayers.SpatialTransformer(64, 4).apply(
        {"params": params}, jnp.asarray(x), None,
        ref_kv=None if ref_kv is None else tuple(map(jnp.asarray, ref_kv)),
        ctx_kv=tuple(map(jnp.asarray, ctx_kv)))
    assert len(jcalls) == 8

    args = dict(ref_kv=None if ref_kv is None else tuple(map(t, ref_kv)),
                ctx_kv=tuple(map(t, ctx_kv)))
    standard, _ = tm(t(x), None, **args)
    monkeypatch.setattr(layers, "PALLAS_CHAIN", True)
    calls = counting(monkeypatch, layers, "fused_linear")
    got, bank = tm(t(x), None, **args)
    assert len(calls) == 8 and bank is None
    close(got, want, 2e-4, f"chain, banks {banks}")
    close(got, standard, 1e-5, "chain against the standard path")
    # write mode, a raw bank and a block without hoisted context K/V stay off it
    ctx = t(rng.normal(size=(2, 5, 768)).astype(np.float32))
    tm(t(x), ctx, write=True)
    tm(t(x), ctx, ref=t(rng.normal(size=(2, 64, 64)).astype(np.float32)), ctx_kv=args["ctx_kv"])
    tm(t(x), ctx)
    assert len(calls) == 8


@torch.no_grad()
@pytest.mark.parametrize("which", ["resnet", "man", "vae_resnet", "upsample"])
def test_conv_routed_blocks(which, monkeypatch, jax_row_major):
    """``conv2d.PREFER_PALLAS`` on both sides: the eligible convs (Cin >= 32,
    W % 8 == 0) go through ``conv3x3_fused``, MAN's 2-channel conv does not."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    params = {}
    if which == "resnet":
        tm, fused = build(resnet.ResnetBlock, 32, 64, 128), 2
        jconvert._convert_resnet(sub_sd(tm, "r"), "r", params, ())
        temb = rng.normal(size=(2, 128)).astype(np.float32)
        targs, jm, jargs = (t(x), t(temb)), jresnet.ResnetBlock(64), (x, temb)
    elif which == "man":
        tm, fused = build(man.MANBlock, 32), 2   # gamma and beta; not the 2-channel conv
        jconvert._convert_man(sub_sd(tm, "man"), "man", params, ())
        m = rng.normal(size=(2, 5, 7, 2)).astype(np.float32)
        targs, jm, jargs = (t(x), t(m)), jman.MANBlock(), (x, m)
    elif which == "vae_resnet":
        tm, fused = build(vae.VAEResnetBlock, 32, 64, 8), 2
        jconvert._convert_vae_resnet(sub_sd(tm, "r"), "r", params, ())
        targs, jm, jargs = (t(x),), jvae.VAEResnetBlock(64, 8), (x,)
    else:
        tm, fused = build(resnet.Upsample, 32), 1
        params = {"conv": {"kernel": jconvert.conv_kernel(tm.conv.weight),
                           "bias": jconvert._t(tm.conv.bias)}}
        targs, jm, jargs = (t(x),), jresnet.Upsample(32), (x,)
    jcalls = counting(monkeypatch, jconv2d, "conv3x3_fused")
    want = jm.apply({"params": params}, *map(jnp.asarray, jargs))
    assert len(jcalls) == fused + (which == "man")  # JAX decides inside the call

    standard = tm(*targs)
    calls = counting(monkeypatch, conv2d, "conv3x3_fused")
    tm(*targs)
    assert not calls  # the switch is off
    monkeypatch.setattr(conv2d, "PREFER_PALLAS", True)
    got = tm(*targs)
    assert len(calls) == fused
    close(got, want, 2e-4, which)
    close(got, standard, 1e-5, f"{which} against nn.Conv2d")
    assert not any("packed" in k for k in tm.state_dict())


def test_applicability_rule_and_packed_weight_cache():
    """The JAX rule (stride 1, Cin >= 32, W % 8 == 0); the packed weight is
    made once and again only when the weight changes."""
    conv = resnet.conv3x3(32, 16)
    ok = torch.empty(1, 6, 8, 32, device="meta")
    assert conv2d.applicable(conv, ok)
    assert not conv2d.applicable(conv, torch.empty(1, 6, 12, 32, device="meta"))   # W = 12
    assert not conv2d.applicable(resnet.conv3x3(16, 16), torch.empty(1, 8, 8, 16, device="meta"))
    assert not conv2d.applicable(resnet.conv3x3(32, 16, stride=2), ok)
    assert not conv2d.applicable(torch.nn.Conv2d(32, 16, 1), ok)
    assert not conv2d.applicable(torch.nn.Conv2d(32, 16, 3), ok)                  # no padding
    first = conv2d.packed_weight(conv)
    assert conv2d.packed_weight(conv) is first
    assert torch.equal(first, conv.weight.detach().permute(2, 3, 0, 1))
    with torch.no_grad():
        conv.weight.mul_(2.0)                                                   # in place
    second = conv2d.packed_weight(conv)
    assert second is not first and torch.equal(second, conv.weight.detach().permute(2, 3, 0, 1))
    conv.load_state_dict({k: torch.ones_like(v) for k, v in conv.state_dict().items()})
    assert torch.equal(conv2d.packed_weight(conv), torch.ones(3, 3, 16, 32))
    conv.to(torch.bfloat16)                                                      # cast
    assert conv2d.packed_weight(conv).dtype == torch.bfloat16
    assert set(conv.state_dict()) == {"weight", "bias"}


# ------------------------------------------------------- the slice as a whole

TINY = UNetConfig(block_out_channels=(32, 64, 96, 96), attention_heads=4)
TINY_VAE = VAEConfig(block_out_channels=(16, 32, 32, 32), norm_num_groups=8)
T, H, W = 5, 64, 64
CONFIG = PipelineConfig(width=W, height=H, num_inference_steps=2, guidance_scale=3.5,
                        context=ContextConfig(frames=3, overlap=1))


def pipeline_inputs(seed):
    rng = np.random.default_rng(seed)
    h, w = H // 8, W // 8
    return (rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
            rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
            rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8),
            np.zeros((T, H, W, 3), np.uint8), np.zeros((T, H, W, 3), np.uint8),
            rng.normal(0, 0.1, (T, h, w, 2)).astype(np.float32),
            rng.normal(0, 1, (1, 5, 768)).astype(np.float32),
            rng.normal(0, 1, (T, h, w, 4)).astype(np.float32))


def test_row_major_pipeline_matches_jax_and_default(monkeypatch, jax_row_major):
    """One converted set of weights drives both configurations on both sides:
    the tiny video pipeline inside ``row_major()`` against the JAX pipeline
    built with the three switches patched, and against the port's default
    configuration. Both sides are seen to take the chain and the fused conv."""
    guidance = seeded(unet.GuidanceUNet(GuidanceUNetConfig(unet=TINY, use_man=True)), 0, 0.5)
    den_cfg = DenoisingUNetConfig(unet=TINY, motion=MotionModuleConfig(num_attention_heads=4))
    den = seeded(unet.DenoisingUNet(den_cfg), 1, 0.5)
    enc, dec = seeded(vae.Encoder(TINY_VAE), 2, 0.5), seeded(vae.Decoder(TINY_VAE), 3, 0.5)
    port = video.VideoPipeline(video.ModelBundle(guidance, den, enc, dec), CONFIG, device="cpu")
    jbundle = jvideo.ModelBundle(
        junet.GuidanceUNet(GuidanceUNetConfig(unet=TINY, use_man=True)),
        {"params": jconvert.convert_unet(guidance.state_dict(), with_man=True,
                                         with_conv_out=False)},
        junet.DenoisingUNet(den_cfg),
        {"params": jconvert.convert_unet(den.state_dict(), with_motion=True)},
        jvae.Encoder(TINY_VAE), {"params": jconvert.convert_vae_encoder(enc.state_dict())},
        jvae.Decoder(TINY_VAE), {"params": jconvert.convert_vae_decoder(dec.state_dict())},
    )
    args = pipeline_inputs(0)
    jlin = counting(monkeypatch, jlinear, "fused_linear")
    jconv = counting(monkeypatch, jconv2d, "conv3x3_fused")
    want = np.asarray(jvideo.VideoPipeline(jbundle, CONFIG)(*args, decode=False))
    assert jlin and jconv  # traced through the chain and the fused conv

    default = port(*args, decode=False)
    lin_calls = counting(monkeypatch, layers, "fused_linear")
    conv_calls = counting(monkeypatch, conv2d, "conv3x3_fused")
    with row_major():
        got = port(*args, decode=False)
    assert lin_calls and len(lin_calls) % 8 == 0 and conv_calls  # eight products a block
    assert got.dtype == torch.float32 and got.shape == (T, H // 8, W // 8, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.numpy(), default.numpy(), atol=1e-4, rtol=0)
    # outside the block the default routes are back: the same weights, no chain
    n_lin, n_conv = len(lin_calls), len(conv_calls)
    block = den.down_blocks[0].attentions[0]
    x = torch.zeros(1, 8, 8, 32)
    with torch.no_grad():
        block(x, None, ctx_kv=block.block.attn2.project_kv(torch.zeros(1, 5, 768)))
    assert (len(lin_calls), len(conv_calls)) == (n_lin, n_conv)
