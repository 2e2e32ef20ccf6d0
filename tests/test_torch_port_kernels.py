"""The port's kernels (attention K1-K4, K9, K13, GroupNorm K5, LayerNorm K6, GEGLU K15; the
row-major configuration's K7, K8, K10, K11 have their plain-vs-Pallas tests in
``test_torch_port_row_major.py`` and their dispatch, refusals and card tests
here): plain
versions against the JAX Pallas kernels (interpret mode, as
``tests/test_flash_attention.py`` and ``tests/test_group_norm.py`` run them),
the dispatch rule, and device-only dispatch (a CPU tensor never launches a
kernel).

The CUDA kernels themselves run only on a card: the ``cuda`` tests compare
each with its plain version there and skip on a machine without one. The
machine with the card has no JAX, so JAX is imported by a fixture, and the
card runs this file with ``--noconftest``:

    python -m pytest tests/test_torch_port_kernels.py -m cuda --noconftest -q
"""

import math
import types

import numpy as np
import pytest
import torch

from mikudance_tpu_torch.kernels import conv2d as pcv
from mikudance_tpu_torch.kernels import flash_attention as pfa
from mikudance_tpu_torch.kernels import geglu as pgg
from mikudance_tpu_torch.kernels import group_norm as pgn
from mikudance_tpu_torch.kernels import layer_norm as pln
from mikudance_tpu_torch.kernels import linear as plin
from mikudance_tpu_torch.kernels import row_major
from mikudance_tpu_torch.kernels import temporal_attention as pta
from mikudance_tpu_torch.models import layers as players

ATOL = RTOL = 2e-2  # kernel against dense, as tests/test_flash_attention.py
ALL_KERNELS = (pfa.K1, pfa.K2, pta.K3, pfa.K4, pgn.K5, pln.K6, plin.K7, pcv.K8, pfa.K9, pfa.K10,
               pfa.K11, pta.K13, pgg.K15)


def qkv(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.fixture
def jx():
    """The JAX package's Pallas entry points (run in interpret mode)."""
    pytest.importorskip("jax")
    import flax.linen as nn
    import jax.numpy as jnp

    import mikudance_tpu.kernels.flash_attention as fa
    from mikudance_tpu.kernels.temporal_attention import (temporal_attention_btpc,
                                                          temporal_attention_fused)
    from mikudance_tpu.kernels.group_norm import fused_group_norm
    from mikudance_tpu.kernels.layer_norm import fused_layer_norm
    from mikudance_tpu.models.layers import FusedLayerNorm, GEGLUFeedForward
    return types.SimpleNamespace(jnp=jnp, fa=fa, btpc=temporal_attention_btpc,
                                 fused=temporal_attention_fused,
                                 group_norm=fused_group_norm, layer_norm=fused_layer_norm,
                                 FusedLayerNorm=FusedLayerNorm, GEGLUFeedForward=GEGLUFeedForward,
                                 intercept_methods=nn.intercept_methods)


ROUTES = ("temporal_attention", "flash_attention_fullc", "flash_attention_wide",
          "flash_attention_resident", "small_sequence_attention", "cross_attention",
          "dot_product_attention", "flash_anchor_resident", "flash_anchor_stream",
          "flash_attention_fullc_t")


def check(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hd,heads,q_scale", [
    pytest.param(40, 4, 1.0, id="40-4"), pytest.param(80, 2, 1.0, id="80-2"),
    pytest.param(40, 3, 1.0, id="40-3"),                  # an odd number of heads of 40
    pytest.param(40, 4, 3.0, id="40-4-clamp"), pytest.param(80, 2, 3.0, id="80-2-clamp"),
    pytest.param(40, 3, 3.0, id="40-3-clamp"),
    pytest.param(160, 2, 1.0, id="160-2"),                # SD1.5's level 2 (1024^2 and up)
    pytest.param(160, 2, 3.0, id="160-2-clamp"),
    pytest.param(64, 2, 1.0, id="64-2"),                  # SDXL's levels 1 and 2
    pytest.param(64, 2, 3.0, id="64-2-clamp")])
def test_k1_plain_matches_pallas_fullc_nt(hd, heads, q_scale, jx):
    """K1's route on the CPU is ``anchored_attention_t``, what the TPU kernel
    computes: with q three times as large the +-100 clamp bites, and there the
    exact softmax (the old K1) is another function."""
    B, S, C = 2, 512, hd * heads
    q, k, v = qkv(hd + heads, (B, S, C), (B, S, C), (B, S, C))
    q *= q_scale
    want = jx.fa.flash_attention_fullc_nt(
        jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v), heads, 1.0 / np.sqrt(hd),
        q_block=128, k_block=128, interpret=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = pfa.flash_attention_fullc(tq, tk, tv, heads)
    check(got, want)
    torch.testing.assert_close(got, pfa.anchored_attention_t(tq, tk, tv, heads), rtol=0, atol=0)
    exact = pfa.dot_product_attention(tq, tk, tv, heads).numpy()
    want = np.asarray(want, np.float32)
    apart = np.linalg.norm(exact - want) / np.linalg.norm(want)
    bites = pfa.anchor_excursion(tq, tk, heads) > pfa.EXP_CLAMP
    assert bites == (q_scale > 1.0)
    if bites:
        assert apart > 0.1 and np.abs(exact - want).max() > 0.5
    else:
        assert apart < 2e-2


@pytest.mark.parametrize("hd,Skv", [(40, 257), (80, 257), (40, 77), (160, 257), (160, 512),
                                    (160, 77), (64, 257)])
def test_k2_plain_matches_pallas_cross(hd, Skv, jx):
    """257 CLIP tokens (a ragged key tile for the TPU kernel and a 16-key tail
    for the port's), 77 (a text context) and 512 (the most the cross route
    takes: two chunks of keys on the card at heads of 160), heads of 40, 80
    and 160, and SDXL's of 64."""
    B, S, heads = 2, 256, 4
    q, k, v = qkv(23 + hd + Skv, (B, S, heads * hd), (B, Skv, heads * hd), (B, Skv, heads * hd))
    want = jx.fa.flash_attention_cross(
        jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v), heads, 1.0 / np.sqrt(hd),
        q_block=128, interpret=True)
    check(pfa.cross_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), heads), want)


@pytest.mark.parametrize("hd", [40, 160])
def test_k10_plain_matches_pallas_fullc_resident_odd_heads(hd, jx, monkeypatch):
    """K10's plain version (``anchored_attention``) against
    ``flash_attention_fullc(interpret=True)`` on its resident branch with 3
    heads of 40 (the last head has no partner, and its 48-channel box on the
    card reaches past C) or of 160 (SD1.5's level 2)."""
    B, S, heads = 2, 256, 3
    q, k, v = qkv(31, *[(B, S, heads * hd)] * 3)
    monkeypatch.setattr(jx.fa, "_flash_kernel_fullc_stream", None)  # resident, or fail
    jq, jk, jv = (jx.jnp.asarray(a, jx.jnp.bfloat16) for a in (q, k, v))
    want = jx.fa.flash_attention_fullc(jq, jk, jv, heads, 1.0 / np.sqrt(hd), q_block=128,
                                       k_block=128, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    assert pfa.fullc_resident(S, heads * hd, heads)
    got = pfa.flash_anchor_resident(tq, tk, tv, heads)
    torch.testing.assert_close(got, pfa.anchored_attention(tq, tk, tv, heads), rtol=0, atol=0)
    check(got, want)


def test_k3_plain_matches_pallas_btpc(jx):
    B, T, P, heads, hd = 2, 16, 21, 4, 40  # P=21 exercises the TPU kernel's padding
    q, k, v = qkv(22, *[(B, T, P, heads * hd)] * 3)
    want = jx.btpc(jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v), heads,
                   rows_per_tile=128, interpret=True)
    check(pta.temporal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), heads), want)


def bf16_data(seed, shape):
    """q, k, v of N(0, 1) values that bf16 holds exactly (the kernels' inputs),
    in fp32, so that the Pallas bodies return their fp32 results unrounded."""
    return [torch.from_numpy(a).bfloat16().float() for a in qkv(seed, *[shape] * 3)]


def tie_rows(q, k, heads):
    """(B, T, P, heads): query rows with a normalised weight p / l within 2^-18
    (relative) of a bf16 rounding midpoint. There the last bit of exp2 (XLA
    computes exp(x ln 2), PyTorch exp2) or of a sum's order may round the
    weight the other way, and the row's output moves by a bf16 step of the
    weight times v."""
    B, T, P, C = q.shape
    hd = C // heads
    qh = (q.float() * (1.0 / np.sqrt(hd) * pta.LOG2E)).bfloat16().double()
    s = torch.einsum("btphd,bsphd->btphs", qh.reshape(B, T, P, heads, hd),
                     k.bfloat16().double().reshape(B, T, P, heads, hd))
    w = torch.softmax(s * np.log(2.0), dim=-1)
    mant, _ = torch.frexp(w)                       # w = mant * 2^e, mant in [0.5, 1)
    x = mant * 256                                 # w in bf16 steps: 8 significant bits
    near = (x - x.floor() - 0.5).abs() < x * 2.0 ** -18
    return near.any(-1)


def check_twin(got, want, ties, heads):
    """Within 1e-4 everywhere but the rows of ``ties``, which stay within a bf16
    step; at most a few percent of rows are such."""
    B, T, P, C = got.shape
    diff = (got - torch.from_numpy(np.array(want, np.float32))).abs()
    diff = diff.reshape(B, T, P, heads, C // heads).amax(-1)
    assert diff[~ties].max().item() <= 1e-4
    assert ties.float().mean().item() < 0.1
    assert not ties.any() or diff[ties].max().item() <= 1e-2


@pytest.mark.parametrize("B,T,P,heads,hd", [
    (2, 16, 21, 4, 40),   # P = 21 exercises the TPU kernel's padding
    (1, 30, 9, 2, 80), (1, 20, 16, 2, 160)])
def test_k3_rounded_twin_matches_pallas_btpc(B, T, P, heads, hd, jx):
    """``temporal_attention_rounded``, the kernels' plain version on the card,
    is the TPU body's function: q * scale * log2(e) and the normalised
    weights rounded to bf16. The CPU route (``temporal_attention_plain``, the
    JAX package's CPU math) is another function, more than 1e-3 away."""
    q, k, v = bf16_data(B * T + P + hd, (B, T, P, heads * hd))
    want = jx.btpc(*(jx.jnp.asarray(t.numpy()) for t in (q, k, v)), heads,
                   rows_per_tile=128, interpret=True)
    got = pta.temporal_attention_rounded(q, k, v, heads)
    assert got.dtype == torch.float32 and got.shape == q.shape
    check_twin(got, want, tie_rows(q, k, heads), heads)
    want = torch.from_numpy(np.array(want, np.float32))
    old = pta.temporal_attention_plain(q, k, v, heads)
    assert ((old - want).norm() / want.norm()).item() > 1e-3


@pytest.mark.parametrize("N,T,heads,hd", [(21, 16, 4, 40), (21, 32, 2, 160)])
def test_k13_rounded_twin_matches_pallas_fused(N, T, heads, hd, jx):
    """``small_sequence_attention_rounded`` is the (N, T, C) body's function;
    N = 21 exercises the TPU kernel's padding to whole tiles."""
    q, k, v = bf16_data(N + T + hd, (N, T, heads * hd))
    want = jx.fused(*(jx.jnp.asarray(t.numpy()) for t in (q, k, v)), heads, 128, True)
    got = pta.small_sequence_attention_rounded(q, k, v, heads)
    assert got.shape == q.shape
    check_twin(got[:, :, None], np.asarray(want)[:, :, None],
               tie_rows(q[:, :, None], k[:, :, None], heads), heads)
    want = torch.from_numpy(np.array(want, np.float32))
    old = pta.small_sequence_attention_plain(q, k, v, heads)
    assert ((old - want).norm() / want.norm()).item() > 1e-3


@pytest.mark.parametrize("hd", [128, 256])
def test_k4_plain_matches_pallas_streamed(hd, monkeypatch, jx):
    monkeypatch.setattr(jx.fa, "RESIDENT_KV_BYTES", 0)  # force _flash_kernel
    B, S = 2, 256
    q, k, v = qkv(hd, *[(B, S, hd)] * 3)
    want = jx.fa.flash_attention_padded(
        jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v), 1.0 / np.sqrt(hd),
        q_block=128, k_block=128, interpret=True)
    check(pfa.flash_attention_wide(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), 1), want)


@pytest.mark.parametrize("S,dtype", [(128, "float32"), (256, "float32"), (256, "bfloat16")])
def test_k9_plain_matches_pallas_resident(S, dtype, jx, monkeypatch):
    """Head width 512 as in the VAE; 2 * S * 512 * 2 bytes is far under the
    6 MB limit, so ``flash_attention_padded`` takes ``_flash_kernel_resident``
    (the streamed kernel is made unreachable to prove it). The TPU body casts
    q, k, v to bf16, hence the bf16 tolerance for fp32 inputs too."""
    hd, B = 512, 2
    assert pfa.resident_kv(S, hd) and pfa.resident_kv(3072, hd) and not pfa.resident_kv(3073, hd)
    assert pfa.RESIDENT_KV_BYTES == jx.fa.RESIDENT_KV_BYTES
    monkeypatch.setattr(jx.fa, "_flash_kernel", None)
    q, k, v = qkv(S, *[(B, S, hd)] * 3)
    jd = getattr(jx.jnp, dtype)
    want = jx.fa.flash_attention_padded(
        jx.jnp.asarray(q, jd), jx.jnp.asarray(k, jd), jx.jnp.asarray(v, jd), 1.0 / np.sqrt(hd),
        q_block=128, k_block=128, interpret=True)
    td = getattr(torch, dtype)
    got = pfa.flash_attention_resident(torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
                                       torch.from_numpy(v).to(td), 1)
    assert got.dtype == td
    check(got, want)


@pytest.mark.parametrize("T,C,dtype", [(8, 80, "float32"), (16, 320, "float32"),
                                       (30, 160, "float32"), (16, 320, "bfloat16")])
def test_k13_plain_matches_pallas_fused(T, C, dtype, jx):
    """N = 21 sequences exercise the TPU kernel's padding to whole tiles; its
    body rounds the scaled q and the weights to bf16 (2e-2 covers that)."""
    N, heads = 21, 4
    q, k, v = qkv(T + C, *[(N, T, C)] * 3)
    jd, td = getattr(jx.jnp, dtype), getattr(torch, dtype)
    want = jx.fused(jx.jnp.asarray(q, jd), jx.jnp.asarray(k, jd), jx.jnp.asarray(v, jd), heads,
                    128, True)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    got = pta.small_sequence_attention(tq, tk, tv, heads)
    assert got.dtype == td and got.shape == (N, T, C)
    check(got, want)
    # the same function as the general plain attention
    torch.testing.assert_close(got.float(), pfa.dot_product_attention(tq, tk, tv, heads).float(),
                               atol=1e-5 if dtype == "float32" else ATOL, rtol=0)


def norm_data(seed, shape):
    """Data with a per-channel offset and spread, and a random affine."""
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = rng.normal(size=shape) * rng.uniform(0.25, 4, C) + rng.uniform(-8, 8, C)
    return (x.astype(np.float32), rng.normal(size=C).astype(np.float32),
            rng.normal(size=C).astype(np.float32))


@pytest.mark.parametrize("shape,groups,silu,dtype,tol", [
    ((2, 8, 8, 32), 8, True, "float32", 1e-5),
    ((2, 8, 8, 32), 8, False, "float32", 1e-5),
    ((2, 8, 8, 32), 8, True, "bfloat16", 2e-2),
    ((1, 256, 4, 16), 4, True, "float32", 1e-5),    # one tall image
    ((2, 6, 10, 24), 4, False, "float32", 1e-5),    # 6 channels a group: not a power of two
    ((3, 4, 4, 80), 8, True, "bfloat16", 2e-2),     # 10 channels a group
])
def test_k5_plain_matches_pallas_group_norm(shape, groups, silu, dtype, tol, jx):
    x, w, b = norm_data(sum(shape), shape)
    want = jx.group_norm(jx.jnp.asarray(x, dtype), jx.jnp.asarray(w), jx.jnp.asarray(b),
                         groups, 1e-6, "silu" if silu else None, True)
    got = pgn.fused_group_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                               torch.from_numpy(w), torch.from_numpy(b), groups, 1e-6, silu)
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol * 10 if dtype == "float32" else tol, rtol=tol)


@pytest.mark.parametrize("shape,dtype,tol", [
    ((4, 16, 64), "float32", 1e-5),       # (B, S, C)
    ((2, 3, 8, 40), "float32", 1e-5),     # (B, T, P, C), the motion modules' layout
    ((4, 16, 64), "bfloat16", 2e-2),
])
def test_k6_plain_matches_pallas_layer_norm(shape, dtype, tol, jx):
    """Against the Pallas kernel (two-pass statistics) and against the JAX
    default path ``FusedLayerNorm`` (one-pass, what the plain version is)."""
    x, w, b = norm_data(sum(shape), shape)
    x += np.random.default_rng(1).uniform(-8, 8, shape[:-1] + (1,)).astype(np.float32)  # row means
    jnp = jx.jnp
    got = pln.fused_layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                               torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    kernel = jx.layer_norm(jnp.asarray(x, dtype), jnp.asarray(w), jnp.asarray(b), 1e-5, True)
    module = jx.FusedLayerNorm(shape[-1]).apply(
        {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}}, jnp.asarray(x, dtype))
    for want in (kernel, module):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol * 10 if dtype == "float32" else tol, rtol=tol)


def test_block_rule_matches_jax(jx):
    """The port's ``pick_blocks`` / ``_use_flash`` are the JAX package's: the
    same blocks and the same flash-or-dense decision for every S from 1 to
    12000."""
    for S in range(1, 12001):
        assert pfa.pick_blocks(S) == jx.fa.pick_blocks(S), S
        assert pfa._use_flash(S, S) == jx.fa._use_flash(S, S), S
    assert not pfa._use_flash(2304, 257) and not jx.fa._use_flash(2304, 257)
    assert pfa.TUNED_BLOCKS == jx.fa.TUNED_BLOCKS


def test_plain_chunking_is_exact(monkeypatch):
    """The plain versions' chunking over batch x heads and positions changes
    no value."""
    q, k, v = qkv(3, (2, 64, 32), (2, 64, 32), (2, 64, 32))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    whole = pfa.dot_product_attention(tq, tk, tv, 4)
    q4, k4, v4 = map(torch.from_numpy, qkv(4, *[(2, 8, 5, 32)] * 3))
    whole4 = pta.temporal_attention_plain(q4, k4, v4, 4)
    monkeypatch.setattr(pfa, "PLAIN_SCORE_BYTES", 64 * 64 * 4 * 3)  # chunks of 3 of 8
    monkeypatch.setattr(pta, "PLAIN_SCORE_BYTES", 2 * 4 * 8 * 8 * 4 * 2)  # 2 positions
    torch.testing.assert_close(pfa.dot_product_attention(tq, tk, tv, 4), whole, rtol=0, atol=0)
    torch.testing.assert_close(pta.temporal_attention_plain(q4, k4, v4, 4), whole4,
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape,heads,route", [
    (((2, 16, 9216, 320),) * 3, 8, "temporal_attention"),        # motion modules
    (((32, 9216, 320),) * 3, 8, "flash_attention_fullc"),         # level 0, hd 40
    (((32, 2304, 640),) * 3, 8, "flash_attention_fullc"),         # level 1, hd 80
    (((4, 9216, 512),) * 3, 1, "flash_attention_wide"),           # VAE mid-block, 768^2
    (((4, 4096, 512),) * 3, 1, "flash_attention_wide"),           # 512^2: K/V of 8 MB stream
    (((8, 3072, 512),) * 3, 1, "flash_attention_resident"),       # 512 x 384: 6 MB, resident
    (((8, 2304, 512),) * 3, 1, "flash_attention_resident"),       # 384^2
    (((8, 1024, 512),) * 3, 1, "flash_attention_resident"),       # 256^2
    (((2, 16384, 256),) * 3, 2, "flash_attention_wide"),          # 2 heads of 128: 8 MB a head
    (((2, 8192, 256),) * 3, 2, "flash_attention_resident"),       # 4 MB a head
    (((32, 9216, 320), (32, 257, 320), (32, 257, 320)), 8, "cross_attention"),
    (((32, 2304, 640), (32, 257, 640), (32, 257, 640)), 8, "cross_attention"),
    (((32, 576, 1280),) * 3, 8, "dot_product_attention"),         # level 2: plain
    (((32, 144, 1280), (32, 257, 1280), (32, 257, 1280)), 8, "dot_product_attention"),
    (((120, 16, 1280),) * 3, 8, "small_sequence_attention"),      # mid-block on a 4 x 4 map
    (((64, 32, 320),) * 3, 8, "small_sequence_attention"),        # B >= 64, S <= 32
    (((63, 16, 1280),) * 3, 8, "dot_product_attention"),          # a batch under 64
    (((64, 33, 320),) * 3, 8, "dot_product_attention"),           # more than 32 tokens
    (((64, 16, 320), (64, 257, 320), (64, 257, 320)), 8, "dot_product_attention"),
    (((1, 257, 1024),) * 3, 16, "dot_product_attention"),         # CLIP tower, 16 heads of 64
    # packed heads at other sizes: K1 under the default switches, never K10 / K11
    (((8, 1024, 320),) * 3, 8, "flash_attention_fullc"),          # 256^2, level 0
    (((8, 4096, 640),) * 3, 8, "flash_attention_fullc"),          # 1024^2, level 1
    # level 2, heads of 160: 1024 tokens at 1024^2, 1040 at 1280 x 832
    (((32, 1024, 1280),) * 3, 8, "flash_attention_fullc"),
    (((32, 1024, 1280), (32, 257, 1280), (32, 257, 1280)), 8, "cross_attention"),
    (((32, 1040, 1280),) * 3, 8, "flash_attention_fullc"),
    (((32, 1040, 1280), (32, 257, 1280), (32, 257, 1280)), 8, "cross_attention"),
    # the JAX block rule (pick_blocks / _use_flash): S = 34^2 = 1156 has no
    # block that is a multiple of 16, S = 1072 = 16 x 67 only q_block 16 < 64
    (((16, 1156, 320),) * 3, 8, "dot_product_attention"),         # 272^2, level 0
    (((8, 1156, 512),) * 3, 1, "dot_product_attention"),          # its VAE mid-block
    (((16, 1156, 320), (16, 257, 320), (16, 257, 320)), 8, "dot_product_attention"),
    (((16, 1072, 320),) * 3, 8, "dot_product_attention"),
    (((8, 1072, 512),) * 3, 1, "dot_product_attention"),
    (((16, 1072, 320), (16, 257, 320), (16, 257, 320)), 8, "dot_product_attention"),
    (((20, 5184, 320),) * 3, 8, "flash_attention_fullc"),         # 576^2 training, level 0
    (((20, 1296, 640),) * 3, 8, "flash_attention_fullc"),         # and level 1
    (((20, 5184, 320), (20, 257, 320), (20, 257, 320)), 8, "cross_attention"),
    (((4, 5184, 512),) * 3, 1, "flash_attention_wide"),           # its VAE mid-block
])
def test_dispatch_rule(shape, heads, route, monkeypatch):
    """``attention`` picks the route the JAX dispatcher picks for each shape
    class (checked on meta tensors: shapes only, no compute), under the
    default switches; ``test_dispatch_rule_with_the_fullc_switches`` has the
    other settings."""
    calls = []
    for name in ROUTES:
        monkeypatch.setattr(pfa, name, lambda *a, _n=name: calls.append(_n))
    pfa.attention(*[torch.empty(s, device="meta") for s in shape], heads)
    assert calls == [route]


BOTH_OFF = dict(TRANSPOSED_FULLC=False, NEUTRAL_FULLC=False)
TRANSPOSED = dict(TRANSPOSED_FULLC=True, NEUTRAL_FULLC=False)


@pytest.mark.parametrize("switches,shape,heads,route", [
    # both off, the row-major configuration: the JAX byte rule picks K10 or K11
    (BOTH_OFF, ((32, 9216, 320),) * 3, 8, "flash_anchor_stream"),      # level 0: K11
    (BOTH_OFF, ((32, 2304, 640),) * 3, 8, "flash_anchor_resident"),    # level 1: K10
    (BOTH_OFF, ((8, 1024, 320),) * 3, 8, "flash_anchor_resident"),     # 256^2, level 0
    (BOTH_OFF, ((8, 4096, 320),) * 3, 8, "flash_anchor_resident"),     # 512^2: 6.3 MB
    (BOTH_OFF, ((8, 4096, 640),) * 3, 8, "flash_anchor_stream"),       # 1024^2, level 1
    (BOTH_OFF, ((32, 1024, 1280),) * 3, 8, "flash_anchor_resident"),   # 1024^2, level 2
    # NEUTRAL_FULLC alone changes nothing while TRANSPOSED_FULLC is off
    (dict(TRANSPOSED_FULLC=False, NEUTRAL_FULLC=True), ((32, 9216, 320),) * 3, 8,
     "flash_anchor_stream"),
    # TRANSPOSED_FULLC alone (the transposed configuration): K10 under the
    # resident limit, K12 above it
    (TRANSPOSED, ((32, 2304, 640),) * 3, 8, "flash_anchor_resident"),
    (TRANSPOSED, ((32, 9216, 320),) * 3, 8, "flash_attention_fullc_t"),
    (TRANSPOSED, ((20, 5184, 320),) * 3, 8, "flash_attention_fullc_t"),  # 576^2 training, level 0
    (TRANSPOSED, ((20, 1296, 640),) * 3, 8, "flash_anchor_resident"),    # and level 1
    (TRANSPOSED, ((8, 4096, 640),) * 3, 8, "flash_attention_fullc_t"),   # 1024^2, level 1
    (TRANSPOSED, ((20, 1600, 1280),) * 3, 8, "flash_attention_fullc_t"),  # 1280^2, level 2
    (TRANSPOSED, ((20, 5184, 320), (20, 257, 320), (20, 257, 320)), 8, "cross_attention"),
    # every other route is untouched by the switches
    (BOTH_OFF, ((2, 16, 9216, 320),) * 3, 8, "temporal_attention"),
    (BOTH_OFF, ((4, 9216, 512),) * 3, 1, "flash_attention_wide"),
    (BOTH_OFF, ((8, 2304, 512),) * 3, 1, "flash_attention_resident"),
    (BOTH_OFF, ((32, 9216, 320), (32, 257, 320), (32, 257, 320)), 8, "cross_attention"),
    (BOTH_OFF, ((32, 576, 1280),) * 3, 8, "dot_product_attention"),
    (BOTH_OFF, ((120, 16, 1280),) * 3, 8, "small_sequence_attention"),
    # the defaults: K1, as before the switches existed
    ({}, ((32, 9216, 320),) * 3, 8, "flash_attention_fullc"),
    ({}, ((32, 2304, 640),) * 3, 8, "flash_attention_fullc"),
])
def test_dispatch_rule_with_the_fullc_switches(switches, shape, heads, route, monkeypatch):
    """The branch of the JAX ``_flash`` (``flash_attention.py:769-800``) for head
    widths that are no multiple of 128, under each setting of its two
    switches; on meta tensors (shapes only)."""
    assert pfa.TRANSPOSED_FULLC is True and pfa.NEUTRAL_FULLC is True  # the JAX defaults
    calls = []
    for name in ROUTES:
        monkeypatch.setattr(pfa, name, lambda *a, _n=name: calls.append(_n))
    for name, value in switches.items():
        monkeypatch.setattr(pfa, name, value)
    pfa.attention(*[torch.empty(s, device="meta") for s in shape], heads)
    assert calls == [route]


def test_transposed_sets_and_restores_the_switches():
    """``transposed()`` turns ``NEUTRAL_FULLC`` off for its block and puts both
    switches back, also when the block raises."""
    from mikudance_tpu_torch.kernels import transposed

    assert (pfa.TRANSPOSED_FULLC, pfa.NEUTRAL_FULLC) == (True, True)
    with transposed():
        assert (pfa.TRANSPOSED_FULLC, pfa.NEUTRAL_FULLC) == (True, False)
    with pytest.raises(KeyError):
        with transposed():
            raise KeyError("inside")
    assert (pfa.TRANSPOSED_FULLC, pfa.NEUTRAL_FULLC) == (True, True)


def test_row_major_sets_and_restores_the_switches():
    """``row_major()`` flips the four switches for its block and puts them
    back, also when the block raises; the defaults are the JAX package's."""
    def state():
        return (players.PALLAS_CHAIN, pcv.PREFER_PALLAS, pfa.TRANSPOSED_FULLC, pfa.NEUTRAL_FULLC)

    assert state() == (False, False, True, True)
    with row_major():
        assert state() == (True, True, False, False)
    assert state() == (False, False, True, True)
    with pytest.raises(KeyError):
        with row_major():
            raise KeyError("inside")
    assert state() == (False, False, True, True)
    pcv.PREFER_PALLAS = True  # a switch set by hand outlives a block, as it was
    try:
        with row_major():
            pass
        assert state() == (False, True, True, True)
    finally:
        pcv.PREFER_PALLAS = False


def test_cpu_tensors_never_launch():
    """Every route on CPU tensors is the plain math and launches nothing."""
    for kern in ALL_KERNELS:
        kern.launches = 0
    rng = np.random.default_rng(5)

    def r(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32))

    q, ctx = r(1, 1024, 16), r(1, 257, 16)
    for out, want in (
        (pfa.attention(q, q, q, 2), pfa.anchored_attention_t(q, q, q, 2)),           # K1 route
        (pfa.attention(q, ctx, ctx, 2), pfa.dot_product_attention(q, ctx, ctx, 2)),  # K2 route
        (pfa.attention(r(1, 1024, 128), *[r(1, 1024, 128)] * 2, 1), None),           # K9 route
        (pfa.flash_attention_wide(r(1, 64, 128), *[r(1, 64, 128)] * 2, 1), None),    # K4
        (pfa.attention(r(64, 8, 16), *[r(64, 8, 16)] * 2, 2), None),                 # K13 route
        (pfa.attention(r(1, 4, 6, 16), *[r(1, 4, 6, 16)] * 2, 2), None),             # K3 route
    ):
        if want is not None:
            torch.testing.assert_close(out, want, rtol=0, atol=0)
    x, w, b = r(2, 4, 4, 16), r(16), r(16)
    torch.testing.assert_close(pgn.fused_group_norm(x, w, b, 4, 1e-6, True),   # K5 route
                               pgn.group_norm_plain(x, w, b, 4, 1e-6, True), rtol=0, atol=0)
    torch.testing.assert_close(pln.fused_layer_norm(x, w, b, 1e-5),            # K6 route
                               pln.layer_norm_plain(x, w, b, 1e-5), rtol=0, atol=0)
    xr, wl, bl, res = r(6, 16), r(8, 16), r(8), r(6, 8)
    torch.testing.assert_close(plin.fused_linear(xr, wl, bl, res),             # K7 route
                               plin.linear_plain(xr, wl, bl, res), rtol=0, atol=0)
    xc, wc, bc = r(1, 4, 8, 32), r(8, 32, 3, 3), r(8)
    torch.testing.assert_close(pcv.conv3x3_fused(xc, wc, bc),                  # K8 route
                               pcv.conv3x3_plain(xc, wc, bc), rtol=0, atol=0)
    with row_major():                                                          # K10 / K11 routes
        torch.testing.assert_close(pfa.attention(q, q, q, 2),
                                   pfa.anchored_attention(q, q, q, 2), rtol=0, atol=0)
    for fn in (pfa.flash_anchor_resident, pfa.flash_anchor_stream):
        torch.testing.assert_close(fn(q, q, q, 2), pfa.anchored_attention(q, q, q, 2),
                                   rtol=0, atol=0)
    y = r(6, 32)
    torch.testing.assert_close(pgg.fused_geglu(y), pgg.geglu_plain(y),        # K15 route
                               rtol=0, atol=0)
    assert [kern.launches for kern in ALL_KERNELS] == [0] * len(ALL_KERNELS)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """Shape, dtype and layout checks run before any launch (meta tensors
    stand in for CUDA ones: the checks read only metadata)."""
    def m(*s, dtype=torch.bfloat16):
        return torch.empty(s, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="unsupported device"):
        pfa.flash_attention_fullc(m(1, 1024, 64), m(1, 1024, 64), m(1, 1024, 64), 2)
    for args, heads, dims, match in (
        ((m(1, 8, 64),) * 3, 3, pfa.PACKED_HEAD_DIMS, "head width"),
        ((m(1, 8, 48),) * 3, 1, pfa.PACKED_HEAD_DIMS, "head width"),  # no SD1.5 width
        ((m(1, 8, 384),) * 3, 1, pfa.WIDE_HEAD_DIMS, "head width"),
        ((m(1, 8, 64, dtype=torch.float16), m(1, 8, 64), m(1, 8, 64)), 2,
         pfa.PACKED_HEAD_DIMS, "bf16"),
        ((m(1, 8, 64), m(1, 8, 32), m(1, 8, 32)), 2, pfa.PACKED_HEAD_DIMS, "need q"),
        ((m(1, 8, 64), m(1, 8, 64).transpose(0, 1), m(1, 8, 64)), 2, pfa.PACKED_HEAD_DIMS,
         "need q"),
        ((m(2, 8, 64), m(2, 16, 32, 2)[..., 0], m(2, 16, 32, 2)[..., 0]), 2,
         pfa.PACKED_HEAD_DIMS, "need q"),
    ):
        with pytest.raises(ValueError, match=match):
            pfa._check_operands("k", *args, heads, dims)
    with pytest.raises(ValueError, match="contiguous"):
        x = m(1, 16, 64)[:, ::2]
        pfa._check_operands("k", x, x, x, 2, pfa.PACKED_HEAD_DIMS)
    for hd in (40, 80, 160):  # SD1.5's three levels, 8 heads each
        assert pfa._check_operands("k", *(m(2, 1024, 8 * hd),) * 3, 8, pfa.PACKED_HEAD_DIMS) == hd
    for heads in (10, 20):  # SDXL's levels 1 and 2: heads of 64
        assert pfa._check_operands("k", *(m(2, 1024, 64 * heads),) * 3, heads,
                                   pfa.PACKED_HEAD_DIMS) == 64
    with pytest.raises(ValueError, match="T <= 32"):
        x = torch.empty(1, 33, 4, 16, dtype=torch.bfloat16, device="meta")
        pta._check_operands(x, x, x, 2)
    # contiguous views that start off the kernels' load alignment
    flat = torch.empty(1 + 2 * 8 * 64, dtype=torch.bfloat16, device="meta")
    x = flat[1:].view(2, 8, 64)
    with pytest.raises(ValueError, match="16-byte"):
        pfa._check_operands("k", x, x, x, 2, pfa.PACKED_HEAD_DIMS)
    x = flat[1:].view(1, 2, 8, 64)
    with pytest.raises(ValueError, match="16-byte"):
        pta._check_operands(x, x, x, 2)


@pytest.mark.parametrize("case,match", [
    ("device", "unsupported device"), ("width", "head width"), ("cross", "S_kv == S"),
    ("long", "S_kv == S"), ("dtype", "bf16"), ("offset", "16-byte"),
])
def test_resident_wrapper_refuses_what_the_kernel_does_not_take(case, match, monkeypatch):
    """K9 takes heads of 512 over S <= 3072 self-attention tokens, bf16 or fp32 (not fp16),
    16-byte aligned (K4's kernel, cp.async's rule); anything else raises
    before a launch."""
    def m(*s, dtype=torch.bfloat16):
        return torch.empty(s, dtype=dtype, device="meta")

    q = k = v = m(2, 1024, 512)
    heads = 1
    if case == "width":
        q = k = v = m(2, 1024, 256)
    elif case == "cross":
        k = v = m(2, 512, 512)
    elif case == "long":
        q = k = v = m(1, 3088, 512)
    elif case == "dtype":
        q = m(2, 1024, 512, dtype=torch.float16)
    elif case == "offset":  # 8 bytes in: off the 16-byte rule of K4's and K9's row loads
        q = k = v = torch.empty(4 + 1024 * 512, dtype=torch.bfloat16,
                                device="meta")[4:].view(1, 1024, 512)
    if case != "device":  # let the meta tensors past the device check
        monkeypatch.setattr(pfa, "_check_cuda", lambda name, *a: pfa._check_operands(name, *a))
    launched = []
    monkeypatch.setattr(pfa, "_launch", lambda *a: launched.append(a))
    with pytest.raises(ValueError, match=match):
        pfa.flash_attention_resident(q, k, v, heads)
    assert not launched


@pytest.mark.parametrize("case,match", [
    ("shape", "share an"), ("frames", "T <= 32"), ("width", "head width"), ("dtype", "bf16"),
    ("view", "contiguous"), ("offset", "16-byte"),
    # K3, the other entry of K13's kernel: heads of 40, 80 or 160 only
    ("k3-width-32", "head width"), ("k3-width-64", "head width"), ("k3-width-48", "head width"),
    ("k3-frames", "T <= 32"), ("k3-no-frames", "T <= 32"), ("k3-offset", "16-byte"),
])
def test_small_sequence_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    def m(*s, dtype=torch.bfloat16):
        return torch.empty(s, dtype=dtype, device="meta")

    if case.startswith("k3"):
        q = k = v = m(2, 16, 24, 320)
        for hd in pta.SMALL_HEAD_DIMS:  # SD1.5's three levels, 8 heads each
            x = m(2, 16, 24, 8 * hd)
            pta._check_operands(x, x, x, 8)
        if case.startswith("k3-width"):
            q = k = v = m(2, 16, 24, 8 * int(case.split("-")[-1]))
        elif case == "k3-frames":
            q = k = v = m(2, 33, 24, 320)
        elif case == "k3-no-frames":
            q = k = v = m(2, 0, 24, 320)
        else:  # 8 bytes in: off the 16-byte rule of the kernel's row loads
            q = k = v = torch.empty(4 + 2 * 16 * 24 * 320, dtype=torch.bfloat16,
                                    device="meta")[4:].view(2, 16, 24, 320)
        with pytest.raises(ValueError, match=match):
            pta._check_operands(q, k, v, 8)
        return
    q = k = v = m(64, 16, 320)
    with pytest.raises(ValueError, match="unsupported device"):
        pta.small_sequence_attention(q, k, v, 8)
    if case == "shape":
        k = m(64, 8, 320)
    elif case == "frames":
        q = k = v = m(64, 33, 320)
    elif case == "width":
        q = k = v = m(64, 16, 384)  # heads of 48
    elif case == "dtype":
        q = k = v = m(64, 16, 320, dtype=torch.float16)
    elif case == "view":
        q = k = v = m(64, 16, 640)[..., :320]
    else:
        q = k = v = torch.empty(1 + 64 * 16 * 320, dtype=torch.bfloat16,
                                device="meta")[1:].view(64, 16, 320)
    with pytest.raises(ValueError, match=match):
        pta._check_small_operands(q, k, v, 8)


@pytest.mark.parametrize("fail", [None, "layer_norm.cu"])
def test_build_runs_one_compiler_per_source_then_links(fail, tmp_path, monkeypatch):
    """``_build.build`` with a stand-in compiler (a script that records its
    arguments): one ``-c`` process per ``csrc/*.cu`` for sm_90a, one link, the
    library and ptxas's report under the hashed name; a source that fails to
    compile raises with its name and leaves no library."""
    import os
    import stat

    from mikudance_tpu_torch.kernels import _build

    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {tmp_path}/calls\n'
        'for a in "$@"; do last="$a"; done\n'
        f'if [ -n "{fail or ""}" ] && [ "$(basename "$last")" = "{fail}" ]; then\n'
        '  echo "error in $last"; exit 1; fi\n'
        'while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then : > "$2"; fi; shift; done\n'
        'echo "ptxas info: ok"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(fake.parent.parent))
    monkeypatch.setenv("PATH", "/usr/bin:/bin")  # no real nvcc ahead of the stand-in
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert {"flash_cross.cu", "flash_anchor_wg.cu", "flash_wide.cu",
            "temporal_attention.cu", "group_norm.cu",
            "layer_norm.cu"} <= set(sources)
    if fail:
        with pytest.raises(RuntimeError, match=fail):
            _build.build()
        assert not list((tmp_path / "build").glob("*.so"))
        return
    lib = _build.build()
    assert lib == _build.library_path() and lib.exists() and lib.parent == tmp_path / "build"
    assert "ptxas info" in lib.with_suffix(".log").read_text()
    calls = (tmp_path / "calls").read_text().splitlines()
    compiles = [c for c in calls if " -c " in c]
    assert sorted(os.path.basename(c.split()[-1]) for c in compiles) == sources
    assert all("arch=compute_90a,code=sm_90a" in c for c in compiles)
    assert len(calls) == len(sources) + 1 and "-shared" in calls[-1]
    assert _build.build() == lib and len((tmp_path / "calls").read_text().splitlines()) == len(calls)
    for name in ("md_group_norm", "md_layer_norm", "md_flash_resident", "md_small_attention"):
        assert name in _build.SIGNATURES


def _meta(*s, dtype=torch.bfloat16):
    return torch.empty(s, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,match", [
    ("device", "unsupported device"), ("dtype", "bf16 or fp32"), ("view", "contiguous"),
    ("vector", "8-channel vector"), ("groups", "multiple of 3 groups"),
    ("offset", "16-byte"), ("weight", "weight must be"), ("bias dtype", "bias must be"),
    ("weight offset", "16-byte"), ("slab", "at most 256 vectors"),
    ("channels", "at most 16384 channels"),
])
def test_group_norm_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    """Checks run before any launch (meta tensors stand in for CUDA ones: the
    checks read only metadata); nothing falls back to the plain version. The
    kernel's vector loads of w and b want them 16-byte aligned; a slab (the
    smallest run of whole groups and whole vectors) is at most 256 vectors,
    and S holds a and b of at most 16384 channels in shared memory."""
    x, w, b, groups = _meta(2, 4, 4, 32), _meta(32), _meta(32), 4
    if case == "device":
        with pytest.raises(ValueError, match=match):
            pgn.fused_group_norm(x, w, b, groups, 1e-6)
        return
    if case == "dtype":
        x = _meta(2, 4, 4, 32, dtype=torch.float16)
    elif case == "view":
        x = _meta(2, 4, 4, 64).chunk(2, dim=-1)[0]
    elif case == "vector":
        x, w, b = _meta(2, 4, 4, 12), _meta(12), _meta(12)
    elif case == "groups":
        groups = 3
    elif case == "offset":
        x = _meta(1 + 2 * 4 * 4 * 32)[1:].view(2, 4, 4, 32)
    elif case == "weight":
        w = _meta(16)
    elif case == "weight offset":  # 2 bytes in: off the kernel's vector loads
        w = _meta(33)[1:]
    elif case == "slab":  # one group of 4096 channels: a slab of 512 vectors
        x, w, b, groups = _meta(1, 4, 4096), _meta(4096), _meta(4096), 1
    elif case == "channels":
        x, w, b = _meta(1, 4, 16392), _meta(16392), _meta(16392)
    else:
        b = _meta(32, dtype=torch.float32)
    with pytest.raises(ValueError, match=match):
        pgn._check_operands(x, w, b, groups)


@pytest.mark.parametrize("case,match", [
    ("device", "unsupported device"), ("dtype", "bf16 or fp32"), ("view", "contiguous"),
    ("odd", "multiple of the 8-value vector"), ("wide", "<= 1280"), ("offset", "16-byte"),
    ("weight", "weight must be"), ("even", "multiple of the 8-value vector"),
    ("weight offset", "16-byte"),
])
def test_layer_norm_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    """K6 moves rows, w and b as 16-byte vectors: the width a multiple of the
    vector (an even width that is not, 324, is refused), x, w and b 16-byte
    aligned; widths up to 1280."""
    x, w, b = _meta(2, 8, 64), _meta(64), _meta(64)
    if case == "device":
        with pytest.raises(ValueError, match=match):
            pln.fused_layer_norm(x, w, b)
        return
    if case == "dtype":
        x = _meta(2, 8, 64, dtype=torch.float64)
    elif case == "view":
        x = _meta(2, 8, 128).chunk(2, dim=-1)[0]
    elif case == "odd":
        x, w, b = _meta(2, 8, 63), _meta(63), _meta(63)
    elif case == "wide":
        x, w, b = _meta(2, 8, 2048), _meta(2048), _meta(2048)
    elif case == "offset":  # 8 bytes in: aligned to a pair, off the 16-byte vector
        x = _meta(4 + 2 * 8 * 64)[4:].view(2, 8, 64)
    elif case == "even":
        x, w, b = _meta(2, 8, 324), _meta(324), _meta(324)
    elif case == "weight offset":
        b = _meta(72)[8:]  # 16 bytes in: aligned
        pln._check_operands(x, w, b)
        b = _meta(68)[4:]
    else:
        w = _meta(32)
    with pytest.raises(ValueError, match=match):
        pln._check_operands(x, w, b)


def _geglu_expression(y: torch.Tensor) -> torch.Tensor:
    """The GEGLU as the port's models wrote it before K15."""
    hidden, gate = y.chunk(2, dim=-1)
    return hidden * torch.nn.functional.gelu(gate)


# aten ops that compute nothing: views, allocations, autograd's detach
NO_LAUNCH_OPS = ("aten.split.", "aten.empty_like.", "aten.detach.")


def _computing_ops(fn) -> list:
    """The aten ops ``fn()`` dispatches that compute (launch a kernel on a card)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Log() as log:
        fn()
    return sorted(op for op in log.ops if not op.startswith(NO_LAUNCH_OPS))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("half", [8, 40, 1280])
def test_k15_plain_matches_the_expression_jax_and_autograd(half, dtype, jx):
    """K15's CPU route (its plain version) equals the expression the models
    ran before, bit for bit; it matches the JAX package's GEGLU (its
    ``GEGLUFeedForward`` with the projection's output replaced by y, the
    activation read where the out projection takes it); the written-out
    backward equals autograd through the expression, both halves bit for bit,
    and computes with no more ops (four: two products, ``gelu_backward`` and
    the GELU it recomputes, against autograd's concatenation)."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(half)
    y = torch.from_numpy((rng.normal(size=(3, 5, 2 * half)) * 3).astype(np.float32)).to(dt)
    got = pgg.fused_geglu(y)
    assert got.dtype == dt and got.shape == (3, 5, half)
    assert torch.equal(got, _geglu_expression(y))

    seen = []

    def intercept(next_fun, args, kwargs, ctx):
        if ctx.method_name != "_mm":
            return next_fun(*args, **kwargs)
        if not seen:  # the projection: y in its place
            seen.append(None)
            return jx.jnp.asarray(y.float().numpy(), dtype=jx.jnp.dtype(dtype))
        seen.append(np.asarray(args[0], np.float32))
        return next_fun(*args, **kwargs)

    module = jx.GEGLUFeedForward(half // 4, dtype=jx.jnp.dtype(dtype))
    params = {"params": {"proj": {"kernel": np.zeros((half // 4, 2 * half), np.float32),
                                  "bias": np.zeros(2 * half, np.float32)},
                         "out": {"kernel": np.zeros((half, half // 4), np.float32),
                                 "bias": np.zeros(half // 4, np.float32)}}}
    with jx.intercept_methods(intercept):
        module.apply(params, np.zeros((3, 5, half // 4), np.float32))
    # XLA's erf against ATen's (2e-4 relative where the GELU is near 0); in
    # bf16, the GELU's and the product's roundings flipped (up to 2^-7 each)
    tol = (1e-3, 1e-5) if dtype == "float32" else (ATOL, RTOL)
    np.testing.assert_allclose(got.float().numpy(), seen[1], rtol=tol[0], atol=tol[1])

    g = torch.from_numpy(rng.normal(size=(3, 5, half)).astype(np.float32)).to(dt)
    ours, theirs = y.clone().requires_grad_(), y.clone().requires_grad_()
    out = pgg.fused_geglu(ours)
    assert out.grad_fn is not None
    ops_ours = _computing_ops(lambda: out.backward(g))
    out = _geglu_expression(theirs)
    ops_theirs = _computing_ops(lambda: out.backward(g))
    assert torch.equal(ours.grad, theirs.grad) and ours.grad.is_contiguous()
    assert len(ops_ours) <= len(ops_theirs) == 4, (ops_ours, ops_theirs)


@pytest.mark.parametrize("case,match", [
    ("device", "unsupported device"), ("dtype", "bf16 or fp32"), ("view", "contiguous"),
    ("odd", "twice a multiple of the 8-value vector"), ("vector", "twice a multiple"),
    ("offset", "16-byte"), ("vectors", "exceed"), ("bf16", None), ("fp32", None),
])
def test_geglu_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    """K15 moves 16-byte vectors of both halves: the width twice a multiple of
    the vector (odd, and 24 in bf16, whose halves of 12 are not whole
    vectors, are refused), y contiguous and 16-byte aligned, bf16 or fp32
    (fp16 raises), fewer than 2^31 output vectors; (rows, I) otherwise, in
    both dtypes (64 in fp32: halves of 8 whole vectors)."""
    y = _meta(2, 8, 64)
    if case == "device":
        with pytest.raises(ValueError, match=match):
            pgg.fused_geglu(y)
        return
    y = {"dtype": _meta(2, 8, 64, dtype=torch.float16),
         "view": _meta(2, 8, 128)[..., :64],
         "odd": _meta(2, 8, 63),
         "vector": _meta(2, 8, 24),
         "offset": _meta(4 + 2 * 8 * 64)[4:].view(2, 8, 64),
         "vectors": _meta(2**28, 128),
         "fp32": _meta(2, 8, 64, dtype=torch.float32)}.get(case, y)
    if match is None:
        assert pgg._check_operand(y) == (16, 32)
        return
    with pytest.raises(ValueError, match=match):
        pgg._check_operand(y)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# case -> (x shape, x dtype, w / b dtype, K5's variant and cluster size: S is
# 0; (16, 0): 16 where the card schedules it, else S)
NORM_CASES = {
    "K5-silu": ((3, 24, 24, 320), torch.bfloat16, torch.float32, (2,)),
    "K5-tall-n1": ((1, 4100, 16, 128), torch.bfloat16, torch.float32, (16, 8)),
    "K5-fp32": ((2, 9, 9, 960), torch.float32, torch.float32, (1,)),
    "K5-R16-level0": ((2, 96, 96, 320), torch.bfloat16, torch.float32, (16, 8)),
    "K5-R16-960": ((2, 96, 96, 960), torch.bfloat16, torch.float32, (16, 0)),  # groups of 30
    "K5-ragged-rows": ((2, 49, 49, 320), torch.bfloat16, torch.float32, (8,)),  # 2401 rows
    "K5-bf16-params": ((2, 48, 48, 640), torch.bfloat16, torch.bfloat16, (8,)),
    "K5-S-silu": ((2, 512, 512, 128), torch.bfloat16, torch.float32, (0,)),
    "K5-S-fp32": ((1, 1024, 1024, 64), torch.float32, torch.float32, (0,)),
    "K6-320": ((2, 16, 33, 320), torch.bfloat16, torch.float32, None),
    "K6-1024": ((1, 257, 1024), torch.bfloat16, torch.float32, None),
    "K6-fp32": ((5, 7, 640), torch.float32, torch.float32, None),
    "K6-640": ((3, 100, 640), torch.bfloat16, torch.float32, None),
    "K6-1280": ((2, 77, 1280), torch.bfloat16, torch.float32, None),
    "K6-fp32-1280": ((3, 50, 1280), torch.float32, torch.float32, None),
    "K6-bf16-params": ((2, 33, 320), torch.bfloat16, torch.bfloat16, None),
    "K6-masked-960": ((4, 9, 960), torch.bfloat16, torch.float32, None),  # 32 lanes, a tail
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(NORM_CASES))
def test_norm_kernel_matches_plain_on_card(case, cuda):
    """K5 in each variant and cluster size it takes, K6 at each lane plan,
    against the plain versions; the same bits on a second run."""
    g = torch.Generator(device=cuda).manual_seed(0)
    shape, dtype, wdtype, clusters = NORM_CASES[case]
    C = shape[-1]
    x = (torch.randn(shape, generator=g, device=cuda) * (torch.rand(C, generator=g, device=cuda)
                                                         * 3.75 + 0.25)
         + torch.rand(C, generator=g, device=cuda) * 16 - 8)
    if case.startswith("K6"):  # row means away from zero
        x += torch.rand(shape[:-1] + (1,), generator=g, device=cuda) * 16 - 8
    x = x.to(dtype)
    w, b = (torch.randn(C, generator=g, device=cuda).to(wdtype) for _ in range(2))
    if case.startswith("K5"):
        silu = "silu" in case
        kern, got = pgn.K5, lambda: pgn.fused_group_norm(x, w, b, 32, 1e-6, silu)
        want = pgn.group_norm_plain(x, w, b, 32, 1e-6, silu)
        plan, held = pgn.plan_for(x.device.index, shape[0], math.prod(shape[1:-1]), C, 32,
                                  dtype == torch.float32, wdtype == torch.float32, silu)
        assert (plan.cluster if held else 0) in clusters, (plan, held)
    else:
        kern, got = pln.K6, lambda: pln.fused_layer_norm(x, w, b, 1e-5)
        want = pln.layer_norm_plain(x, w, b, 1e-5)
    before = kern.launches
    out = got()
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else ATOL
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(out, got())  # no atomics: the same bits every run


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["K1-hd40", "K1-hd80", "K1-hd40-3-heads", "K1-clamp-hd40",
                                  "K1-clamp-hd80", "K1-hd160", "K1-clamp-hd160", "K1-hd64",
                                  "K1-clamp-hd64", "K1-hd64-20-heads", "K2", "K2-hd80",
                                  "K2-hd64", "K2-hd64-20-heads",
                                  "K2-ragged", "K2-77-keys", "K2-512-keys", "K2-hd160",
                                  "K2-hd160-77-keys", "K2-hd160-512-keys", "K3", "K3-one-frame",
                                  "K3-30-frames", "K3-20-frames", "K3-32-frames-hd40",
                                  "K3-32-frames-hd160", "K3-hd160", "K4", "K4-5184", "K9",
                                  "K9-ragged", "K9-two-heads", "K9-3072", "K13-hd40",
                                  "K13-hd80", "K13-hd160-30-tokens", "K13-one-token",
                                  "K13-20-tokens", "K13-hd160-32-tokens"])
def test_kernel_matches_plain_on_card(case, cuda):
    g = torch.Generator(device=cuda).manual_seed(0)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=cuda) * scale).to(torch.bfloat16)

    kern = case.split("-")[0]
    if kern == "K1":  # K1 is held to the TPU kernel's function, the clamp included
        hd = 40 if "hd40" in case else 160 if "hd160" in case else 64 if "hd64" in case else 80
        heads = 3 if case.endswith("3-heads") else 20 if case.endswith("20-heads") else \
            10 if hd == 64 else 8  # SDXL: 10 heads of 64 at 640 channels, 20 at 1280
        args, fn, plain = [r(2, 1100, heads * hd, scale=3.0 if "clamp" in case else 1.0),
                           r(2, 1100, heads * hd), r(2, 1100, heads * hd), heads], \
            pfa.flash_attention_fullc, pfa.anchored_attention_t
        bites = pfa.anchor_excursion(args[0], args[1], heads) > pfa.EXP_CLAMP
        assert bites == ("clamp" in case)
    elif kern == "K2":  # the CLIP context, a text context, the most keys K2 holds
        C = 640 if case in ("K2-hd80", "K2-hd64") else 1280 if "hd160" in case or \
            "20-heads" in case else 320
        S = 1091 if case == "K2-ragged" else 1100
        S_kv = 77 if case.endswith("77-keys") else 512 if case.endswith("512-keys") else 257
        heads = C // 64 if "hd64" in case else 8
        args, fn, plain = [r(2, S, C), r(2, S_kv, C), r(2, S_kv, C), heads], \
            pfa.cross_attention, pfa.dot_product_attention
    elif kern == "K3":  # one frame: a motion-module denoiser at T = 1; K3 computes the
        # TPU body's function (q' and P rounded to bf16), temporal_attention_rounded
        frames = {"K3-one-frame": 1, "K3-30-frames": 30, "K3-20-frames": 20}.get(case, 16)
        frames = 32 if "32-frames" in case else frames
        C = 1280 if "hd160" in case else 320 if "hd40" in case else 640
        args, fn, plain = [r(2, frames, 301, C) for _ in range(3)] + [8], \
            pta.temporal_attention, pta.temporal_attention_rounded
    elif kern == "K9":  # ragged: 1155 = 72 * 16 + 3 keys, the tail tile masked
        S, heads = {"K9": (1024, 1), "K9-ragged": (1155, 1), "K9-two-heads": (1040, 2),
                    "K9-3072": (3072, 1)}[case]
        args, fn, plain = [r(2, S, 512 * heads) for _ in range(3)] + [heads], \
            pfa.flash_attention_resident, pfa.dot_product_attention
    elif kern == "K13":
        N, T, C = {"K13-hd40": (70, 16, 320), "K13-hd80": (65, 32, 640),
                   "K13-hd160-30-tokens": (64, 30, 1280), "K13-one-token": (64, 1, 320),
                   "K13-20-tokens": (67, 20, 640), "K13-hd160-32-tokens": (64, 32, 1280)}[case]
        args, fn, plain = [r(N, T, C) for _ in range(3)] + [8], \
            pta.small_sequence_attention, pta.small_sequence_attention_rounded
    else:  # 5184: the VAE mid-block at 576^2, four pictures of a training batch
        S = 5184 if case == "K4-5184" else 1100
        args, fn, plain = [r(2, S, 512) for _ in range(3)] + [1], \
            pfa.flash_attention_wide, pfa.dot_product_attention
    got = fn(*args)
    torch.cuda.synchronize()
    want = plain(*args).float()
    torch.testing.assert_close(got.float(), want, atol=ATOL, rtol=RTOL)
    # N(0, 1) inputs give small outputs (a flat softmax): the relative distance
    # is what a wrong kernel cannot pass
    assert ((got.float() - want).norm() / want.norm()).item() < 1e-2
    if kern in ("K3", "K13"):  # the same function as the twin, up to exp2's last bit
        assert ((got.float() - want).norm() / want.norm()).item() < 1e-3


# ------------------------- the row-major configuration's kernels: refusals, card

@pytest.mark.parametrize("case,match", [
    ("device", "unsupported device"), ("dtype", "bf16"), ("width", "head width"),
    ("many-keys", "S_kv = 513"), ("no-keys", "S_kv = 0"), ("fits", None), ("fits-160", None),
])
def test_cross_wrapper_refuses_what_the_kernel_does_not_take(case, match, monkeypatch):
    """K2 takes bf16 or fp32 heads of 40, 80 or 160 against 1 to 512 keys; anything
    else raises before a launch. ``match`` None: the 512 keys are taken, also
    at heads of 160."""
    q, k = _meta(2, 1024, 320), _meta(2, 257, 320)
    if case == "dtype":
        q = _meta(2, 1024, 320, dtype=torch.float16)
    elif case == "width":
        q, k = _meta(2, 1024, 384), _meta(2, 257, 384)  # heads of 48
    elif case == "many-keys":
        k = _meta(2, 513, 320)
    elif case == "no-keys":
        k = _meta(2, 0, 320)
    elif case == "fits":
        k = _meta(2, 512, 320)
    elif case == "fits-160":
        q, k = _meta(2, 1024, 1280), _meta(2, 512, 1280)
    if case != "device":  # let the meta tensors past the device check
        monkeypatch.setattr(pfa, "_check_cuda", lambda name, *a: pfa._check_operands(name, *a))
    launched = []
    monkeypatch.setattr(pfa, "_launch", lambda *a: launched.append(a))
    if match is None:
        pfa.cross_attention(q, k, k, 8)
        assert len(launched) == 1 and launched[0][-4:] == (1024, 512, 8, q.shape[-1] // 8)
        return
    with pytest.raises(ValueError, match=match):
        pfa.cross_attention(q, k, k, 8)
    assert not launched


@pytest.mark.parametrize("case,match", [
    ("device", "unsupported device"), ("dtype", "bf16"), ("width", "multiples of the 8"),
    ("weight", "need x"), ("view", "contiguous"), ("residual", "residual must be"),
    ("offset", "16-byte"), ("bias", "bias must be"),
])
def test_linear_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    """K7 takes contiguous, 16-byte aligned bf16 rows with Cin and Cout
    multiples of 8; checks run before any launch, on meta tensors."""
    x, w, b, r = _meta(4, 6, 32), _meta(16, 32), _meta(16), _meta(4, 6, 16)
    if case == "device":
        with pytest.raises(ValueError, match=match):
            plin.fused_linear(x, w, b, r)
        return
    if case == "dtype":
        x = _meta(4, 6, 32, dtype=torch.float32)
    elif case == "width":
        x, w = _meta(4, 6, 12), _meta(16, 12)
    elif case == "weight":
        w = _meta(32, 16)
    elif case == "view":
        x = _meta(4, 6, 64)[..., :32]
    elif case == "residual":
        r = _meta(4, 6, 8)
    elif case == "offset":
        x = _meta(1 + 4 * 6 * 32)[1:].view(4, 6, 32)
    else:
        b = _meta(16, dtype=torch.float16)
    with pytest.raises(ValueError, match=match):
        plin._check_operands(x, w, b, r)


@pytest.mark.parametrize("case,match", [
    ("device", "unsupported device"), ("dtype", "bf16"), ("cin", "multiple of the 8"),
    ("weight", "need x"), ("view", "contiguous"), ("packed", "packed weight"),
    ("bias", "bias must be"),
])
def test_conv_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    x, w, b = _meta(2, 4, 8, 32), _meta(16, 32, 3, 3), _meta(16)
    packed = _meta(3, 3, 16, 32)
    if case == "device":
        with pytest.raises(ValueError, match=match):
            pcv.conv3x3_fused(x, w, b)
        return
    if case == "dtype":
        x = _meta(2, 4, 8, 32, dtype=torch.float32)
    elif case == "cin":
        x, w, packed = _meta(2, 4, 8, 36), _meta(16, 36, 3, 3), _meta(3, 3, 16, 36)
    elif case == "weight":
        w = _meta(16, 32, 1, 1)
    elif case == "view":
        x = _meta(2, 32, 4, 8).permute(0, 2, 3, 1)  # NCHW memory under an NHWC shape
    elif case == "packed":
        packed = _meta(16, 32, 3, 3)
    else:
        b = _meta(8)
    with pytest.raises(ValueError, match=match):
        pcv._check_operands(x, w, b, packed)


@pytest.mark.parametrize("fn,case,match", [
    ("flash_anchor_resident", "device", "unsupported device"),
    ("flash_anchor_resident", "width", "head width"),
    ("flash_anchor_resident", "cross", "S_kv == S"),
    ("flash_anchor_resident", "odd-heads", None),  # taken: the last head of 40 is staged
    ("flash_anchor_resident", "offset", "16-byte"),
    ("flash_anchor_resident", "offset-16", None),  # TMA's rule: 16 bytes suffice
    ("flash_anchor_resident", "dtype", "bf16"),
    ("flash_anchor_stream", "device", "unsupported device"),
    ("flash_anchor_stream", "dtype", "bf16"),
    ("flash_anchor_stream", "cross", "S_kv == S"),
    ("flash_anchor_stream", "offset", "16-byte"),
    ("flash_anchor_stream", "offset-16", None),
    ("flash_anchor_stream", "odd-heads", None),
    ("flash_attention_fullc_t", "device", "unsupported device"),
    ("flash_attention_fullc_t", "dtype", "bf16"),
    ("flash_attention_fullc_t", "cross", "S_kv == S"),
    ("flash_attention_fullc_t", "offset", "16-byte"),
    ("flash_attention_fullc_t", "offset-16", None),
    ("flash_attention_fullc_t", "odd-heads", None),
])
def test_anchored_wrappers_refuse_what_the_kernels_do_not_take(fn, case, match, monkeypatch):
    """K10, K11 and K12 (one kernel under three entry points) take bf16 or
    fp32 (not fp16) self-attention at head widths 40 and 80, any head count, on a 16-byte
    aligned base and row stride (TMA's rule for the K/V copies). ``match``
    None: the wrapper takes the operands and launches."""
    q = k = v = _meta(2, 1024, 320)
    heads = 8
    if case == "width":
        q = k = v = _meta(2, 1024, 384)  # heads of 48
    elif case == "cross":
        k = v = _meta(2, 512, 320)
    elif case == "odd-heads":
        q = k = v = _meta(2, 1024, 120)
        heads = 3
    elif case == "offset":
        q = k = v = _meta(1 + 1024 * 320)[1:].view(1, 1024, 320)
    elif case == "offset-16":
        q = k = v = _meta(8 + 1024 * 320)[8:].view(1, 1024, 320)
    elif case == "dtype":
        q = _meta(2, 1024, 320, dtype=torch.float16)
    if case != "device":  # let the meta tensors past the device check
        monkeypatch.setattr(pfa, "_check_cuda", lambda name, *a: pfa._check_operands(name, *a))
    launched = []
    monkeypatch.setattr(pfa, "_launch", lambda *a: launched.append(a))
    if match is None:
        getattr(pfa, fn)(q, k, v, heads)
        assert len(launched) == 1 and launched[0][-2:] == (heads, 40)
        return
    with pytest.raises(ValueError, match=match):
        getattr(pfa, fn)(q, k, v, heads)
    assert not launched


@pytest.mark.parametrize("kern", ["K3", "K13"])
def test_short_attention_kernels_share_one_source_under_two_entry_points(kern):
    """K3 and K13 build from ``csrc/temporal_attention.cu``, each under its own
    C entry point (tag 3 or 13: its own counter and device symbol), which no
    other source defines."""
    from mikudance_tpu_torch.kernels import _build

    kernel = getattr(pta, kern)
    assert kernel.source == "mikudance_tpu_torch/csrc/temporal_attention.cu"
    assert kernel.symbol in _build.SIGNATURES and pta.K3.symbol != pta.K13.symbol
    text = (_build.CSRC / "temporal_attention.cu").read_text()
    body = text[text.index(f"int {kernel.symbol}("):]
    assert f"dispatch<{kern[1:]}>" in body[:body.index("\n}")]
    defining = [p.name for p in _build.CSRC.glob("*.cu")
                if f"int {kernel.symbol}(" in p.read_text()]
    assert defining == ["temporal_attention.cu"]


@pytest.mark.parametrize("outer,seqs,T,hd,want", [
    (2, 9216, 16, 40, (2, 8, 8)),    # K3 at level 0 (768^2): 9216 tiles of 2 positions
    (2, 2304, 16, 80, (2, 4, 8)),
    (2, 576, 16, 160, (2, 2, 4)),
    (2, 144, 16, 160, (2, 2, 4)),    # 576 tiles
    (1, 9216, 30, 40, (1, 8, 8)),    # a 30-frame window: two row tiles a sequence
    (1, 5184, 20, 40, (1, 8, 8)),    # request F's 20 frames
    (1, 576, 32, 160, (1, 2, 4)),
    (1, 120, 16, 160, (1, 2, 4)),    # K13 on request D: 480 tiles
    (1, 64, 32, 40, (1, 1, 4)),      # K13's smallest: 64 sequences, 512 tiles
    (1, 64, 1, 40, (1, 1, 4)),
])
def test_tile_plan_fills_the_card_within_the_kernels_limits(outer, seqs, T, hd, want):
    """The tile plan of K3 and K13 (132 SMs, 8 heads): whole sequences of at
    most 32 padded rows by heads of at most 320 channels that divide the head
    count, fewer sequences and then fewer heads until the grid has two blocks
    an SM, or one sequence and one head a tile; 8 warps where a tile has 8 row
    tiles of (sequence, head) pairs, else 4."""
    ns, gh, warps = pta.tile_plan(outer, seqs, T, 8, hd, 132)
    assert (ns, gh, warps) == want
    rows = ns * (16 if T <= 16 else 32)
    assert rows <= pta.TILE_ROWS and gh * hd <= pta.GROUP_CHANNELS and 8 % gh == 0
    blocks = -(-seqs // ns) * (8 // gh) * outer
    assert blocks >= 2 * 132 or (ns, gh) == (1, 1)
    assert 3 * rows * (gh * hd + 8) * 2 <= 3 * 32 * 328 * 2  # the kernel's shared memory
    assert warps * 32 <= 256


@pytest.mark.parametrize("kern", ["K10", "K11", "K12", "K1"])
def test_anchored_kernels_share_one_source_under_three_entry_points(kern):
    """K10, K11 and K12, and K1 as a fourth entry point (tag 1, K12's
    function), build from ``csrc/flash_anchor_wg.cu``, each under its own C
    entry point (and so its own counter and device symbol), which no other
    source defines."""
    from mikudance_tpu_torch.kernels import _build

    kernel = getattr(pfa, kern)
    assert kernel.source == "mikudance_tpu_torch/csrc/flash_anchor_wg.cu"
    symbols = {k.symbol for k in (pfa.K1, pfa.K10, pfa.K11, pfa.K12)}
    assert len(symbols) == 4 and kernel.symbol in _build.SIGNATURES
    assert _build.SIGNATURES[kernel.symbol] == _build.SIGNATURES["md_flash_anchor_resident"]
    tag = kern[1:]
    text = (_build.CSRC / "flash_anchor_wg.cu").read_text()
    body = text[text.index(f"int {kernel.symbol}("):]
    assert f"dispatch<{tag}>" in body[:body.index("}")]
    defining = [p.name for p in _build.CSRC.glob("*.cu")
                if f"int {kernel.symbol}(" in p.read_text()]
    assert defining == ["flash_anchor_wg.cu"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "K7-bias", "K7-residual-ragged", "K7-plain", "K7-fp32-bias-wide", "K7-tile128-residual",
    "K7-tile160", "K7-cin32", "K8-320", "K8-w24-to-4", "K8-cin2560", "K8-one-row",
    "K8-w96-to-480", "K8-w8-cin200-to-1280", "K8-w64-to-136", "K8-w24-cin32-to-512", "K10-hd40", "K10-hd80", "K10-ragged", "K10-clamp",
    "K10-hd40-3-heads", "K10-hd40-3-heads-ragged", "K10-1296-hd80", "K11-hd40",
    "K11-hd80", "K11-ragged", "K11-clamp", "K12-hd40", "K12-hd80", "K12-ragged", "K12-clamp",
    "K11-9216-vs-K10", "K12-vs-K1", "K12-hd40-3-heads", "K10-hd160", "K10-hd160-ragged",
    "K11-hd160", "K12-hd160", "K12-clamp-hd160", "K12-vs-K1-hd160", "K10-hd64", "K11-hd64",
    "K12-hd64", "K12-vs-K1-hd64"])
def test_row_major_kernel_matches_plain_on_card(case, cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    twin = None  # another kernel of the same function, held to this one on the same inputs

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=cuda) * scale).to(torch.bfloat16)

    kern = case.split("-")[0]
    if kern == "K7":
        # (rows, Cin, Cout) and the tile width _gemm_plan.column_tile gives:
        # 320 ("plain": 133 row tiles, the last ragged; "bias",
        # "residual-ragged", "fp32-bias-wide"), 256 ("cin32"), 160
        # ("tile160") and 128 masked ("tile128-residual": the second column
        # tile holds 8 columns); Cin 32 under one k block of 64, Cin 200 not
        # a multiple of it
        rows, cin, cout = {"K7-bias": (515, 320, 640), "K7-residual-ragged": (4321, 640, 320),
                           "K7-plain": (17000, 1280, 1280),
                           "K7-fp32-bias-wide": (200, 320, 10240),
                           "K7-tile128-residual": (1000, 200, 136),
                           "K7-tile160": (515, 320, 480), "K7-cin32": (17000, 32, 768)}[case]
        x, w = r(rows, cin), r(cout, cin, scale=cin ** -0.5)
        b = None if case == "K7-plain" else r(cout)
        if case == "K7-fp32-bias-wide":
            b = b.float()
        res = r(rows, cout) if "residual" in case else None
        counter, got = plin.K7, lambda: plin.fused_linear(x, w, b, res)
        want = plin.linear_plain(x, w, b, res)
    elif kern == "K8":
        # boxes of Wb x Hb pixels x Nb images (_gemm_plan.tile_plan): 8 x 16
        # x 1 (W 24, "320", "w24-to-4"; W 8, "cin2560"), 32 x 4 x 1 (W 96),
        # 64 x 2 x 1 (W 64), each with H off a multiple of Hb; 8 x 2 x 8
        # ("w8-cin200", "one-row") and 8 x 4 x 4 ("w24-cin32") span images. N > 1 almost throughout, so boxes at an
        # image's border read zeros, not the next image. Tile widths 320
        # ("w8-cin200", "320"), 256 ("w24-cin32"), 160 ("w96") and 128; Cout
        # 4 is stored element by element.
        shape, cout = {"K8-320": ((3, 24, 24, 320), 320), "K8-w24-to-4": ((2, 10, 24, 64), 4),
                       "K8-cin2560": ((1, 8, 8, 2560), 136), "K8-one-row": ((5, 1, 8, 32), 48),
                       "K8-w96-to-480": ((3, 19, 96, 64), 480),
                       "K8-w8-cin200-to-1280": ((24, 21, 8, 200), 1280),
                       "K8-w64-to-136": ((3, 5, 64, 96), 136),
                       "K8-w24-cin32-to-512": ((40, 20, 24, 32), 512)}[case]
        x, w, b = r(*shape), r(cout, shape[-1], 3, 3, scale=(9 * shape[-1]) ** -0.5), r(cout)
        counter, got = pcv.K8, lambda: pcv.conv3x3_fused(x, w, b)
        want = pcv.conv3x3_plain(x, w, b)
    else:
        hd = 80 if case.endswith("hd80") else 160 if "hd160" in case else \
            64 if "hd64" in case else 40
        S = 1091 if case.endswith("ragged") else 1152
        B = 20 if "1296" in case else 2  # the transposed trainer's level 1
        S = 1296 if "1296" in case else S
        if "9216" in case:  # the row-major level 0, where K11 runs
            B, S = 32, 9216
        # an odd count: the last head of 40 is alone; SDXL: 10 heads of 64 at level 1
        heads = 3 if "3-heads" in case else 10 if hd == 64 else 8
        C = heads * hd
        q, k, v = r(B, S, C, scale=3.0 if "clamp" in case else 1.0), r(B, S, C), r(B, S, C)
        fn, counter = {"K10": (pfa.flash_anchor_resident, pfa.K10),
                       "K11": (pfa.flash_anchor_stream, pfa.K11),
                       "K12": (pfa.flash_attention_fullc_t, pfa.K12)}[kern]
        got = lambda: fn(q, k, v, heads)  # noqa: E731
        want = (pfa.anchored_attention_t if kern == "K12" else pfa.anchored_attention)(q, k, v,
                                                                                       heads)
        assert (pfa.anchor_excursion(q, k, heads) > pfa.EXP_CLAMP) == ("clamp" in case)
        twin = {"K11-9216-vs-K10": pfa.flash_anchor_resident,
                "K12-vs-K1": pfa.flash_attention_fullc,
                "K12-vs-K1-hd160": pfa.flash_attention_fullc,
                "K12-vs-K1-hd64": pfa.flash_attention_fullc}.get(case)
    before = counter.launches
    out = got()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    torch.testing.assert_close(out.float(), want.float(), atol=ATOL, rtol=RTOL)
    assert ((out.float() - want.float()).norm() / want.float().norm()).item() < 1e-2
    assert torch.equal(out, got())  # no atomics: the same bits every run
    if twin is not None:  # K1 and K12 are two tags of one kernel: the same bits
        other = twin(q, k, v, heads)
        assert ((out.float() - other.float()).norm() / other.float().norm()).item() < 1e-3
        assert not case.startswith("K12-vs-K1") or torch.equal(out, other)


@pytest.mark.cuda
def test_row_major_blocks_launch_on_card(cuda):
    """A bf16 transformer block and a resnet block inside ``row_major()`` go
    through K6 / K7 / K8 and agree with their default routes; the packed conv
    weight is made once."""
    from mikudance_tpu_torch.models import resnet as presnet

    torch.manual_seed(0)
    blk = players.TransformerBlock(320, 8).to(cuda, torch.bfloat16).eval()
    res = presnet.ResnetBlock(320, 640, 1280).to(cuda, torch.bfloat16).eval()
    g = torch.Generator(device=cuda).manual_seed(2)

    def r(*s):
        return torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)

    x, ctx, img, temb = r(2, 256, 320), r(2, 7, 768), r(2, 16, 16, 320), r(2, 1280)
    with torch.no_grad():
        ctx_kv = blk.attn2.project_kv(ctx)
        ref_kv = (r(2, 256, 320), r(2, 256, 320))
        want_blk, _ = blk(x, None, ref_kv=ref_kv, ctx_kv=ctx_kv)
        want_res = res(img, temb)
        k7, k8 = plin.K7.launches, pcv.K8.launches
        with row_major():
            got_blk, _ = blk(x, None, ref_kv=ref_kv, ctx_kv=ctx_kv)
            got_res = res(img, temb)
            packed = pcv.packed_weight(res.conv1)
            res(img, temb)
            assert pcv.packed_weight(res.conv1) is packed
    torch.cuda.synchronize()
    assert plin.K7.launches == k7 + 8 and pcv.K8.launches == k8 + 4
    for got, want in ((got_blk, want_blk), (got_res, want_res)):
        assert ((got.float() - want.float()).norm() / want.float().norm()).item() < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10",
                                  "K11", "K12", "K13"])
def test_backward_through_each_wrapper_on_card(case, cuda):
    """Each wrapper on CUDA tensors that require a gradient: the forward
    launches the kernel once, the backward matches autograd through the plain
    version in fp32 on the same bf16 inputs, an input that asks for no
    gradient gets none, and without ``requires_grad`` nothing is recorded."""
    g = torch.Generator(device=cuda).manual_seed(3)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=cuda) * scale).to(torch.bfloat16)

    def qkv(S, C, Skv=None):
        return [r(2, S, C), r(2, Skv or S, C), r(2, Skv or S, C)]

    forward = None  # the forward's plain version where it is not the backward's
    if case in ("K1", "K10", "K11", "K12"):
        fn, counter = {"K1": (pfa.flash_attention_fullc, pfa.K1),
                       "K10": (pfa.flash_anchor_resident, pfa.K10),
                       "K11": (pfa.flash_anchor_stream, pfa.K11),
                       "K12": (pfa.flash_attention_fullc_t, pfa.K12)}[case]
        ins, call = qkv(1091, 320), lambda a, b, c: fn(a, b, c, 8)
        plain = lambda a, b, c: pfa.dot_product_attention(a, b, c, 8)  # noqa: E731
        if case == "K1":  # the TPU kernel's forward, the exact softmax's backward
            forward = lambda a, b, c: pfa.anchored_attention_t(a, b, c, 8)  # noqa: E731
    elif case == "K2":
        ins, counter = qkv(1100, 320, 257), pfa.K2
        call = lambda a, b, c: pfa.cross_attention(a, b, c, 8)  # noqa: E731
        plain = lambda a, b, c: pfa.dot_product_attention(a, b, c, 8)  # noqa: E731
    elif case in ("K4", "K9"):
        fn, counter = {"K4": (pfa.flash_attention_wide, pfa.K4),
                       "K9": (pfa.flash_attention_resident, pfa.K9)}[case]
        ins, call = qkv(1155, 512), lambda a, b, c: fn(a, b, c, 1)
        plain = lambda a, b, c: pfa.dot_product_attention(a, b, c, 1)  # noqa: E731
    elif case == "K3":
        ins, counter = [r(1, 20, 50, 320) for _ in range(3)], pta.K3
        call = lambda a, b, c: pta.temporal_attention(a, b, c, 8)  # noqa: E731
        plain = lambda a, b, c: pta.temporal_attention_plain(a, b, c, 8)  # noqa: E731
    elif case == "K13":
        ins, counter = [r(64, 16, 320) for _ in range(3)], pta.K13
        call = lambda a, b, c: pta.small_sequence_attention(a, b, c, 8)  # noqa: E731
        plain = lambda a, b, c: pta.small_sequence_attention_plain(a, b, c, 8)  # noqa: E731
    elif case == "K5":
        ins, counter = [r(2, 12, 12, 320), r(320).float(), r(320).float()], pgn.K5
        call = lambda x, w, b: pgn.fused_group_norm(x, w, b, 32, 1e-5, True)  # noqa: E731
        plain = lambda x, w, b: pgn.group_norm_plain(x, w, b, 32, 1e-5, True)  # noqa: E731
    elif case == "K6":
        ins, counter = [r(2, 77, 320), r(320).float(), r(320).float()], pln.K6
        call = lambda x, w, b: pln.fused_layer_norm(x, w, b, 1e-5)  # noqa: E731
        plain = lambda x, w, b: pln.layer_norm_plain(x, w, b, 1e-5)  # noqa: E731
    elif case == "K7":
        ins, counter = [r(200, 320), r(640, 320, scale=320 ** -0.5), r(640), r(200, 640)], plin.K7
        call, plain = plin.fused_linear, plin.linear_plain
    else:
        ins, counter = [r(2, 16, 16, 64), r(48, 64, 3, 3, scale=(9 * 64) ** -0.5), r(48)], pcv.K8
        call, plain = pcv.conv3x3_fused, pcv.conv3x3_plain

    before = counter.launches
    out = call(*ins)
    assert counter.launches == before + 1 and out.grad_fn is None  # nothing recorded
    if forward is not None:
        want = forward(*ins).float()
        torch.testing.assert_close(out.float(), want, atol=ATOL, rtol=RTOL)
        assert ((out.float() - want).norm() / want.norm()).item() < 1e-2
    live = [t.clone().requires_grad_(i != 1) for i, t in enumerate(ins)]  # input 1 frozen
    before = counter.launches
    out = call(*live)
    assert counter.launches == before + 1 and out.grad_fn is not None
    cot = torch.randn(out.shape, generator=g, device=cuda).to(out.dtype)
    out.backward(cot)
    assert counter.launches == before + 1  # the backward is plain math
    assert live[1].grad is None
    ref = [t.float().clone().requires_grad_(i != 1) for i, t in enumerate(ins)]
    plain(*ref).backward(cot.float())
    for i, (a, b) in enumerate(zip(live, ref)):
        if i == 1:
            continue
        rel = ((a.grad.float() - b.grad).norm() / b.grad.norm()).item()
        assert rel < 2e-2, f"{case}: gradient of input {i}: relative L2 {rel:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("ctx_len", [257, 320])
@pytest.mark.parametrize("level, chunk", [((3, 1155, 640), 0), ((3, 1155, 640), 2),
                                          ((5, 576, 1280), 2), ((2, 2304, 320), 0),
                                          ((3, 2304, 320), 2)])
def test_mega_block_matches_plain_on_card(level, chunk, ctx_len, cuda):
    """K14 in one launch against its plain version, on ragged S, each head
    width, 257 and all 320 context rows real (one exact pass over them at
    heads of 40 and 80, two at 160), the plan's chunk and a chunk of 2 whose
    last pass is ragged; the bank left out must show."""
    from mikudance_tpu_torch.kernels import _mega_plan
    from mikudance_tpu_torch.kernels import mega_block as mb

    B, S, C = level
    torch.manual_seed(0)
    block = players.TransformerBlock(C, mb.HEADS).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    with torch.no_grad():
        for p in block.parameters():
            if not p.any():
                p.normal_(0.0, 1e-2, generator=g)
    w = mb.weights_from_block(block)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=cuda) * scale).to(torch.bfloat16)

    x, rk, rv = r(B, S, C, scale=0.1), r(B, S, C, scale=0.5), r(B, S, C, scale=0.5)
    ck, cv = (torch.zeros(B, 320, C, dtype=torch.bfloat16, device=cuda) for _ in range(2))
    ck[:, :ctx_len], cv[:, :ctx_len] = r(B, ctx_len, C, scale=0.5), r(B, ctx_len, C, scale=0.5)
    plan = _mega_plan.mega_plan(B, S, C, chunk)
    if chunk:
        assert B % plan.chunk  # the last pass is ragged

    def run():
        if not chunk:
            return mb.mega_block(x, rk, rv, ck, cv, w, ctx_len)
        return mb.launch_planned(x, rk, rv, ck, cv, w, ctx_len, plan=plan)

    before = mb.K14.launches
    out = run()
    torch.cuda.synchronize()
    assert mb.K14.launches == before + 1
    want = mb.mega_block_plain(x, rk, rv, ck, cv, w, ctx_len)
    torch.testing.assert_close(out.float(), want.float(), atol=ATOL, rtol=RTOL)
    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()  # noqa: E731
    assert rel(out, want) < 1e-2
    zero = torch.zeros_like(rk)
    assert rel(mb.mega_block_plain(x, zero, zero, ck, cv, w, ctx_len), want) > 1e-2
    assert torch.equal(out, run())  # no atomics in the data path


# K15's (rows, 2I) at the denoiser's four levels (16 frames at 768^2, CFG
# batch 32), a ragged row count and a row of 17 vectors
GEGLU_CARD_SHAPES = {"level0": (294912, 2560), "level1": (73728, 5120),
                     "level2": (18432, 10240), "level3": (4608, 10240),
                     "ragged-rows": (1155, 2560), "narrow": (777, 272)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", list(GEGLU_CARD_SHAPES))
def test_k15_matches_plain_bit_for_bit_on_card(shape, dtype, cuda):
    """One launch equals the plain version bit for bit; the halves swapped
    and the tanh GELU are other bits (the check can fail)."""
    rows, width = GEGLU_CARD_SHAPES[shape]
    if dtype is torch.float32 and width % 8:
        width += 8 - width % 8  # halves of whole fp32 vectors
    g = torch.Generator(device=cuda).manual_seed(5)
    y = (torch.randn((rows, width), generator=g, device=cuda) * 3).to(dtype)
    before = pgg.K15.launches
    got = pgg.fused_geglu(y)
    torch.cuda.synchronize()
    assert pgg.K15.launches == before + 1 and got.shape == (rows, width // 2)
    assert torch.equal(got, pgg.geglu_plain(y))
    hidden, gate = y.chunk(2, dim=-1)
    assert not torch.equal(got, gate * torch.nn.functional.gelu(hidden))
    assert not torch.equal(got, hidden * torch.nn.functional.gelu(gate, approximate="tanh"))


@pytest.mark.cuda
def test_k15_refuses_on_card_and_backward_is_autograds(cuda):
    """On CUDA tensors an odd width, fp16 and a non-contiguous y raise before
    any launch (no fallback); with a gradient the forward launches once, the
    backward launches no K15 and equals autograd through the plain version
    bit for bit, in both dtypes."""
    for y, match in ((torch.zeros(4, 63, dtype=torch.bfloat16, device=cuda), "twice a multiple"),
                     (torch.zeros(4, 64, dtype=torch.float16, device=cuda), "bf16 or fp32"),
                     (torch.zeros(4, 128, dtype=torch.bfloat16, device=cuda)[:, :64],
                      "contiguous")):
        before = pgg.K15.launches
        with pytest.raises(ValueError, match=match):
            pgg.fused_geglu(y)
        assert pgg.K15.launches == before
    g = torch.Generator(device=cuda).manual_seed(6)
    for dtype in (torch.bfloat16, torch.float32):
        y = (torch.randn((2, 1155, 2560), generator=g, device=cuda) * 3).to(dtype)
        cot = torch.randn((2, 1155, 1280), generator=g, device=cuda).to(dtype)
        ours, theirs = y.clone().requires_grad_(), y.clone().requires_grad_()
        before = pgg.K15.launches
        pgg.fused_geglu(ours).backward(cot)
        assert pgg.K15.launches == before + 1
        pgg.geglu_plain(theirs).backward(cot)
        torch.cuda.synchronize()
        assert torch.equal(ours.grad, theirs.grad)


@pytest.mark.cuda
def test_k15_launches_once_a_feed_forward_of_the_denoiser(cuda):
    """One call of the full-width denoiser (16 spatial transformer blocks, 21
    motion modules) launches K15 37 times: each feed-forward once."""
    from mikudance_tpu_torch.core import loaders

    den = loaders.load_denoising(None, use_motion=True, dtype=torch.bfloat16, device=cuda).eval()
    feed_forwards = sum(isinstance(m, players.GEGLUFeedForward) for m in den.modules())
    g = torch.Generator(device=cuda).manual_seed(7)
    sample = torch.randn((1, 2, 16, 16, 4), generator=g, device=cuda).to(torch.bfloat16)
    context = torch.randn((1, 77, 768), generator=g, device=cuda).to(torch.bfloat16)
    before = pgg.K15.launches
    with torch.no_grad():
        out = den(sample, torch.tensor([500], device=cuda), context)
    torch.cuda.synchronize()
    assert feed_forwards == 37 and pgg.K15.launches - before == 37
    assert out.shape == sample.shape and bool(torch.isfinite(out.float()).all())
