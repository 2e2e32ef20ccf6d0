"""The port's attention kernels: plain versions against the JAX Pallas kernels
(interpret mode, as ``tests/test_flash_attention.py`` runs them), the dispatch
rule, and device-only dispatch (a CPU tensor never launches a kernel).

The CUDA kernels themselves run only on a card: the ``cuda`` tests compare
each with its plain version there and skip on a machine without one. The
machine with the card has no JAX, so JAX is imported by a fixture, and the
card runs this file with ``--noconftest``:

    python -m pytest tests/test_torch_port_kernels.py -m cuda --noconftest -q
"""

import types

import numpy as np
import pytest
import torch

from mikudance_tpu_torch.kernels import flash_attention as pfa
from mikudance_tpu_torch.kernels import temporal_attention as pta

ATOL = RTOL = 2e-2  # kernel against dense, as tests/test_flash_attention.py
ALL_KERNELS = (pfa.K1, pfa.K2, pta.K3, pfa.K4)


def qkv(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.fixture
def jx():
    """The JAX package's Pallas entry points (run in interpret mode)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import mikudance_tpu.kernels.flash_attention as fa
    from mikudance_tpu.kernels.temporal_attention import temporal_attention_btpc
    return types.SimpleNamespace(jnp=jnp, fa=fa, btpc=temporal_attention_btpc)


def check(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hd,heads", [(40, 4), (80, 2)])
def test_k1_plain_matches_pallas_fullc_nt(hd, heads, jx):
    B, S, C = 2, 512, hd * heads
    q, k, v = qkv(hd, (B, S, C), (B, S, C), (B, S, C))
    want = jx.fa.flash_attention_fullc_nt(
        jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v), heads, 1.0 / np.sqrt(hd),
        q_block=128, k_block=128, interpret=True)
    check(pfa.flash_attention_fullc(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), heads), want)


def test_k2_plain_matches_pallas_cross(jx):
    B, S, Skv, heads, hd = 2, 256, 257, 4, 40  # 257 CLIP tokens: ragged key tile
    q, k, v = qkv(23, (B, S, heads * hd), (B, Skv, heads * hd), (B, Skv, heads * hd))
    want = jx.fa.flash_attention_cross(
        jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v), heads, 1.0 / np.sqrt(hd),
        q_block=128, interpret=True)
    check(pfa.cross_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), heads), want)


def test_k3_plain_matches_pallas_btpc(jx):
    B, T, P, heads, hd = 2, 16, 21, 4, 40  # P=21 exercises the TPU kernel's padding
    q, k, v = qkv(22, *[(B, T, P, heads * hd)] * 3)
    want = jx.btpc(jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v), heads,
                   rows_per_tile=128, interpret=True)
    check(pta.temporal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), heads), want)


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
    (((4, 9216, 512),) * 3, 1, "flash_attention_wide"),           # VAE mid-block
    (((32, 9216, 320), (32, 257, 320), (32, 257, 320)), 8, "cross_attention"),
    (((32, 2304, 640), (32, 257, 640), (32, 257, 640)), 8, "cross_attention"),
    (((32, 576, 1280),) * 3, 8, "dot_product_attention"),         # level 2: plain
    (((32, 144, 1280), (32, 257, 1280), (32, 257, 1280)), 8, "dot_product_attention"),
    (((64, 16, 320),) * 3, 8, "dot_product_attention"),           # 3-D short sequences
])
def test_dispatch_rule(shape, heads, route, monkeypatch):
    """``attention`` picks the route the JAX dispatcher picks for each shape
    class (checked on meta tensors: shapes only, no compute)."""
    calls = []
    for name in ("temporal_attention", "flash_attention_fullc", "flash_attention_wide",
                 "cross_attention", "dot_product_attention"):
        monkeypatch.setattr(pfa, name, lambda *a, _n=name: calls.append(_n))
    pfa.attention(*[torch.empty(s, device="meta") for s in shape], heads)
    assert calls == [route]


def test_cpu_tensors_never_launch():
    """Every route on CPU tensors is the plain math and launches nothing."""
    for kern in ALL_KERNELS:
        kern.launches = 0
    rng = np.random.default_rng(5)

    def r(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32))

    q, ctx = r(1, 1024, 16), r(1, 257, 16)
    for out, want in (
        (pfa.attention(q, q, q, 2), pfa.dot_product_attention(q, q, q, 2)),          # K1 route
        (pfa.attention(q, ctx, ctx, 2), pfa.dot_product_attention(q, ctx, ctx, 2)),  # K2 route
        (pfa.attention(r(1, 1024, 128), *[r(1, 1024, 128)] * 2, 1), None),           # K4 route
        (pfa.attention(r(1, 4, 6, 16), *[r(1, 4, 6, 16)] * 2, 2), None),             # K3 route
    ):
        if want is not None:
            torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert [kern.launches for kern in ALL_KERNELS] == [0, 0, 0, 0]


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """Shape, dtype and layout checks run before any launch (meta tensors
    stand in for CUDA ones: the checks read only metadata)."""
    def m(*s, dtype=torch.bfloat16):
        return torch.empty(s, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="unsupported device"):
        pfa.flash_attention_fullc(m(1, 1024, 64), m(1, 1024, 64), m(1, 1024, 64), 2)
    for args, heads, dims, match in (
        ((m(1, 8, 64),) * 3, 3, pfa.PACKED_HEAD_DIMS, "head width"),
        ((m(1, 8, 48),) * 3, 1, pfa.PACKED_HEAD_DIMS, "head width"),  # not a main-path width
        ((m(1, 8, 384),) * 3, 1, pfa.WIDE_HEAD_DIMS, "head width"),
        ((m(1, 8, 64, dtype=torch.float32), m(1, 8, 64), m(1, 8, 64)), 2,
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
    with pytest.raises(ValueError, match="T <= 32"):
        x = torch.empty(1, 33, 4, 16, dtype=torch.bfloat16, device="meta")
        pta._check_operands(x, x, x, 2)
    # contiguous views that start off the kernels' load alignment
    flat = torch.empty(1 + 2 * 8 * 64, dtype=torch.bfloat16, device="meta")
    x = flat[1:].view(2, 8, 64)
    with pytest.raises(ValueError, match="16-byte"):
        pfa._check_operands("k", x, x, x, 2, pfa.PACKED_HEAD_DIMS)
    x = flat[1:].view(1, 2, 8, 64)
    with pytest.raises(ValueError, match="4-byte"):
        pta._check_operands(x, x, x, 2)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["K1-hd40", "K1-hd80", "K2", "K3", "K4"])
def test_kernel_matches_plain_on_card(case, cuda):
    g = torch.Generator(device=cuda).manual_seed(0)

    def r(*s):
        return torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)

    if case.startswith("K1"):
        hd = int(case[-2:])
        args, fn, plain = [r(2, 1100, 8 * hd) for _ in range(3)] + [8], \
            pfa.flash_attention_fullc, pfa.dot_product_attention
    elif case == "K2":
        args, fn, plain = [r(2, 1100, 320), r(2, 257, 320), r(2, 257, 320), 8], \
            pfa.cross_attention, pfa.dot_product_attention
    elif case == "K3":
        args, fn, plain = [r(2, 16, 300, 640) for _ in range(3)] + [8], \
            pta.temporal_attention, pta.temporal_attention_plain
    else:
        args, fn, plain = [r(2, 1100, 512) for _ in range(3)] + [1], \
            pfa.flash_attention_wide, pfa.dot_product_attention
    got = fn(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), plain(*args).float(), atol=ATOL, rtol=RTOL)
