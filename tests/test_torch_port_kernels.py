"""The port's kernels (attention K1-K4, GroupNorm K5, LayerNorm K6): plain
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

import types

import numpy as np
import pytest
import torch

from mikudance_tpu_torch.kernels import flash_attention as pfa
from mikudance_tpu_torch.kernels import group_norm as pgn
from mikudance_tpu_torch.kernels import layer_norm as pln
from mikudance_tpu_torch.kernels import temporal_attention as pta

ATOL = RTOL = 2e-2  # kernel against dense, as tests/test_flash_attention.py
ALL_KERNELS = (pfa.K1, pfa.K2, pta.K3, pfa.K4, pgn.K5, pln.K6)


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
    from mikudance_tpu.kernels.group_norm import fused_group_norm
    from mikudance_tpu.kernels.layer_norm import fused_layer_norm
    from mikudance_tpu.models.layers import FusedLayerNorm
    return types.SimpleNamespace(jnp=jnp, fa=fa, btpc=temporal_attention_btpc,
                                 group_norm=fused_group_norm, layer_norm=fused_layer_norm,
                                 FusedLayerNorm=FusedLayerNorm)


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


@pytest.mark.parametrize("images,rows,channels,vec", [
    (32, 96 * 96, 320, 8), (32, 96 * 96, 960, 8), (32, 12 * 12, 2560, 8),
    (8, 768 * 768, 128, 8), (1, 12288 * 768, 128, 8), (2, 40 * 40, 320, 4), (1, 1, 8, 8),
])
def test_k5_statistics_plan_covers_every_row(images, rows, channels, vec):
    """The cut of the statistics pass: every row in exactly one split, a block
    of at most 256 threads, short fp32 runs, and enough blocks when N = 1."""
    rows_per_block, splits, chunk_w, lanes = pgn.stats_plan(images, rows, channels, vec)
    assert (splits - 1) * rows_per_block < rows <= splits * rows_per_block
    assert 1 <= chunk_w * lanes <= pgn.BLOCK_THREADS
    chunks = -(-(channels // vec) // chunk_w)
    assert chunks * chunk_w >= channels // vec
    assert rows_per_block <= lanes * pgn.MAX_ROWS_PER_LANE
    if rows * channels > 1 << 24:  # a large map fills the card whatever the batch
        assert images * splits * chunks >= 512


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
    (((1, 257, 1024),) * 3, 16, "dot_product_attention"),         # CLIP tower, 16 heads of 64
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
    x, w, b = r(2, 4, 4, 16), r(16), r(16)
    torch.testing.assert_close(pgn.fused_group_norm(x, w, b, 4, 1e-6, True),   # K5 route
                               pgn.group_norm_plain(x, w, b, 4, 1e-6, True), rtol=0, atol=0)
    torch.testing.assert_close(pln.fused_layer_norm(x, w, b, 1e-5),            # K6 route
                               pln.layer_norm_plain(x, w, b, 1e-5), rtol=0, atol=0)
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
    assert {"flash_attention.cu", "temporal_attention.cu", "group_norm.cu",
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
    for name in ("md_group_norm", "md_layer_norm"):
        assert name in _build.SIGNATURES


def _meta(*s, dtype=torch.bfloat16):
    return torch.empty(s, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,match", [
    ("device", "unsupported device"), ("dtype", "bf16 or fp32"), ("view", "contiguous"),
    ("vector", "8-channel vector"), ("groups", "multiple of 3 groups"),
    ("offset", "16-byte"), ("weight", "weight must be"), ("bias dtype", "bias must be"),
])
def test_group_norm_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    """Checks run before any launch (meta tensors stand in for CUDA ones: the
    checks read only metadata); nothing falls back to the plain version."""
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
    else:
        b = _meta(32, dtype=torch.float32)
    with pytest.raises(ValueError, match=match):
        pgn._check_operands(x, w, b, groups)


@pytest.mark.parametrize("case,match", [
    ("device", "unsupported device"), ("dtype", "bf16 or fp32"), ("view", "contiguous"),
    ("odd", "even"), ("wide", "<= 1280"), ("offset", "4-byte"), ("weight", "weight must be"),
])
def test_layer_norm_wrapper_refuses_what_the_kernel_does_not_take(case, match):
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
    elif case == "offset":
        x = _meta(1 + 2 * 8 * 64)[1:].view(2, 8, 64)
    else:
        w = _meta(32)
    with pytest.raises(ValueError, match=match):
        pln._check_operands(x, w, b)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["K5-silu", "K5-tall-n1", "K5-fp32", "K6-320", "K6-1024",
                                  "K6-fp32"])
def test_norm_kernel_matches_plain_on_card(case, cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    dtype = torch.float32 if case.endswith("fp32") else torch.bfloat16
    shape = {"K5-silu": (3, 24, 24, 320), "K5-tall-n1": (1, 4100, 16, 128),
             "K5-fp32": (2, 9, 9, 960), "K6-320": (2, 16, 33, 320), "K6-1024": (1, 257, 1024),
             "K6-fp32": (5, 7, 640)}[case]
    C = shape[-1]
    x = (torch.randn(shape, generator=g, device=cuda) * (torch.rand(C, generator=g, device=cuda)
                                                         * 3.75 + 0.25)
         + torch.rand(C, generator=g, device=cuda) * 16 - 8)
    if case.startswith("K6"):  # row means away from zero
        x += torch.rand(shape[:-1] + (1,), generator=g, device=cuda) * 16 - 8
    x = x.to(dtype)
    w, b = torch.randn(C, generator=g, device=cuda), torch.randn(C, generator=g, device=cuda)
    if case.startswith("K5"):
        kern, got = pgn.K5, lambda: pgn.fused_group_norm(x, w, b, 32, 1e-6, case == "K5-silu")
        want = pgn.group_norm_plain(x, w, b, 32, 1e-6, case == "K5-silu")
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
@pytest.mark.parametrize("case", ["K1-hd40", "K1-hd80", "K2", "K3", "K3-one-frame", "K4"])
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
    elif case.startswith("K3"):  # one frame: a motion-module denoiser at T = 1
        frames = 1 if case == "K3-one-frame" else 16
        args, fn, plain = [r(2, frames, 300, 640) for _ in range(3)] + [8], \
            pta.temporal_attention, pta.temporal_attention_plain
    else:
        args, fn, plain = [r(2, 1100, 512) for _ in range(3)] + [1], \
            pfa.flash_attention_wide, pfa.dot_product_attention
    got = fn(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), plain(*args).float(), atol=ATOL, rtol=RTOL)
