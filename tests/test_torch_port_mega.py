"""The mega-block probe's plain version (K14) against the JAX probe kernel in
interpret mode and against the port's ``TransformerBlock`` read path, on the
CPU.

``probes/_mega_block.py`` is loaded by path (it is a script, not a package
module) at its self-test size (``_selftest_dims``: S 192, C 128, 8 heads, 13
context rows padded to 16) with ``_INTERPRET`` set, as its own ``--selftest``
runs it. Tolerances: plain vs the Pallas kernel 2e-3 relative L2 (both round to
bf16 at the same places) and 5e-2 absolute (one bf16 step at |y| of 4 to 8 is
3e-2, and small outputs are sums of terms that large); plain vs
the block's read path 2e-2 relative L2 (tanh vs erf GELU, an fp32 vs a bf16
residual stream).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mikudance_tpu_torch.kernels import mega_block as mb
from mikudance_tpu_torch.models import layers

PROBE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "probes",
                     "_mega_block.py")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Small tensors gain nothing from many intra-op threads, and several test
    workers on one host lose a lot to them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location("mega_block_probe", PROBE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module._selftest_dims()
    module._INTERPRET = True
    return module


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def probe_inputs(probe, seed, batch=2, x_scale=1.0):
    """The probe's own inputs (its ``main``), weights a little larger so that
    every sublayer shows; returns numpy fp32 (x, rk, rv, ck, cv) and its ``w``."""
    rng = np.random.default_rng(seed)
    S, C, SC, SCP, FF = probe.S, probe.C, probe.SC, probe.SC_PAD, probe.FF

    def r(*s, sc=0.1):
        return rng.normal(0, sc, s).astype(np.float32)

    x, rk, rv = r(batch, S, C, sc=x_scale), r(batch, S, C, sc=0.5), r(batch, S, C, sc=0.5)
    ck, cv = (np.zeros((batch, SCP, C), np.float32) for _ in range(2))
    ck[:, :SC], cv[:, :SC] = r(batch, SC, C, sc=0.5), r(batch, SC, C, sc=0.5)
    w = {"wq": r(C, C), "wk": r(C, C), "wv": r(C, C), "wo": r(C, C), "bo": r(1, C),
         "wq2": r(C, C), "wo2": r(C, C), "bo2": r(1, C), "w1": r(C, 2 * FF), "b1": r(1, 2 * FF),
         "w2": r(FF, C), "b2": r(1, C), "s1": 1 + r(1, C), "g1": r(1, C), "s2": 1 + r(1, C),
         "g2": r(1, C), "s3": 1 + r(1, C), "g3": r(1, C)}
    return (x, rk, rv, ck, cv), w


def port_weights(w):
    """The probe's (in, out) matrices and (1, dim) vectors -> the port's dict."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v.T)).to(torch.bfloat16)
                if k in mb.MATRICES else torch.from_numpy(v[0].copy())) for k, v in w.items()}


def tb(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("seed,x_scale", [(0, 1.0), (1, 0.1), (2, 3.0)])
def test_plain_matches_the_pallas_probe(probe, seed, x_scale):
    ins, w = probe_inputs(probe, seed, x_scale=x_scale)
    want = np.asarray(probe.mega_block(*[jnp.asarray(a, jnp.bfloat16) for a in ins],
                                       {k: jnp.asarray(v) for k, v in w.items()})
                      .astype(jnp.float32))
    got = mb.mega_block(*[tb(a) for a in ins], port_weights(w), ctx_len=probe.SC)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ins[0].shape
    assert rel_l2(got.float().numpy(), want) < 2e-3
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2, rtol=2e-2)
    # what the tolerance can see: the padded context rows unmasked, the bank left out
    pw = port_weights(w)
    unmasked = mb.mega_block_plain(*[tb(a) for a in ins], pw, ctx_len=probe.SC_PAD)
    zero = torch.zeros_like(tb(ins[1]))
    no_bank = mb.mega_block_plain(tb(ins[0]), zero, zero, tb(ins[3]), tb(ins[4]), pw,
                                  ctx_len=probe.SC)
    assert rel_l2(unmasked.float().numpy(), want) > 2e-3 or x_scale > 1.0
    assert rel_l2(no_bank.float().numpy(), want) > 4e-3


def test_plain_follows_the_kernel_not_the_xla_reference(probe):
    """The probe's own XLA reference uses the erf GELU; the kernel, and so the
    plain version, the tanh approximation: the plain version is closer to the
    kernel than the reference is."""
    ins, w = probe_inputs(probe, 3, x_scale=0.1)
    jins = [jnp.asarray(a, jnp.bfloat16) for a in ins]
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    kernel = np.asarray(probe.mega_block(*jins, jw).astype(jnp.float32))
    reference = np.asarray(probe.xla_reference(*jins, jw).astype(jnp.float32))
    plain = mb.mega_block(*[tb(a) for a in ins], port_weights(w), ctx_len=probe.SC)
    assert rel_l2(plain.float().numpy(), kernel) < rel_l2(reference, kernel)


@pytest.mark.parametrize("dim,seq", [(128, 192), (320, 100)])
def test_plain_matches_the_transformer_block_read_path(dim, seq):
    torch.manual_seed(0)
    block = layers.TransformerBlock(dim, mb.HEADS)
    with torch.no_grad():
        for p in block.parameters():
            if not p.any():
                p.normal_(0.0, 0.05)
    g = torch.Generator().manual_seed(1)
    x, rk, rv = (torch.randn(2, seq, dim, generator=g) * s for s in (0.3, 0.5, 0.5))
    ctx_len, pad = 13, 16
    ck, cv = (torch.zeros(2, pad, dim) for _ in range(2))
    ck[:, :ctx_len], cv[:, :ctx_len] = (torch.randn(2, ctx_len, dim, generator=g) * 0.5
                                        for _ in range(2))
    want, bank = block(x, None, ref_kv=(rk, rv), ctx_kv=(ck[:, :ctx_len], cv[:, :ctx_len]))
    assert bank is None
    w = mb.weights_from_block(block)
    assert all(w[n].dtype == torch.bfloat16 and w[n].is_contiguous() for n in mb.MATRICES)
    assert all(w[n].dtype == torch.float32 and w[n].ndim == 1 for n in mb.VECTORS)
    assert w["w1"].shape == (8 * dim, dim) and w["w2"].shape == (dim, 4 * dim)
    bf = torch.bfloat16
    got = mb.mega_block(x.to(bf), rk.to(bf), rv.to(bf), ck.to(bf), cv.to(bf), w, ctx_len=ctx_len)
    assert rel_l2(got.float().numpy(), want.detach().numpy()) < 2e-2
    zero = torch.zeros_like(rk).to(bf)
    no_bank = mb.mega_block(x.to(bf), zero, zero, ck.to(bf), cv.to(bf), w, ctx_len=ctx_len)
    assert rel_l2(no_bank.float().numpy(), want.detach().numpy()) > 4e-2


@pytest.mark.parametrize("what,match", [
    ("heads", "8 heads"), ("width", "8 heads"), ("ctx_len", "ctx_len"), ("dtype", "x must be"),
    ("weight-shape", "w1 must be"), ("bank-shape", "need x, rk, rv"), ("vector-dtype", "bo must")])
def test_wrapper_refuses_what_the_kernel_does_not_take(what, match):
    """On meta tensors: shapes, dtypes and layouts only, nothing computed."""
    C = 320 if what != "width" else 256
    t = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")  # noqa: E731
    x, rk, rv, ck, cv = t(2, 64, C), t(2, 64, C), t(2, 64, C), t(2, 320, C), t(2, 320, C)
    w = {**{n: t(C, C) for n in mb.MATRICES[:6]}, "w1": t(8 * C, C), "w2": t(C, 4 * C),
         **{n: t(C, dtype=torch.float32) for n in mb.VECTORS}, "b1": t(8 * C, dtype=torch.float32)}
    kw = dict(ctx_len=257, heads=8)
    if what == "heads":
        kw["heads"] = 4
    elif what == "ctx_len":
        kw["ctx_len"] = 321
    elif what == "dtype":
        x = x.float()
    elif what == "weight-shape":
        w["w1"] = t(4 * C, C)
    elif what == "bank-shape":
        rk = t(2, 63, C)
    elif what == "vector-dtype":
        w["bo"] = t(C)
    with pytest.raises(ValueError, match=match):
        mb._check_operands(x, rk, rv, ck, cv, w, kw["ctx_len"], kw["heads"])
    if what == "heads":  # and what it takes passes
        assert mb._check_operands(x, rk, rv, ck, cv, w, 257, 8) == 40


def test_no_launch_on_the_cpu_and_an_unknown_device_raises():
    before = mb.K14.launches
    torch.manual_seed(0)
    block = layers.TransformerBlock(128, 8)
    x = torch.randn(1, 32, 128).to(torch.bfloat16)
    c = torch.randn(1, 16, 128).to(torch.bfloat16)
    out = mb.mega_block(x, x, x, c, c, mb.weights_from_block(block), ctx_len=16)
    assert out.shape == x.shape and mb.K14.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        mb.mega_block(*[torch.empty(1, 32, 128, device="meta")] * 5, {}, ctx_len=16)
