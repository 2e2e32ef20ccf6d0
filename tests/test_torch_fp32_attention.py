"""fp32 requests through the port's attention kernels (K1-K4, K9-K13).

The TPU bodies take fp32 operands, round them to bf16 inside and write the
output in q's dtype from their fp32 accumulators; the port's wrappers take
bf16 or fp32 q, k and v and hold each fp32 kernel to a plain version that
rounds where its body does. Here, on the CPU: those rounded plain versions
against the JAX entries in interpret mode on fp32 inputs that bf16 does not
hold exactly; the wrappers' operand rules on meta tensors (fp32 passes up to
the launch, fp16 still raises; K7 and K8 stay bf16-only, naming themselves);
and, marked ``cuda``, each fp32 kernel against its rounded plain version on
the card (``python -m pytest tests/test_torch_fp32_attention.py -m cuda
--noconftest``; the card's machine has no JAX, which only the CPU tests'
fixture imports).

Limits (relative L2 of the output). Where the rounded plain version and the
TPU body round at the same points they differ only where a value lies on a
bf16 rounding tie and the last bit of an fp32 sum or exponential (XLA's
exp2 is exp(x ln 2), its dots sum in another order) sends it the other way:
the measured floor on these inputs is 2e-8 to 3e-6 for K3 and K13 (weights
of at most 32 keys), 1.5e-5 to 5.8e-5 for the anchored kernels and K4 / K9
(p rounded a score at a time), 3.6e-6 to 1.6e-4 for K2 (257 keys' weights of
about 1/257 each, rounded after the division). Each limit is about three
times its kernel's floor; the unrounded function (the CPU route's fp32
softmax) lies 1e-3 or more away at every shape, which each test also checks.
"""

import types

import numpy as np
import pytest
import torch

from mikudance_tpu_torch.kernels import conv2d as pcv
from mikudance_tpu_torch.kernels import flash_attention as pfa
from mikudance_tpu_torch.kernels._build import CudaKernel
from mikudance_tpu_torch.kernels import linear as plin
from mikudance_tpu_torch.kernels import temporal_attention as pta

LIMIT = {"anchored": 2e-4, "K2": 5e-4, "short": 1e-5, "wide": 1e-4}
UNROUNDED_APART = 1e-3


def qkv(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture
def jx():
    """The JAX package's Pallas entry points (run in interpret mode)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import mikudance_tpu.kernels.flash_attention as fa
    from mikudance_tpu.kernels.temporal_attention import (temporal_attention_btpc,
                                                          temporal_attention_fused)
    return types.SimpleNamespace(jnp=jnp, fa=fa, btpc=temporal_attention_btpc,
                                 fused=temporal_attention_fused)


def held(want, got, limit, unrounded):
    """``got`` (the rounded plain version) within ``limit`` of the fp32 TPU
    body's ``want``, the unrounded function farther than UNROUNDED_APART."""
    want = np.asarray(want)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    assert got.shape == want.shape
    assert rel(got, want) <= limit
    assert rel(unrounded, want) > UNROUNDED_APART


@pytest.mark.parametrize("kern,hd,heads", [
    ("K1", 40, 4), ("K1", 80, 2), ("K1", 160, 2), ("K1", 32, 1),  # 32: the tiny VAE's head
    ("K10", 40, 4), ("K10", 80, 2), ("K11", 40, 4), ("K11", 160, 2),
    ("K12", 40, 4), ("K12", 80, 2)])
def test_anchored_rounded_plain_matches_pallas_at_fp32(kern, hd, heads, jx, monkeypatch):
    """K1 / K12 (``anchored_attention_t``) and K10 / K11 (``anchored_attention``)
    on fp32 q: q' and the anchor from the unrounded q, only q' rounded. K10 is
    the resident branch of ``flash_attention_fullc``, K11 its streamed one."""
    B, S = 2, 256
    q, k, v = qkv(hd + heads + len(kern), *[(B, S, hd * heads)] * 3)
    args = (*(jx.jnp.asarray(a) for a in (q, k, v)), heads, 1.0 / np.sqrt(hd))
    blocks = dict(q_block=128, k_block=128, interpret=True)
    if kern == "K1":
        want = jx.fa.flash_attention_fullc_nt(*args, **blocks)
    elif kern == "K12":
        want = jx.fa.flash_attention_fullc_t(*args, **blocks)
    else:
        if kern == "K10":
            monkeypatch.setattr(jx.fa, "_flash_kernel_fullc_stream", None)  # resident, or fail
        else:
            monkeypatch.setattr(jx.fa, "FULLC_RESIDENT_BYTES", 0)
            monkeypatch.setattr(jx.fa, "_flash_kernel_fullc_resident", None)
        want = jx.fa.flash_attention_fullc(*args, **blocks)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plain = pfa.anchored_attention_t if kern in ("K1", "K12") else pfa.anchored_attention
    held(want, plain(tq, tk, tv, heads), LIMIT["anchored"],
         pfa.dot_product_attention(tq, tk, tv, heads))
    # the anchor from bf16-rounded q is another function, farther than the limit
    pre = plain(tq.bfloat16().float(), tk, tv, heads)
    assert rel(pre, want) > 10 * LIMIT["anchored"]


@pytest.mark.parametrize("hd,skv", [(40, 257), (80, 77), (160, 257)])
def test_k2_rounded_plain_matches_pallas_at_fp32(hd, skv, jx):
    """``cross_attention_rounded``: q scaled in fp32 and rounded once, the
    weights rounded after the division."""
    B, S, heads = 2, 256, 2
    q, k, v = qkv(hd + skv, (B, S, heads * hd), (B, skv, heads * hd), (B, skv, heads * hd))
    want = jx.fa.flash_attention_cross(*(jx.jnp.asarray(a) for a in (q, k, v)), heads,
                                       1.0 / np.sqrt(hd), q_block=128, interpret=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    held(want, pfa.cross_attention_rounded(tq, tk, tv, heads), LIMIT["K2"],
         pfa.dot_product_attention(tq, tk, tv, heads))


@pytest.mark.parametrize("B,T,P,heads,hd", [
    (2, 16, 21, 4, 40), (1, 30, 9, 2, 80), (1, 20, 16, 2, 160),
    (2, 3, 16, 4, 8)])  # the tiny twins' motion modules (verify_parity --selfcheck)
def test_k3_rounded_plain_matches_pallas_at_fp32(B, T, P, heads, hd, jx):
    q, k, v = qkv(B + T + hd, *[(B, T, P, heads * hd)] * 3)
    want = jx.btpc(*(jx.jnp.asarray(a) for a in (q, k, v)), heads, rows_per_tile=128,
                   interpret=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    held(want, pta.temporal_attention_rounded(tq, tk, tv, heads), LIMIT["short"],
         pta.temporal_attention_plain(tq, tk, tv, heads))


@pytest.mark.parametrize("N,T,heads,hd", [(21, 16, 4, 40), (21, 32, 2, 160)])
def test_k13_rounded_plain_matches_pallas_at_fp32(N, T, heads, hd, jx):
    q, k, v = qkv(N + T, *[(N, T, heads * hd)] * 3)
    want = jx.fused(*(jx.jnp.asarray(a) for a in (q, k, v)), heads, 128, True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    held(want, pta.small_sequence_attention_rounded(tq, tk, tv, heads), LIMIT["short"],
         pta.small_sequence_attention_plain(tq, tk, tv, heads))


@pytest.mark.parametrize("kern", ["K4", "K9"])
def test_wide_rounded_plain_matches_pallas_at_fp32(kern, jx, monkeypatch):
    """``wide_attention_rounded``: q, k, v rounded first, p rounded for P V
    and summed unrounded for l. One key block of 128 (the TPU bodies round p
    against the running maximum, which one block makes the row's); K4 is
    ``flash_attention_padded``'s streamed branch, K9 its resident one."""
    B, S, hd = 2, 128, 512
    if kern == "K4":
        monkeypatch.setattr(jx.fa, "RESIDENT_KV_BYTES", 0)
        monkeypatch.setattr(jx.fa, "_flash_kernel_resident", None)
    else:
        monkeypatch.setattr(jx.fa, "_flash_kernel", None)
    q, k, v = qkv(S + len(kern), *[(B, S, hd)] * 3)
    want = jx.fa.flash_attention_padded(*(jx.jnp.asarray(a) for a in (q, k, v)),
                                        1.0 / np.sqrt(hd), q_block=128, k_block=128,
                                        interpret=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    held(want, pfa.wide_attention_rounded(tq, tk, tv, 1), LIMIT["wide"],
         pfa.dot_product_attention(tq, tk, tv, 1))


def _meta(*s, dtype=torch.float32):
    return torch.empty(s, dtype=dtype, device="meta")


@pytest.mark.parametrize("wrapper,shapes,heads,q_arg", [
    ("flash_attention_fullc", [(2, 1024, 320)] * 3, 8, torch.float32),
    ("flash_attention_fullc", [(2, 9216, 32)] * 3, 1, torch.float32),  # the tiny VAE's head
    ("flash_anchor_resident", [(2, 1024, 640)] * 3, 8, torch.float32),
    ("flash_anchor_stream", [(2, 1024, 320)] * 3, 8, torch.float32),
    ("flash_attention_fullc_t", [(2, 1024, 1280)] * 3, 8, torch.float32),
    ("cross_attention", [(2, 1024, 320), (2, 257, 320), (2, 257, 320)], 8, torch.bfloat16),
    ("flash_attention_wide", [(2, 4096, 512)] * 3, 1, torch.bfloat16),
    ("flash_attention_resident", [(2, 1024, 512)] * 3, 1, torch.bfloat16),
])
def test_fp32_operands_pass_the_attention_rules(wrapper, shapes, heads, q_arg, monkeypatch):
    """fp32 q, k and v pass every operand rule up to the launch (meta tensors
    stand in for CUDA ones past the device check): the kernel is handed k and
    v in bf16, q as fp32 for the anchored kernel (its q' and anchor come from
    the unrounded q), as bf16 for K2 (its q', scaled and rounded here) and K4
    / K9 (whose body rounds q first); the output is fp32."""
    monkeypatch.setattr(pfa, "_check_cuda", lambda name, *a: pfa._check_operands(name, *a))
    launched = []
    monkeypatch.setattr(CudaKernel, "launch", lambda self, *a: launched.append((self, a)))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    seen = []
    real_launch = pfa._launch
    monkeypatch.setattr(pfa, "_launch", lambda kern, dtype, q, k, v, *dims: (
        seen.append((dtype, q.dtype)), real_launch(kern, dtype, q, k, v, *dims))[1])
    q, k, v = (_meta(*s) for s in shapes)
    out = getattr(pfa, wrapper)(q, k, v, heads)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert len(launched) == 1 and launched[0][1][-2] == 1  # the kernel's fp32 switch
    assert seen == [(torch.float32, q_arg)]


def test_fp32_operands_pass_the_short_attention_rules(monkeypatch):
    """K3 and K13 on fp32: the operand rules pass, the kernel gets the scaled
    and rounded q' in bf16 and its fp32 switch, the output is fp32; fp16
    raises (also for k alone)."""
    monkeypatch.setattr(pta, "_sm_count", lambda index: 132)
    launched = []
    monkeypatch.setattr(CudaKernel, "launch", lambda self, *a: launched.append((self, a)))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    q = _meta(2, 16, 24, 320)
    pta._check_operands(q, q, q, 8)
    out = pta._launch(pta.K3, q, q, q, 8, 2, 16, 24, 320, 8, 1, 8, 8)
    assert out.dtype == torch.float32 and launched[-1][1][-2] == 1
    x = _meta(64, 16, 1280)
    pta._check_small_operands(x, x, x, 8)
    for bad in ((_meta(2, 16, 24, 320, dtype=torch.float16),) * 3,
                (q, _meta(2, 16, 24, 320, dtype=torch.float16), q)):
        with pytest.raises(ValueError, match="bf16 or fp32"):
            pta._check_operands(*bad, 8)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        pta._check_small_operands(_meta(64, 16, 1280, dtype=torch.float16), x, x, 8)


@pytest.mark.parametrize("check,args,kern", [
    (plin._check_operands, (_meta(4, 6, 32), _meta(16, 32), None, None), "K7"),
    (pcv._check_operands, (_meta(2, 4, 8, 32), _meta(16, 32, 3, 3), None,
                           _meta(3, 3, 16, 32)), "K8"),
])
def test_row_major_kernels_refuse_fp32_naming_themselves(check, args, kern):
    """K7 and K8 (the row-major configuration) stay bf16-only: fp32 operands
    raise, and the message names the kernel."""
    with pytest.raises(ValueError, match=f"{kern} takes bf16 only"):
        check(*args)


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' fp32 scores
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CARD_CASES = {
    # kernel: (wrapper, rounded plain version, q shape, k / v shape, heads)
    "K1": ("flash_attention_fullc", "anchored_attention_t", (2, 1100, 320), None, 8),
    "K1-hd32": ("flash_attention_fullc", "anchored_attention_t", (2, 9216, 32), None, 1),
    "K1-hd160": ("flash_attention_fullc", "anchored_attention_t", (2, 1024, 1280), None, 8),
    "K2": ("cross_attention", "cross_attention_rounded", (2, 1100, 320), (2, 257, 320), 8),
    "K2-hd160": ("cross_attention", "cross_attention_rounded", (2, 1024, 1280), (2, 77, 1280),
                 8),
    "K3": ("temporal_attention", "temporal_attention_rounded", (2, 16, 301, 640), None, 8),
    "K3-hd8": ("temporal_attention", "temporal_attention_rounded", (2, 3, 256, 32), None, 4),
    "K4": ("flash_attention_wide", "wide_attention_rounded", (2, 1100, 512), None, 1),
    "K9": ("flash_attention_resident", "wide_attention_rounded", (2, 1155, 512), None, 1),
    "K10": ("flash_anchor_resident", "anchored_attention", (2, 1100, 640), None, 8),
    "K11": ("flash_anchor_stream", "anchored_attention", (2, 1100, 320), None, 8),
    "K12": ("flash_attention_fullc_t", "anchored_attention_t", (2, 1100, 320), None, 8),
    "K13": ("small_sequence_attention", "small_sequence_attention_rounded", (70, 16, 320), None,
            8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_fp32_kernel_matches_rounded_plain_on_card(case, cuda):
    """Each kernel on fp32 N(0, 1) operands: an fp32 output within 1e-2
    relative L2 of its rounded plain version (on the card: exp2.approx and
    another order of sums), the anchored kernels' also farther from the
    same kernel on bf16-rounded q."""
    wrapper, plain, q_shape, kv_shape, heads = CARD_CASES[case]
    mod = pta if wrapper in ("temporal_attention", "small_sequence_attention") else pfa
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(q_shape, generator=g, device=cuda)
    k, v = (torch.randn(kv_shape or q_shape, generator=g, device=cuda) for _ in range(2))
    got = getattr(mod, wrapper)(q, k, v, heads)
    torch.cuda.synchronize()
    want = getattr(mod, plain)(q, k, v, heads)
    assert got.dtype == torch.float32 and got.shape == q.shape
    r = ((got - want).norm() / want.norm()).item()
    assert r < 1e-2
    if plain.startswith("anchored"):
        pre = getattr(mod, wrapper)(q.bfloat16().float(), k, v, heads)
        assert ((pre - want).norm() / want.norm()).item() > 4 * r
