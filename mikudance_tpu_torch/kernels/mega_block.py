"""The transformer-block mega-kernel probe: the read-mode block interior in
one launch.

K14 (``csrc/mega_block.cu``) replaces the TPU probe kernel
``probes/_mega_block.py::_mega_kernel`` (entry ``mega_block``): LN1 -> q, k +
bank K, v + bank V -> self-attention -> out-proj + x -> LN2 -> cross-q ->
attention against the hoisted context K/V (padded rows masked) -> out-proj +
residual -> LN3 -> GEGLU (tanh GELU) -> + residual. ``mega_block_plain`` is its
plain PyTorch version, the kernel's arithmetic step by step. As in the JAX
package it is a probe: no model calls it. ``weights_from_block`` reads a
``models.layers.TransformerBlock``'s weights into the dict both take, so the
probe can be held to the block's own read path.

Dispatch is by the tensor's device alone: a CPU tensor goes to the plain
version; a CUDA tensor launches the kernel or raises. The kernel takes bf16
contiguous ``x``, ``rk``, ``rv`` (B, S, C) and ``ck``, ``cv`` (B, S_ctx, C) with
8 heads of 40, 80 or 160 channels, bf16 weight matrices in ``nn.Linear``'s
(out, in) layout and fp32 vectors. It is forward only (the probe has no
gradient in the JAX package either).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from ._build import CudaKernel

K14 = CudaKernel(
    "K14 mega_block", "md_mega_block",
    source="mikudance_tpu_torch/csrc/mega_block.cu",
    replaces="probes/_mega_block.py:100",
)

HEADS = 8
HEAD_DIMS = (40, 80, 160)  # the UNet's three widths: 320, 640, 1280 channels
CTX_LEN = 257  # CLIP context tokens; the probe pads them to 320 rows and masks the rest
NEG_INF = -1e30
# Scratch the kernel may use for one chunk of batch elements: its phases hand
# their (rows, C) intermediates to each other through it, and a chunk is sized
# so that it stays about the size of the 50 MB L2 (never under one element).
SCRATCH_BYTES = 48 * 1024 * 1024
SCRATCH_BYTES_PER_VALUE = 22  # five bf16 (rows, C) buffers, the fp32 stream, bf16 (rows, 4C)
# Upper bound on the fp32 score bytes one chunk of the plain version holds.
PLAIN_SCORE_BYTES = 1 << 30
MATRICES = ("wq", "wk", "wv", "wo", "wq2", "wo2", "w1", "w2")
VECTORS = ("bo", "bo2", "b1", "b2", "s1", "g1", "s2", "g2", "s3", "g3")


def weights_from_block(block) -> Dict[str, torch.Tensor]:
    """A ``TransformerBlock``'s weights as the probe's dict: matrices in
    ``nn.Linear``'s (out, in) layout in bf16, vectors (biases, LayerNorm
    scales ``s*`` and shifts ``g*``) in fp32."""
    a1, a2, ff = block.attn1, block.attn2, block.ff
    mats = {"wq": a1.to_q.weight, "wk": a1.to_k.weight, "wv": a1.to_v.weight,
            "wo": a1.to_out[0].weight, "wq2": a2.to_q.weight, "wo2": a2.to_out[0].weight,
            "w1": ff.net[0].proj.weight, "w2": ff.net[2].weight}
    vecs = {"bo": a1.to_out[0].bias, "bo2": a2.to_out[0].bias, "b1": ff.net[0].proj.bias,
            "b2": ff.net[2].bias, "s1": block.norm1.weight, "g1": block.norm1.bias,
            "s2": block.norm2.weight, "g2": block.norm2.bias, "s3": block.norm3.weight,
            "g3": block.norm3.bias}
    out = {k: v.detach().to(torch.bfloat16).contiguous() for k, v in mats.items()}
    out.update({k: v.detach().float().contiguous() for k, v in vecs.items()})
    return out


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.square().mean(dim=-1, keepdim=True) - mu.square()
    return ((x - mu) * torch.rsqrt(var + eps) * scale + bias).to(torch.bfloat16)


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, fp32 sum; ``w`` is (out, in)."""
    return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().t()


def _attention(q, k, v, heads: int, kv_len: int) -> torch.Tensor:
    """Dense per-head attention on bf16 (B, S, C) q and (B, S_kv, C) k, v of
    which the first ``kv_len`` rows are real: q * scale rounded to bf16, fp32
    scores with the padded keys at -1e30, max-subtracted softmax normalised
    in fp32, then rounded to bf16 for the P V product; fp32 out."""
    B, S, C = q.shape
    hd = C // heads
    qs = (q.float() * (1.0 / math.sqrt(hd))).to(torch.bfloat16)

    def split(x):
        return x.reshape(B, x.shape[1], heads, hd).transpose(1, 2).float()

    qh, kh, vh = split(qs), split(k), split(v)
    neg = torch.zeros(k.shape[1], device=q.device)
    neg[kv_len:] = NEG_INF
    out = torch.empty(B, heads, S, hd, device=q.device)
    n = max(1, PLAIN_SCORE_BYTES // (heads * S * k.shape[1] * 4))
    for i in range(0, B, n):
        s = qh[i:i + n] @ kh[i:i + n].transpose(-1, -2) + neg
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = (p / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16).float()
        out[i:i + n] = p @ vh[i:i + n]
    return out.transpose(1, 2).reshape(B, S, C)


def mega_block_plain(x, rk, rv, ck, cv, w, ctx_len: int = CTX_LEN, heads: int = HEADS,
                     eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic with tensor ops: see the module docstring."""
    bf = torch.bfloat16
    hn = _ln(x.float(), w["s1"], w["g1"], eps)
    q = _dot(hn, w["wq"]).to(bf)
    k = (_dot(hn, w["wk"]) + rk.float()).to(bf)
    v = (_dot(hn, w["wv"]) + rv.float()).to(bf)
    xs = x.float() + _dot(_attention(q, k, v, heads, k.shape[1]), w["wo"]) + w["bo"]
    q2 = _dot(_ln(xs, w["s2"], w["g2"], eps), w["wq2"]).to(bf)
    xs = xs + _dot(_attention(q2, ck.to(bf), cv.to(bf), heads, ctx_len), w["wo2"]) + w["bo2"]
    hidden, gate = (_dot(_ln(xs, w["s3"], w["g3"], eps), w["w1"]) + w["b1"]).chunk(2, dim=-1)
    act = hidden * (0.5 * gate * (1.0 + torch.tanh(
        0.7978845608028654 * (gate + 0.044715 * gate * gate * gate))))
    return (xs + _dot(act, w["w2"]) + w["b2"]).to(bf)


def _check_operands(x, rk, rv, ck, cv, w, ctx_len: int, heads: int) -> int:
    """Validate what K14 takes; returns the head width."""
    if x.ndim != 3 or rk.shape != x.shape or rv.shape != x.shape or ck.ndim != 3 \
            or cv.shape != ck.shape or ck.shape[0] != x.shape[0] or ck.shape[2] != x.shape[2]:
        raise ValueError(f"mega_block: need x, rk, rv (B, S, C) and ck, cv (B, S_ctx, C), got "
                         f"{tuple(x.shape)}, {tuple(rk.shape)}, {tuple(rv.shape)}, "
                         f"{tuple(ck.shape)}, {tuple(cv.shape)}")
    C = x.shape[-1]
    if heads != HEADS or C % heads or C // heads not in HEAD_DIMS:
        raise ValueError(f"mega_block: needs {HEADS} heads of width {HEAD_DIMS}, got {heads} "
                         f"heads over {C} channels")
    if not 1 <= ctx_len <= ck.shape[1]:
        raise ValueError(f"mega_block: ctx_len {ctx_len} outside the {ck.shape[1]} context rows")
    shapes = {**{n: (C, C) for n in MATRICES[:6]}, "w1": (8 * C, C), "w2": (C, 4 * C),
              **{n: (C,) for n in VECTORS}, "b1": (8 * C,)}
    for name, t, shape, dtype in (
            [(n, t, t.shape, torch.bfloat16) for n, t in
             (("x", x), ("rk", rk), ("rv", rv), ("ck", ck), ("cv", cv))]
            + [(n, w[n], shapes[n], torch.bfloat16) for n in MATRICES]
            + [(n, w[n], shapes[n], torch.float32) for n in VECTORS]):
        if t.dtype != dtype or not t.is_contiguous() or t.device != x.device \
                or tuple(t.shape) != tuple(shape) or t.data_ptr() % 16:
            raise ValueError(f"mega_block: {name} must be a contiguous 16-byte aligned {dtype} "
                             f"tensor of shape {tuple(shape)} on x's device, got {t.dtype} "
                             f"{tuple(t.shape)}")
    return C // heads


def mega_block(x, rk, rv, ck, cv, w, ctx_len: int = CTX_LEN, heads: int = HEADS,
               eps: float = 1e-5) -> torch.Tensor:
    """K14 on CUDA tensors, the plain version on CPU tensors. x, rk, rv:
    (B, S, C) hidden states and bank K/V; ck, cv: (B, S_ctx, C) hoisted
    context K/V whose rows from ``ctx_len`` on are padding; w: the dict of
    ``weights_from_block``. Returns bf16 (B, S, C)."""
    if x.device.type == "cpu":
        return mega_block_plain(x, rk, rv, ck, cv, w, ctx_len, heads, eps)
    if x.device.type != "cuda":
        raise ValueError(f"mega_block: unsupported device {x.device}")
    hd = _check_operands(x, rk, rv, ck, cv, w, ctx_len, heads)
    B, S, C = x.shape
    chunk = max(1, min(B, SCRATCH_BYTES // (S * C * SCRATCH_BYTES_PER_VALUE)))
    rows = chunk * S
    out = torch.empty_like(x)
    sizes = [rows * C * 2] * 5 + [rows * 4 * C * 2, rows * C * 4]  # nrm q k v a, act, xs
    scratch = torch.empty(sum(sizes), dtype=torch.uint8, device=x.device)
    barrier = torch.empty(4, dtype=torch.int32, device=x.device)
    offsets = [sum(sizes[:i]) for i in range(len(sizes))]
    ptrs = ([t.data_ptr() for t in (x, rk, rv, ck, cv)] + [w[n].data_ptr() for n in MATRICES]
            + [w[n].data_ptr() for n in VECTORS] + [out.data_ptr()]
            + [scratch.data_ptr() + o for o in offsets] + [barrier.data_ptr()])
    K14.launch((ctypes.c_void_p * len(ptrs))(*ptrs), B, S, hd, ck.shape[1], ctx_len, chunk, eps,
               torch.cuda.current_stream(x.device).cuda_stream)
    return out
