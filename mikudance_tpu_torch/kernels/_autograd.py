"""Autograd over the kernel wrappers.

A kernel is launched through ``ctypes`` on raw pointers, which autograd cannot
see. ``differentiable`` runs a wrapper's forward (the kernel on a CUDA tensor,
the plain version on a CPU tensor) inside a ``torch.autograd.Function`` whose
backward is what the JAX package's ``custom_vjp`` of the same kernel does. In
every case that is plain math, not a kernel:

- ``plain_vjp(plain)``: the vector-Jacobian product of the kernel's plain
  version, recomputed from the saved inputs (GroupNorm, LayerNorm, linear,
  3x3 convolution, the two small-sequence attentions);
- ``flash_vjp(heads)``: the chunked dense recompute of the JAX package's
  ``_flash_bwd`` (``kernels/flash_attention.py:823``) for every attention
  that goes through its ``_flash``: the exact softmax, also for the anchored
  kernels.

Gradients are computed only for the inputs that ask for one
(``ctx.needs_input_grad``), so a frozen weight gets no gradient buffer. With
no input that requires a gradient, or with gradients switched off, the
forward is called directly: nothing is saved and nothing else changes.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence

import torch

# Rows of queries one step of the attention backward recomputes
# (``_bwd_chunk``, flash_attention.py:816): the largest divisor of S that is
# a multiple of 16 and at most this.
BWD_CHUNK_CAP = 160


class _KernelFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, forward, backward, *tensors):
        ctx.backward_fn = backward
        ctx.present = [t is not None for t in tensors]
        ctx.save_for_backward(*[t for t in tensors if t is not None])
        return forward(*tensors)

    @staticmethod
    def backward(ctx, g):
        saved = iter(ctx.saved_tensors)
        tensors = [next(saved) if p else None for p in ctx.present]
        grads = ctx.backward_fn(tensors, g, ctx.needs_input_grad[2:])
        return (None, None, *grads)


def differentiable(forward: Callable, backward: Callable, *tensors: Optional[torch.Tensor]):
    """``forward(*tensors)``, differentiable through ``backward(tensors, g,
    needs) -> grads`` where an input requires a gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        return _KernelFunction.apply(forward, backward, *tensors)
    return forward(*tensors)


def plain_vjp(plain: Callable) -> Callable:
    """A backward that differentiates ``plain(*tensors)`` at the saved inputs."""

    def backward(tensors, g, needs):
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(tensors, needs)]
            out = plain(*ins)
            wanted = [t for t, n in zip(ins, needs) if n]
            got = iter(torch.autograd.grad(out, wanted, g.to(out.dtype), allow_unused=True))
        return [next(got) if n else None for n in needs]

    return backward


def bwd_chunk(S: int) -> int:
    for b in range(min(BWD_CHUNK_CAP, S) // 16 * 16, 15, -16):
        if S % b == 0:
            return b
    return S


@contextlib.contextmanager
def _exact_bf16_products(t: torch.Tensor):
    """fp32 matmuls of bf16-valued operands on the tensor cores: a bf16 value
    is a TF32 value, so the products are exact and the sums stay fp32."""
    if t.device.type != "cuda" or t.dtype != torch.bfloat16:
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                   heads: int, needs: Sequence[bool] = (True, True, True)):
    """Gradients of multi-head softmax attention on (B, S, C) tensors by
    recomputing the weights one chunk of queries at a time, so the fp32 score
    buffer is (B, heads, chunk, S_kv) and never (S, S_kv). Operands keep the
    inputs' precision (p and ds are rounded to it before their products, as
    the forward rounds p); every sum is fp32."""
    B, S, C = q.shape
    Skv = k.shape[1]
    hd = C // heads
    scale = 1.0 / math.sqrt(hd)
    dt = q.dtype
    chunk = bwd_chunk(S)

    def heads_first(x, s):
        return x.reshape(B, s, heads, hd).permute(0, 2, 1, 3).float()

    def merge(x, s, like):
        return x.permute(0, 2, 1, 3).reshape(B, s, C).to(like.dtype)

    qh, kh, vh, gh = heads_first(q, S), heads_first(k, Skv), heads_first(v, Skv), heads_first(g, S)
    need_q, need_k, need_v = needs
    dq = torch.empty_like(qh) if need_q else None
    dk = torch.zeros_like(kh) if need_k else None
    dv = torch.zeros_like(vh) if need_v else None
    with _exact_bf16_products(q):
        for c0 in range(0, S, chunk):
            qc, gc = qh[:, :, c0:c0 + chunk], gh[:, :, c0:c0 + chunk]
            p = torch.softmax(torch.matmul(qc, kh.transpose(-1, -2)) * scale, dim=-1)
            if need_v:
                dv += torch.matmul(p.to(dt).float().transpose(-1, -2), gc)
            if not (need_q or need_k):
                continue
            dp = torch.matmul(gc, vh.transpose(-1, -2))
            ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
            if need_q:
                dq[:, :, c0:c0 + chunk] = torch.matmul(ds, kh) * scale
            if need_k:
                dk += torch.matmul(ds.transpose(-1, -2), qc) * scale
    return (merge(dq, S, q) if need_q else None, merge(dk, Skv, k) if need_k else None,
            merge(dv, Skv, v) if need_v else None)


def flash_vjp(heads: int) -> Callable:
    def backward(tensors, g, needs):
        q, k, v = tensors
        return flash_backward(q, k, v, g, heads, needs)

    return backward
