"""Autograd over the kernel wrappers.

A kernel is launched through ``ctypes`` on raw pointers, which autograd cannot
see. ``differentiable`` runs a wrapper's forward (the kernel on a CUDA tensor,
the plain version on a CPU tensor) inside a ``torch.autograd.Function`` whose
backward is what the JAX package's ``custom_vjp`` of the same kernel does:

- ``plain_vjp(plain)``: the vector-Jacobian product of the kernel's plain
  version, recomputed from the saved inputs (GroupNorm, LayerNorm, linear,
  3x3 convolution, the two small-sequence attentions), plain math;
- ``flash_vjp(heads)``: the exact-softmax backward of the JAX package's
  ``_flash_bwd`` (``kernels/flash_attention.py:823``) for every attention
  that goes through its ``_flash``, also for the anchored kernels:
  ``flash_backward``. On bf16 CUDA operands at a head width K16 is built for
  (``BWD_HEAD_DIMS``) that is K16 (``csrc/flash_backward.cu``), with any S_q
  and S_kv; everywhere else (CPU tensors, fp32 operands, other widths) the
  chunked dense recompute ``flash_backward_plain``, K16's plain version.

Gradients are computed only for the inputs that ask for one
(``ctx.needs_input_grad``), so a frozen weight gets no gradient buffer. With
no input that requires a gradient, or with gradients switched off, the
forward is called directly: nothing is saved and nothing else changes.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Callable, Optional, Sequence

import torch

from ..utils.profiling import count
from ._build import CudaKernel, load

K16 = CudaKernel(
    "K16 flash_backward", "md_flash_backward",
    source="mikudance_tpu_torch/csrc/flash_backward.cu",
    replaces="none: XLA's fusion of _flash_bwd, mikudance_tpu/kernels/flash_attention.py:823",
)
# Head widths K16 is built for (``csrc/flash_backward.cu`` instantiates these):
# SD1.5's UNet levels 0 and 1 (320 and 640 channels in 8 heads) and SDXL's heads
# of 64. Level 2's heads of 160 and the VAE's 512 keep the plain version.
BWD_HEAD_DIMS = (40, 64, 80)

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


def takes_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                 heads: int) -> bool:
    """Whether K16 computes this backward: CUDA tensors, bf16 operands and a
    head width it is built for; any S_q and S_kv."""
    C = q.shape[-1]
    return (q.device.type == "cuda" and C % heads == 0 and C // heads in BWD_HEAD_DIMS
            and all(t.dtype == torch.bfloat16 for t in (q, k, v, g)))


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                   heads: int, needs: Sequence[bool] = (True, True, True)):
    """Gradients of multi-head softmax attention on (B, S, C) tensors: K16
    where ``takes_kernel``, else ``flash_backward_plain``. Counts
    ``attn_bwd_kernel`` / ``attn_bwd_plain`` (a plain backward on the card)
    on the innermost open program span."""
    if takes_kernel(q, k, v, g, heads):
        count("attn_bwd_kernel")
        return _kernel_backward(q, k, v, g, heads, needs)
    if q.device.type == "cuda":
        count("attn_bwd_plain")
    return flash_backward_plain(q, k, v, g, heads, needs)


def _operand(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel reads it: contiguous and on a 16-byte boundary."""
    return t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format)


def _scratch_floats(batch: int, q_len: int, heads: int, hd: int) -> int:
    """Floats of K16's statistics scratch (``md_flash_backward_scratch``)."""
    out = ctypes.c_longlong()
    err = load().md_flash_backward_scratch(batch, q_len, heads, hd, ctypes.byref(out))
    if err:
        raise RuntimeError(f"md_flash_backward_scratch: CUDA error {err} "
                           f"({load().md_error_string(err).decode()})")
    return out.value


def _kernel_backward(q, k, v, g, heads: int, needs: Sequence[bool]):
    """K16: one C call, the rows kernel (statistics, dq) and, where dk or dv
    is wanted, the columns kernel; outputs in the inputs' dtype (bf16)."""
    need_q, need_k, need_v = needs
    B, S, C = q.shape
    Skv = k.shape[1]
    q, k, v, g = (_operand(t) for t in (q, k, v, g))
    dq = torch.empty_like(q) if need_q else None
    dk = torch.empty_like(k) if need_k else None
    dv = torch.empty_like(v) if need_v else None
    stats = None
    if need_k or need_v:  # lse and delta of every (batch, head, query row), as K16 lays them
        stats = torch.empty(_scratch_floats(B, S, heads, C // heads), dtype=torch.float32,
                            device=q.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    K16.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), ptr(dq), ptr(dk), ptr(dv),
               ptr(stats), 0 if stats is None else stats.numel(), B, S, Skv, heads, C // heads,
               torch.cuda.current_stream(q.device).cuda_stream)
    return dq, dk, dv


def flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
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
