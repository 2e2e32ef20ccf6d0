"""Attention over at most 32 tokens: across frames, and over tiny maps.

K3 and K13 are two entry points of one CUDA kernel
(``csrc/temporal_attention.cu``: mma.sync tensor-core products, q, k and v
staged once in bf16):

- K3 (``md_temporal_attention``) replaces the TPU kernel
  ``mikudance_tpu/kernels/temporal_attention.py::_temporal_kernel_btpc``
  (:120) on the motion module's (B, T, P, C) layout;
- K13 (``md_small_attention``) replaces ``_temporal_kernel`` (:29, entry
  ``temporal_attention_fused``) on (N, T, C): N independent sequences of
  T <= 32 tokens, the UNet mid-block's spatial self-attention once its map
  has shrunk that far.

Both TPU bodies round q * scale * log2(e) to bf16 before Q K^T and the
normalised weights to bf16 before P V. ``temporal_attention_rounded`` (and
its (N, T, C) view ``small_sequence_attention_rounded``) is that function in
plain PyTorch: the kernels' plain version on the card.

q, k and v are each bf16 or fp32 and the output has q's dtype, as the TPU
kernels write ``o_ref.dtype``: an fp32 q goes to the kernel as its body's q' =
bf16(q * log2(e) / sqrt(hd)), scaled in fp32 and rounded once here (the
kernel's own factor is then 1), k and v cast to bf16 (the bodies round them
first), and an fp32 output is stored from the accumulator.

Dispatch is by the tensor's device alone: a CPU tensor goes to
``temporal_attention_plain`` / ``small_sequence_attention_plain``, the math
of the JAX package's CPU path (``temporal_attention_xla`` :160,
``grouped_small_attention``); a CUDA tensor launches the kernel or raises.
Both wrappers are differentiable: the backward is the vector-Jacobian product
of the CPU route's math, as in the JAX package (``temporal_attention.py:239,
252``).
"""

from __future__ import annotations

import functools
import math

import torch

from ._autograd import differentiable, plain_vjp
from ._build import CudaKernel

K3 = CudaKernel(
    "K3 temporal_attention", "md_temporal_attention",
    source="mikudance_tpu_torch/csrc/temporal_attention.cu",
    replaces="mikudance_tpu/kernels/temporal_attention.py:120",
)

K13 = CudaKernel(
    "K13 small_sequence_attention", "md_small_attention",
    source="mikudance_tpu_torch/csrc/temporal_attention.cu",
    replaces="mikudance_tpu/kernels/temporal_attention.py:29",
)

MAX_FRAMES = 32
# Head widths K3 and K13 take: the UNet's 8 heads at 320, 640 and 1280
# channels, and the tiny twins' 4 heads at 32, 64 and 96 channels (the motion
# modules of ``scripts/verify_parity.py --selfcheck``, which the JAX package
# sends to its kernel at any width).
SMALL_HEAD_DIMS = (8, 16, 24, 40, 80, 160)
# What q, k and v may each be (the output takes q's dtype).
OPERAND_DTYPES = (torch.bfloat16, torch.float32)
# Upper bound on the fp32 score bytes one chunk of the plain version holds.
PLAIN_SCORE_BYTES = 1 << 30
LOG2E = 1.4426950408889634
# A kernel tile: whole sequences, TILE_ROWS (sequence, token) rows with the
# tokens rounded up to 16, by a group of heads of at most GROUP_CHANNELS
# channels; the plan aims for BLOCKS_PER_SM tiles an SM at least.
TILE_ROWS = 32
GROUP_CHANNELS = 320
BLOCKS_PER_SM = 2


def temporal_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             heads: int) -> torch.Tensor:
    """Per-position attention across frames: fp32 scores and softmax, weights
    cast to v's dtype for the P V product. Processed in chunks of positions
    so the score tensor stays bounded."""
    B, T, P, C = q.shape
    hd = C // heads
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(v)
    n = max(1, PLAIN_SCORE_BYTES // (B * heads * T * T * 4))
    for p0 in range(0, P, n):
        sl = slice(p0, p0 + n)
        qh = q[:, :, sl].reshape(B, T, -1, heads, hd)
        kh = k[:, :, sl].reshape(B, T, -1, heads, hd)
        vh = v[:, :, sl].reshape(B, T, -1, heads, hd)
        s = torch.einsum("btphd,bsphd->bphts", qh.float(), kh.float()) * scale
        w = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bphts,bsphd->btphd", w, vh)
        out[:, :, sl] = o.reshape(B, T, -1, C)
    return out


def temporal_attention_rounded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               heads: int) -> torch.Tensor:
    """What the TPU bodies (and K3, K13) compute, per (batch, position, head):
    q' = bf16(q * scale * log2(e)) in fp32, s = q' . bf16(k) in fp32, p =
    exp2(s - max s), o = bf16(p / sum p) . bf16(v) in fp32, in q's dtype.
    Processed in chunks of positions as the plain version."""
    B, T, P, C = q.shape
    hd = C // heads
    mult = 1.0 / math.sqrt(hd) * LOG2E

    def bf16(x):
        return x.to(torch.bfloat16).float()

    out = torch.empty_like(q)
    n = max(1, PLAIN_SCORE_BYTES // (B * heads * T * T * 4))
    for p0 in range(0, P, n):
        sl = slice(p0, p0 + n)
        qh = bf16(q[:, :, sl].float() * mult).reshape(B, T, -1, heads, hd)
        kh = bf16(k[:, :, sl]).reshape(B, T, -1, heads, hd)
        vh = bf16(v[:, :, sl]).reshape(B, T, -1, heads, hd)
        s = torch.einsum("btphd,bsphd->bphts", qh, kh)
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        w = bf16(p / p.sum(-1, keepdim=True))
        o = torch.einsum("bphts,bsphd->btphd", w, vh)
        out[:, :, sl] = o.reshape(B, T, -1, C)
    return out


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int) -> torch.Tensor:
    """K3 on CUDA tensors, the plain version on CPU tensors."""
    return differentiable(
        lambda a, b, c: _temporal_attention(a, b, c, heads),
        plain_vjp(lambda a, b, c: temporal_attention_plain(a, b, c, heads)), q, k, v)


def _temporal_attention(q, k, v, heads: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return temporal_attention_plain(q, k, v, heads)
    if q.device.type != "cuda":
        raise ValueError(f"temporal_attention: unsupported device {q.device}")
    _check_operands(q, k, v, heads)
    B, T, P, C = q.shape
    plan = tile_plan(B, P, T, heads, C // heads, _sm_count(q.device.index))
    return _launch(K3, q, k, v, heads, B, T, P, C, heads, *plan)


def rounded_q(q: torch.Tensor, hd: int) -> torch.Tensor:
    """The TPU bodies' q' = bf16(q * log2(e) / sqrt(hd)): scaled in fp32,
    rounded once (K2, K3, K13 on fp32 q; the kernel's own factor is then 1)."""
    return (q * (1.0 / math.sqrt(hd) * LOG2E)).to(torch.bfloat16)


def _launch(kernel, q, k, v, heads: int, *dims) -> torch.Tensor:
    """Launch with k and v in bf16 and q as is, or, fp32, as ``rounded_q``;
    the output in q's dtype. The cast copies live until the launch is
    queued."""
    fp32 = q.dtype == torch.float32
    qk = rounded_q(q, q.shape[-1] // heads) if fp32 else q
    kb, vb = (t if t.dtype == torch.bfloat16 else t.to(torch.bfloat16) for t in (k, v))
    o = torch.empty_like(q)
    kernel.launch(qk.data_ptr(), kb.data_ptr(), vb.data_ptr(), o.data_ptr(), *dims, int(fp32),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return o


@functools.cache
def tile_plan(outer: int, sequences: int, T: int, heads: int, hd: int,
              sms: int) -> tuple[int, int, int]:
    """(sequences, heads, warps) of one kernel block for ``outer`` x
    ``sequences`` sequences of T tokens: TILE_ROWS rows of sequences (tokens
    rounded up to 16) by the most heads that divide ``heads`` within
    GROUP_CHANNELS; while the grid has fewer than BLOCKS_PER_SM blocks an SM,
    first fewer sequences a tile, then fewer heads. A warp takes one m16 row
    tile of a (sequence, head) at a time: 8 warps where a tile has 8 such
    units or more, else 4."""
    tp = 16 if T <= 16 else 32
    ns = TILE_ROWS // tp
    groups = [g for g in range(heads, 0, -1) if heads % g == 0 and g * hd <= GROUP_CHANNELS]
    gh = groups.pop(0)
    while -(-sequences // ns) * (heads // gh) * outer < BLOCKS_PER_SM * sms:
        if ns > 1:
            ns //= 2
        elif groups:
            gh = groups.pop(0)
        else:
            break
    return ns, gh, 8 if ns * gh * (tp // 16) >= 8 else 4


@functools.cache
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_operands(q, k, v, heads: int) -> None:
    if q.ndim != 4 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"temporal_attention: q, k, v must share a (B, T, P, C) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, P, C = q.shape
    if any(t.dtype not in OPERAND_DTYPES or not t.is_contiguous() or t.device != q.device
           for t in (q, k, v)):
        raise ValueError("temporal_attention: q, k, v must be contiguous bf16 or fp32 on one "
                         f"device, got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):  # the kernel's 16-byte cp.async chunks
        raise ValueError("temporal_attention: q, k, v must start on a 16-byte boundary")
    if C % heads or C // heads not in SMALL_HEAD_DIMS or not 1 <= T <= MAX_FRAMES \
            or B > 65535 or heads > 65535:
        raise ValueError(f"temporal_attention: unsupported T={T}, C={C}, heads={heads} "
                         f"(needs a head width in {SMALL_HEAD_DIMS} and T <= {MAX_FRAMES})")


def small_sequence_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   heads: int) -> torch.Tensor:
    """Self-attention within each of N sequences (N, T, C): fp32 scores and
    softmax, weights cast to v's dtype for the P V product."""
    return temporal_attention_plain(q[:, :, None], k[:, :, None], v[:, :, None], heads)[:, :, 0]


def small_sequence_attention_rounded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     heads: int) -> torch.Tensor:
    """``temporal_attention_rounded`` on (N, T, C): one position a sequence."""
    return temporal_attention_rounded(q[:, :, None], k[:, :, None], v[:, :, None],
                                      heads)[:, :, 0]


def small_sequence_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             heads: int) -> torch.Tensor:
    """K13 on CUDA tensors, the plain version on CPU tensors."""
    return differentiable(
        lambda a, b, c: _small_sequence_attention(a, b, c, heads),
        plain_vjp(lambda a, b, c: small_sequence_attention_plain(a, b, c, heads)), q, k, v)


def _small_sequence_attention(q, k, v, heads: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return small_sequence_attention_plain(q, k, v, heads)
    if q.device.type != "cuda":
        raise ValueError(f"small_sequence_attention: unsupported device {q.device}")
    _check_small_operands(q, k, v, heads)
    N, T, C = q.shape
    plan = tile_plan(1, N, T, heads, C // heads, _sm_count(q.device.index))
    return _launch(K13, q, k, v, heads, N, T, C, heads, *plan)


def _check_small_operands(q, k, v, heads: int) -> None:
    if q.ndim != 3 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"small_sequence_attention: q, k, v must share an (N, T, C) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    N, T, C = q.shape
    if any(t.dtype not in OPERAND_DTYPES or not t.is_contiguous() or t.device != q.device
           for t in (q, k, v)):
        raise ValueError("small_sequence_attention: q, k, v must be contiguous bf16 or fp32 on "
                         f"one device, got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):  # the kernel's 16-byte cp.async chunks
        raise ValueError("small_sequence_attention: q, k, v must start on a 16-byte "
                         "boundary")
    if C % heads or C // heads not in SMALL_HEAD_DIMS or not 1 <= T <= MAX_FRAMES \
            or heads > 65535:
        raise ValueError(f"small_sequence_attention: unsupported T={T}, C={C}, heads={heads} "
                         f"(needs a head width in {SMALL_HEAD_DIMS} and T <= {MAX_FRAMES})")
