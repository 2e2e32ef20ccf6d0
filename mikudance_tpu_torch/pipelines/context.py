"""Temporal sliding-window context schedule (static, host-side numpy).

Copied from the JAX package (``mikudance_tpu/pipelines/context.py``), which
re-implements the AnimateDiff "uniform" scheduler the reference uses
(reference ``src/pipelines/context.py:7-42``): overlapping windows of
``context_frames`` frames, strides in powers of two, wrap-around modulo the
video length, with a bit-reversed fractional offset per denoise step.

The schedule is computed once on the host (the reference pipeline always
calls it with step=0, `pipeline_mikudance.py:592`) and returned as a dense
(num_windows, context_frames) int32 index matrix. The pipeline gathers the
latents per window, denoises every window as one batched call, and
scatter-adds the predictions back: the reference's "counter" normalization
becomes an ``index_add_``.
"""

from __future__ import annotations

from typing import List

import numpy as np


def bit_reversed_fraction(val: int, bits: int = 64) -> float:
    """Fraction in [0,1) whose binary expansion is the bit-reversal of val."""
    out = 0.0
    scale = 0.5
    for _ in range(bits):
        if val == 0:
            break
        if val & 1:
            out += scale
        val >>= 1
        scale *= 0.5
    return out


def uniform_windows(
    step: int,
    num_frames: int,
    context_size: int,
    context_stride: int = 1,
    context_overlap: int = 8,
    closed_loop: bool = True,
) -> List[List[int]]:
    """Frame-index windows for one denoise step (list of lists, host-side)."""
    if num_frames <= context_size:
        return [list(range(num_frames))]

    frac = bit_reversed_fraction(step)
    max_stride = int(np.ceil(np.log2(num_frames / context_size))) + 1
    context_stride = min(context_stride, max_stride)

    windows: List[List[int]] = []
    for s in range(context_stride):
        stride = 1 << s
        pad = int(round(num_frames * frac))
        start = int(frac * stride) + pad
        stop = num_frames + pad + (0 if closed_loop else -context_overlap)
        step_size = context_size * stride - context_overlap
        for j in range(start, stop, step_size):
            windows.append(
                [e % num_frames for e in range(j, j + context_size * stride, stride)]
            )
    return windows


def window_matrix(
    num_frames: int,
    context_size: int,
    context_stride: int = 1,
    context_overlap: int = 8,
    step: int = 0,
) -> np.ndarray:
    """Dense (num_windows, window_len) int32 index matrix for gathering.

    window_len is min(num_frames, context_size); the reference pipeline always
    uses step=0 (`pipeline_mikudance.py:592`), making this static per shape.
    """
    wins = uniform_windows(step, num_frames, context_size, context_stride, context_overlap)
    return np.asarray(wins, dtype=np.int32)


def frame_counts(windows: np.ndarray, num_frames: int) -> np.ndarray:
    """How many windows cover each frame (the reference's ``counter``)."""
    counts = np.zeros((num_frames,), dtype=np.int32)
    for w in windows.reshape(-1):
        counts[w] += 1
    return counts
