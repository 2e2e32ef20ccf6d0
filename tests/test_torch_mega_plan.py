"""The plan of K14's persistent launch on the CPU (``kernels/_mega_plan.py``).

K14 walks the transformer block's phases for a chunk of batch elements at a
time, a grid-wide barrier between phases; the plan picks the chunk from (B,
S, C): the largest balanced chunk whose scratch fits the limit (the whole
batch at the probe's three levels, which the card's chunk table favours).
These checks hold it to that rule at the three levels and at ragged S, count
the items each phase gives the card's SMs (every phase of the probe's levels
fills two waves of an H100's 132), the scratch the wrapper allocates, and
the barriers: ten a chunk, far fewer than the 320 of one element a chunk.
No JAX here.
"""

from __future__ import annotations

import math

import pytest

from mikudance_tpu_torch.kernels import _mega_plan as mp
from mikudance_tpu_torch.kernels import mega_block as mb

LEVELS = ((32, 2304, 640), (32, 576, 1280), (32, 9216, 320))  # the probe's, mid, big
RAGGED = ((3, 1155, 640), (5, 576, 1280), (2, 2304, 320), (7, 577, 320), (1, 257, 1280),
          (32, 1040, 1280), (64, 16384, 1280), (5, 40000, 640))
H100_SMS = 132


def balanced(batch: int):
    """The chunks ``ceil(batch / n)`` the rule chooses among, smallest first."""
    return sorted({math.ceil(batch / n) for n in range(1, batch + 1)})


@pytest.mark.parametrize("shape", LEVELS + RAGGED)
def test_plan_takes_the_largest_chunk_that_fits(shape):
    B, S, C = shape
    plan = mp.mega_plan(B, S, C)
    assert 1 <= plan.chunk <= B
    assert plan.chunks == math.ceil(B / plan.chunk)
    assert plan.chunk * (plan.chunks - 1) < B  # no empty pass
    fits = [c for c in balanced(B) if mp.scratch_bytes(c, S, C) <= mp.SCRATCH_LIMIT]
    if fits:
        assert plan.chunk == max(fits)
        assert plan.scratch_bytes <= mp.SCRATCH_LIMIT
    else:  # not even one element fits the limit: one a pass
        assert plan.chunk == 1


@pytest.mark.parametrize("shape", LEVELS)
def test_levels_fill_the_card_with_few_barriers(shape):
    """The whole batch in one pass at the probe's levels: ten barriers (one
    element a chunk, the old sizing at the probe's level, took 320), and
    every phase two waves of an H100's SMs or more."""
    B, S, C = shape
    plan = mp.mega_plan(B, S, C)
    assert plan.chunk == B and plan.barriers == 10
    assert min(v for k, v in mp.phase_items(B, S, C).items() if not k.startswith("ln")) \
        >= 2 * H100_SMS


@pytest.mark.parametrize("shape", LEVELS + RAGGED)
def test_phase_items(shape):
    B, S, C = shape
    for chunk in (1, 2, B):
        items = mp.phase_items(chunk, S, C)
        assert list(items) == list(mb.PHASES)
        rows = chunk * S
        row_tiles = -(-rows // 128)
        c_wide = row_tiles * C // 160  # tiles of 128 rows x 160 columns
        assert items["qkv"] == 3 * c_wide
        assert items["out"] == items["cross_q"] == items["out2"] == items["down"] == c_wide
        assert items["self"] == items["cross"] == chunk * 8 * -(-S // 128)
        assert items["geglu"] == row_tiles * 4 * C // 80  # 80 hidden + 80 gate columns
        assert items["ln1"] == items["ln2"] == items["ln3"] == rows


@pytest.mark.parametrize("shape", LEVELS + RAGGED)
def test_scratch_and_barriers(shape):
    B, S, C = shape
    for chunk in (1, 2, 4, 8, B, B + 5):
        plan = mp.mega_plan(B, S, C, chunk)
        assert plan.chunk == min(chunk, B)  # never past the batch
        # bf16 nrm, q, k, v, a (act overlays q..a: 4C bf16 a row), fp32 stream
        assert plan.scratch_bytes == plan.chunk * S * C * (5 * 2 + 4)
        assert plan.barriers == 10 * math.ceil(B / plan.chunk)


def test_refusals():
    for args in ((0, 2304, 640), (32, 0, 640), (32, 2304, 600), (32, 2304, 960)):
        with pytest.raises(ValueError):
            mp.mega_plan(*args)


def test_phase_split():
    """The stamps' spans to phases: the first span is LN1, then each chunk's
    ten, the last of a chunk (down, and the next chunk's LN1) as down."""
    chunks = 3
    spans = [1000 * (i + 1) for i in range(1 + 10 * chunks)]  # ns
    stamps = [0]
    for s in spans:
        stamps.append(stamps[-1] + s)
    split = mb.phase_split(stamps, chunks)
    assert list(split) == list(mb.PHASES)
    assert split["ln1"] == pytest.approx(1e-3)
    for i, name in enumerate(mb.PHASES[1:]):
        want = sum(spans[1 + 10 * c + i] for c in range(chunks)) * 1e-6
        assert split[name] == pytest.approx(want)
    assert sum(split.values()) == pytest.approx(stamps[-1] * 1e-6)
