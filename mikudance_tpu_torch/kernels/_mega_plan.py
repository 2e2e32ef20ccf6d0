"""The plan of K14's persistent launch (``csrc/mega_block.cu``, wrapper
``mega_block.py``).

One block an SM walks the transformer block's eleven phases for a chunk of
batch elements at a time, a grid-wide barrier between phases (ten a chunk:
the last phase of a chunk overlaps the next chunk's LayerNorm). Each phase is
a list of items the blocks take round robin: product tiles of 128 rows by
160 output columns (GEGLU: by 80 hidden and 80 gate columns), attention items
of 128 query rows of one head, LayerNorm rows. The tile is fixed by the
kernel's registers (a wider one serialises its products, ``mega_block.cu``);
the plan picks the chunk.

A small chunk keeps the intermediates that the phases hand on within reach
of the 50 MB L2; a large one fills the card's SMs in every phase and crosses
fewer barriers. Timed on an H100 at the probe's three levels (chunks of 1, 2,
4, 8 and 32 in turns, ``chip_smoke.py``'s chunk table, PERF.md), the time
falls as the chunk grows at every level: the whole batch beats the chunk
that holds its scratch in L2 by 1.2-2.6x. So the rule is the largest
balanced chunk (``ceil(batch / n)`` for n passes) whose scratch fits
``SCRATCH_LIMIT``, and never less than one element.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

HEADS = 8
ROW_TILE = 128          # rows of a product tile; query rows of an attention item
PRODUCT_COLUMNS = 160   # output columns of a C-wide product tile (wgmma n160)
GEGLU_COLUMNS = 80      # act columns of a GEGLU tile: 80 hidden and 80 gate
CHANNELS = (320, 640, 1280)  # 8 heads of 40, 80, 160
BARRIERS_PER_CHUNK = 10
# Scratch a batch element's (seq, C) values hold: bf16 normed rows, bf16 q, k,
# v and the attention output (which the GEGLU activations, bf16 (seq, 4C),
# overlay), fp32 residual stream.
SCRATCH_BYTES_PER_VALUE = 2 + 4 * 2 + 4
SCRATCH_LIMIT = 2 << 30  # bytes of scratch a launch may take


class MegaPlan(NamedTuple):
    chunk: int          # batch elements a pass of the phases
    chunks: int         # passes: ceil(batch / chunk)
    scratch_bytes: int  # the intermediates of one chunk
    barriers: int       # grid-wide barriers of the launch


def phase_items(chunk: int, seq: int, channels: int) -> Dict[str, int]:
    """Items of each phase of one chunk (LayerNorm: rows)."""
    rows = chunk * seq
    row_tiles = math.ceil(rows / ROW_TILE)
    c_wide = row_tiles * (channels // PRODUCT_COLUMNS)
    attention = chunk * HEADS * math.ceil(seq / ROW_TILE)
    return {"ln1": rows, "qkv": 3 * c_wide, "self": attention, "out": c_wide, "ln2": rows,
            "cross_q": c_wide, "cross": attention, "out2": c_wide, "ln3": rows,
            "geglu": row_tiles * (4 * channels // GEGLU_COLUMNS), "down": c_wide}


def scratch_bytes(chunk: int, seq: int, channels: int) -> int:
    return chunk * seq * channels * SCRATCH_BYTES_PER_VALUE


def mega_plan(batch: int, seq: int, channels: int, chunk: int = 0) -> MegaPlan:
    """The launch's plan for (batch, seq, channels): the largest chunk
    ``ceil(batch / n)`` (n passes, so the last chunk is no sliver) whose
    scratch fits ``SCRATCH_LIMIT``, one element where none does; ``chunk`` >
    0 sets it instead (for measurement)."""
    if batch < 1 or seq < 1 or channels not in CHANNELS:
        raise ValueError(f"mega_plan: batch {batch}, seq {seq}, channels {channels}")
    if chunk <= 0:
        chunk = next((c for c in (math.ceil(batch / n) for n in range(1, batch + 1))
                      if scratch_bytes(c, seq, channels) <= SCRATCH_LIMIT), 1)
    chunk = min(chunk, batch)
    chunks = math.ceil(batch / chunk)
    return MegaPlan(chunk, chunks, scratch_bytes(chunk, seq, channels),
                    BARRIERS_PER_CHUNK * chunks)
