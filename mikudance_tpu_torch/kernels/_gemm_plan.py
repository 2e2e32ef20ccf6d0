"""The tile plans of the warpgroup GEMM core (``csrc/gemm_wg.cuh``) that K7
(``linear.py``) and K8 (``conv2d.py``) launch.

A tile is 128 rows of the left operand (token rows for K7, output pixels for
K8) by ``column_tile(cout)`` output channels. K8's 128 pixels are one TMA box
of a 4-D map over x: ``wb`` pixels of an image row by ``hb`` rows by ``nb``
images (``tile_plan``). The CUDA side refuses a plan it cannot run, so these
functions are what keeps every product and convolution of the models
launchable (``tests/test_torch_gemm_plan.py``).
"""

from __future__ import annotations

from typing import NamedTuple

# tile widths BN, widest first: the first that divides Cout, else
# FALLBACK_TILE with the last column tile masked
COLUMN_TILES = (320, 256, 160)
FALLBACK_TILE = 128

TILE_PIXELS = 128  # output pixels of a K8 tile: the core's rows
BOX_WIDTHS = (64, 32, 16, 8)


def column_tile(cout: int) -> int:
    """The output columns of one tile: 320 (two wgmma products of 160 a k16
    step) where it divides Cout (the UNets' 320 ... 10240), else 256 or 160
    where one does, else 128 with the last column tile masked."""
    return next((bn for bn in COLUMN_TILES if cout % bn == 0), FALLBACK_TILE)


class TilePlan(NamedTuple):
    bn: int  # output channels of a tile
    wb: int  # its pixels along an image row
    hb: int  # its image rows
    nb: int  # its images: wb * hb * nb == TILE_PIXELS


def tile_plan(images: int, height: int, width: int, cout: int) -> TilePlan:
    """K8's output tile for (images, height, width) maps (width a multiple of
    8): ``wb`` the largest of 64, 32, 16, 8 that divides the width; ``hb`` the
    power of two (at most 128 / wb) whose box, ``nb = 128 / (wb hb)`` images
    deep, wastes the fewest rows past the height and images past the count
    (the taller box on a tie); and ``column_tile(cout)``."""
    wb = next((b for b in BOX_WIDTHS if width % b == 0), None)
    if wb is None:
        raise ValueError(f"conv3x3_fused: image width {width} is not a multiple of 8")
    heights = [TILE_PIXELS // wb >> i for i in range((TILE_PIXELS // wb).bit_length())]

    def padded(hb):  # rows x images the tiles cover
        nb = TILE_PIXELS // (wb * hb)
        return -(-height // hb) * hb * (-(-images // nb) * nb)

    hb = min(heights, key=padded)  # the first (tallest) of equals
    return TilePlan(column_tile(cout), wb, hb, TILE_PIXELS // (wb * hb))
