"""The tile plans of K7 and K8 (the port's warpgroup GEMM core) on the CPU.

``kernels/_gemm_plan.py``: ``column_tile`` picks the output columns of a tile
(wgmma's N, or two products of 160 at 320) and ``tile_plan`` K8's output
tile: a ``wb`` x ``hb`` pixel box of ``nb`` images, 128 pixels in all, read
as one TMA box of a 4-D map over x. The CUDA side refuses a plan it
cannot run (``md_conv3x3``: ``wb`` one of 64, 32, 16, 8 dividing W, ``hb`` a
power of two, ``wb hb`` at most 128), so these checks are what keeps every
convolution and product of the models launchable. The networks are built on
the meta device: channel counts come from the port's own modules, widths from
the three resolutions the port runs (256^2, 576^2, 768^2). No JAX here.
"""

from __future__ import annotations

import math

import pytest
import torch
from torch import nn

from mikudance_tpu_torch.core import configs
from mikudance_tpu_torch.kernels import _gemm_plan as plans
from mikudance_tpu_torch.kernels import conv2d
from mikudance_tpu_torch.models import layers, unet, vae, vae_temporal

RESOLUTIONS = (256, 576, 768)
WIDTHS = (320, 256, 160, 128)  # the tile widths md_linear / md_conv3x3 instantiate


def check_column_tile(cout: int) -> int:
    bn = plans.column_tile(cout)
    assert bn in WIDTHS
    nw = bn // 2 if bn > 256 else bn  # wgmma's N: a multiple of 8 up to 256
    assert nw % 8 == 0 and nw <= 256
    if cout % bn:  # masked: only where no tile of the same rule divides Cout
        assert bn == plans.FALLBACK_TILE
        assert all(cout % t for t in plans.COLUMN_TILES)
    assert 0 <= math.ceil(cout / bn) * bn - cout < bn  # the last tile holds a column
    return bn


def padded(plan, images: int, height: int) -> int:
    """Image rows x images the tiles of a plan cover."""
    return math.ceil(height / plan.hb) * plan.hb * math.ceil(images / plan.nb) * plan.nb


def check_conv_plan(images: int, height: int, width: int, cout: int):
    plan = plans.tile_plan(images, height, width, cout)
    assert width % plan.wb == 0
    assert plan.wb == max(b for b in plans.BOX_WIDTHS if width % b == 0)
    assert plan.wb * plan.hb * plan.nb == plans.TILE_PIXELS == 128
    assert plan.hb & (plan.hb - 1) == 0 and plan.nb & (plan.nb - 1) == 0
    # never more rows than boxes of one image each (the tallest box)
    one_image = plans.TilePlan(plan.bn, plan.wb, 128 // plan.wb, 1)
    assert padded(plan, images, height) <= padded(one_image, images, height)
    assert plan.bn == check_column_tile(cout)  # whatever the grid
    return plan


def test_box_width_divides_every_width_up_to_1024():
    for width in range(8, 1025, 8):
        for images, height in ((1, 1), (1, width), (2, 5), (3, 24), (32, width), (16, 7)):
            check_conv_plan(images, height, width, 320)
    with pytest.raises(ValueError, match="multiple of 8"):
        plans.tile_plan(1, 12, 12, 320)


def test_column_tile_divides_cout_or_masks_the_last_tile():
    for cout in list(range(1, 8)) + list(range(8, 10241, 8)):
        check_column_tile(cout)
    assert [plans.column_tile(c) for c in (320, 640, 1280, 2560, 10240, 768, 512, 480, 136, 4)] \
        == [320, 320, 320, 320, 320, 256, 256, 160, 128, 128]


def test_box_spans_images_where_a_tall_box_would_waste_rows():
    # the UNet's 24 x 24 level (768^2): 8 x 8 boxes of two images, no row wasted
    assert plans.tile_plan(32, 24, 24, 1280)[1:] == (8, 8, 2)
    assert plans.tile_plan(32, 96, 96, 320)[1:] == (32, 4, 1)
    assert plans.tile_plan(8, 768, 768, 128)[1:] == (64, 2, 1)
    assert plans.tile_plan(1, 24, 24, 1280)[1:] == (8, 16, 1)  # one image: a tall box


def _convs(model: nn.Module):
    """(Cin, Cout) of the stride-1 3x3 convolutions K8 can take (Cin a
    multiple of 8, at least conv2d.MIN_CIN), by the module's own weights."""
    pairs = set()
    for m in model.modules():
        if (isinstance(m, nn.Conv2d) and m.kernel_size == (3, 3) and m.stride == (1, 1)
                and m.padding == (1, 1) and m.in_channels >= conv2d.MIN_CIN
                and m.in_channels % 8 == 0):
            pairs.add((m.in_channels, m.out_channels))
    return sorted(pairs)


NETWORKS = {  # name -> (constructor, widths at a resolution r)
    "denoising UNet": (lambda: unet.DenoisingUNet(), lambda r: [r // 8 >> i for i in range(4)]),
    "guidance UNet and MAN": (lambda: unet.GuidanceUNet(configs.GuidanceUNetConfig(use_man=True)),
                              lambda r: [r // 8 >> i for i in range(4)]),
    "SD VAE encoder": (lambda: vae.Encoder(), lambda r: [r >> i for i in range(4)]),
    "SD VAE decoder": (lambda: vae.Decoder(), lambda r: [r >> i for i in range(4)]),
    "temporal decoder": (lambda: vae_temporal.TemporalDecoder(),
                         lambda r: [r >> i for i in range(4)]),
}


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_plans_of_the_models_convolutions(name):
    build, widths = NETWORKS[name]
    with torch.device("meta"):
        pairs = _convs(build())
    assert pairs, name
    cases = 0
    for res in RESOLUTIONS:
        for width in widths(res):
            if width % 8:  # conv2d.applicable keeps these on nn.Conv2d
                continue
            for cin, cout in pairs:
                for images in (1, 2, 32):
                    plan = check_conv_plan(images, width, width, cout)
                    tiles = (math.ceil(images / plan.nb) * (width // plan.wb)
                             * math.ceil(width / plan.hb) * math.ceil(cout / plan.bn))
                    assert tiles < 2 ** 31 and cin % 8 == 0
                    cases += 1
    assert cases


@pytest.mark.parametrize("dim", [320, 640, 1280])
def test_plans_of_the_chains_products(dim):
    """K7's products in the row-major chain of a transformer block: q / k / v
    / to_out, the cross-attention q and to_out, the GEGLU pair."""
    with torch.device("meta"):
        block = layers.TransformerBlock(dim, 8)
    products = [m for m in block.modules() if isinstance(m, nn.Linear)]
    assert products
    for m in products:
        assert m.in_features % 8 == 0 and m.out_features % 8 == 0
        check_column_tile(m.out_features)
