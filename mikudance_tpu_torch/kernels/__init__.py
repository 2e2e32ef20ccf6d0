"""The port's kernels: wrappers, plain versions, the build, the switches."""

import contextlib


@contextlib.contextmanager
def row_major():
    """The JAX package's whole-loop row-major configuration of the sampler
    for a ``with`` block: ``models.layers.PALLAS_CHAIN`` and
    ``kernels.conv2d.PREFER_PALLAS`` on, ``kernels.flash_attention``'s
    ``TRANSPOSED_FULLC`` and ``NEUTRAL_FULLC`` off. The transformer blocks run
    as the chain of K6 / K7 / attention, the stride-1 3x3 convolutions through
    K8, packed-heads self-attention through K10 / K11. The four switches are
    restored on the way out, also after an exception. The same weights serve
    both configurations: every switch is read at call time."""
    from . import conv2d, flash_attention
    from ..models import layers

    switches = ((layers, "PALLAS_CHAIN", True), (conv2d, "PREFER_PALLAS", True),
                (flash_attention, "TRANSPOSED_FULLC", False),
                (flash_attention, "NEUTRAL_FULLC", False))
    saved = [getattr(mod, name) for mod, name, _ in switches]
    for mod, name, value in switches:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for (mod, name, _), value in zip(switches, saved):
            setattr(mod, name, value)
