"""Seeded weights, made on the device in a few large calls.

The benchmark makes every weight itself, from ``--seed``, and hands the same
values to both sides: the program loads them through its loaders, as it
would a released file (the port's parameters carry the reference's names),
and the reference networks load them in fp32. The names and shapes come from
the reference networks built on the meta device.

Every tensor is a slice of one buffer of uniform draws in [-1, 1) made in
the served type: a weight of two or more dimensions is scaled by
1 / sqrt(fan-in) (PyTorch's default bound), a norm's scale is 1 + 0.1 u, a
bias 0.05 u, anything else (CLIP's class token) 0.02 u.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference import twins


def derive(seed: int, *keys: int) -> int:
    """A 63-bit seed from the run's seed and a path of stream keys."""
    ss = np.random.SeedSequence([seed % (1 << 64)] + [int(k) % (1 << 64) for k in keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def reference_nets(config: dict, parts) -> Dict[str, torch.nn.Module]:
    """The reference networks of ``config`` named in ``parts`` (``vae``,
    ``guide``, ``den``, ``clip``), built on the current default device."""
    u = config["unet"]
    ch, layers, heads = tuple(u["block_out_channels"]), u["layers_per_block"], u["attention_heads"]
    make = {
        "vae": lambda: twins.TAutoencoderKL(tuple(config["vae"]["block_out_channels"]),
                                            config["vae"]["norm_num_groups"],
                                            config["vae"]["layers_per_block"]),
        "guide": lambda: twins.TUNet(ch, layers, heads, u["cross_attention_dim"],
                                     in_ch=config["guidance"]["cond_channels"], man=True,
                                     groups=u["norm_num_groups"], eps=u["norm_eps"]),
        "den": lambda: twins.TUNet(ch, layers, heads, u["cross_attention_dim"], in_ch=4,
                                   motion=True, groups=u["norm_num_groups"], eps=u["norm_eps"],
                                   max_len=config["motion"]["temporal_position_encoding_max_len"]),
        "clip": lambda: twins.TCLIPVision(**config["clip"]),
    }
    return {p: make[p]().eval() for p in parts}


def spec(config: dict, parts) -> List[Tuple[str, str, tuple]]:
    """(part, name, shape) of every weight, in a fixed order."""
    with torch.device("meta"):
        nets = reference_nets(config, parts)
    return [(p, n, tuple(t.shape)) for p in parts for n, t in nets[p].state_dict().items()]


def _rule(name: str, shape: tuple) -> Tuple[float, float]:
    """(scale, offset) of a tensor's uniform draws."""
    if len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    if name.endswith(".weight"):
        return 0.1, 1.0
    if name.endswith(".bias"):
        return 0.05, 0.0
    return 0.02, 0.0


def make(config: dict, parts, seed: int, device, dtype) -> Dict[str, Dict[str, torch.Tensor]]:
    """{part: {name: tensor}}: views of one buffer of seeded draws on
    ``device`` in ``dtype``. The same (config, parts, seed, device, dtype)
    give the same values."""
    items = spec(config, parts)
    sizes = [math.prod(s) for _, _, s in items]
    total = sum(sizes)
    rules = torch.tensor([_rule(n, s) for _, n, s in items], dtype=torch.float32)
    counts = torch.tensor(sizes, device=device)
    g = torch.Generator(device=device).manual_seed(derive(seed, 0))
    buf = torch.rand(total, generator=g, device=device, dtype=dtype)
    buf.mul_(2).sub_(1)
    buf.mul_(torch.repeat_interleave(rules[:, 0].to(device, dtype), counts, output_size=total))
    buf.add_(torch.repeat_interleave(rules[:, 1].to(device, dtype), counts, output_size=total))
    out: Dict[str, Dict[str, torch.Tensor]] = {p: {} for p in parts}
    for (p, n, s), piece in zip(items, buf.split(sizes)):
        out[p][n] = piece.view(s)
    return out
