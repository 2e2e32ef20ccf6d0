"""Parameter utilities."""

from __future__ import annotations

import torch
from torch import nn


def cast_params(module: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Cast every floating parameter and buffer (e.g. to bf16 for serving), in place."""
    return module.to(dtype=dtype)



def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on. ``None`` means the CUDA card and
    raises where there is none: a run on the CPU has to be asked for by name
    (``device="cpu"``), it never happens by default."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device=\"cpu\" to run on "
                               "the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
