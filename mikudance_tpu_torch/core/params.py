"""Parameter utilities."""

from __future__ import annotations

import torch
from torch import nn


def cast_params(module: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Cast every floating parameter and buffer (e.g. to bf16 for serving), in place."""
    return module.to(dtype=dtype)

