"""Helpers of the toolbox networks: a container module for their key
grammar, and the switch that keeps their convolutions in fp32."""

import contextlib

import torch
from torch import nn


@contextlib.contextmanager
def fp32_convolutions():
    """cuDNN's convolutions in fp32 inside the block, PyTorch's setting
    restored after. PyTorch lets cuDNN round convolution inputs to TF32 by
    default; the drivers run their networks in fp32, the precision at which
    they are held to the CPU."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class Namespace(nn.Module):
    """A module whose attributes name a reference checkpoint's key path
    (``text_model.encoder.layers.{i}.self_attn.q_proj``): it holds children
    and computes nothing."""

    def __init__(self, **children: nn.Module):
        super().__init__()
        for name, child in children.items():
            setattr(self, name, child)
