"""3x3 stride-1 SAME convolution + bias on NHWC tensors.

K8 (``csrc/conv2d.cu``) replaces the TPU kernel
``mikudance_tpu/kernels/conv2d.py::_conv3_kernel``: an implicit GEMM over the
nine taps with fp32 accumulation, the bias added in fp32 and one cast.
``conv3x3_plain`` is its plain PyTorch version (``F.conv2d`` on the NCHW view
of the NHWC tensor).

``PREFER_PALLAS`` is the JAX package's switch of the same name
(``kernels/conv2d.py:34``): when set, ``models/resnet.py::conv_nhwc`` sends
every convolution that ``applicable`` accepts here; the others, and all of
them while it is off, stay on ``nn.Conv2d``. It is read at call time, so one
set of weights serves both configurations.

The weight stays in torch's OIHW layout in the module and its ``state_dict``.
The kernel wants the taps outermost, ``(3, 3, Cout, Cin)``: ``packed_weight``
keeps that copy on the module as a plain attribute (no parameter, no buffer,
not in the ``state_dict``), made at the first call and again whenever the
weight is replaced, written to in place, cast or moved.

Dispatch is by the tensor's device alone: a CPU tensor goes to the plain
version; a CUDA tensor launches the kernel or raises. The wrapper is
differentiable: the backward is the vector-Jacobian product of the plain
version, as in the JAX package (``conv2d.py:146``), so the gradient lands on
the OIHW ``weight`` it was given and never on the packed copy. The kernel
takes bf16 contiguous NHWC ``x`` with ``Cin`` and ``W`` multiples of 8,
16-byte aligned, a bf16 weight and a bf16 or fp32 bias (or none).

The kernel is K7's warpgroup GEMM core (``csrc/gemm_wg.cuh``) with the left
operand of each tap one TMA box of a 4-D map over x; ``_gemm_plan.tile_plan``
picks the output tile: a ``wb`` x ``hb`` rectangle of ``nb`` images by ``bn``
channels.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ._autograd import differentiable, plain_vjp
from ._build import CudaKernel
from ._gemm_plan import tile_plan

K8 = CudaKernel(
    "K8 conv3x3_fused", "md_conv3x3",
    source="mikudance_tpu_torch/csrc/conv2d.cu",
    replaces="mikudance_tpu/kernels/conv2d.py:46",
)

# Route the stride-1 3x3 convolutions through conv3x3_fused (the row-major
# configuration); off by default, as in the JAX package.
PREFER_PALLAS = False

MIN_CIN = 32  # below it (the RGB and latent conv_in) the JAX package keeps its library conv


def applicable(conv: nn.Conv2d, x_nhwc: torch.Tensor) -> bool:
    """The JAX package's rule for its kernel (``conv2d.py:97``): a 3x3
    stride-1 convolution padded by 1 with ``Cin >= 32`` and ``W % 8 == 0``;
    and ``Cin`` a whole number of the 16-byte vectors K8 loads."""
    cin = x_nhwc.shape[-1]
    return (x_nhwc.ndim == 4 and conv.kernel_size == (3, 3) and conv.stride == (1, 1)
            and conv.padding == (1, 1) and conv.dilation == (1, 1) and conv.groups == 1
            and cin >= MIN_CIN and cin % 8 == 0 and x_nhwc.shape[2] % 8 == 0)


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> torch.Tensor:
    """x (N, H, W, Cin), weight (Cout, Cin, 3, 3) -> contiguous (N, H, W, Cout)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), stride=1, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (3, 3, Cout, Cin), contiguous."""
    return weight.detach().permute(2, 3, 0, 1).contiguous()


def packed_weight(conv: nn.Conv2d) -> torch.Tensor:
    """``pack_weight(conv.weight)``, kept on the module and remade when the
    weight's storage, version, dtype or device is no longer what was packed."""
    w = conv.weight
    key = (w.data_ptr(), w._version, w.dtype, w.device)
    cached = getattr(conv, "_md_packed_weight", None)
    if cached is None or cached[0] != key:
        cached = (key, pack_weight(w))
        conv._md_packed_weight = cached
    return cached[1]


def _check_operands(x, weight, bias, packed) -> None:
    if x.ndim != 4 or weight.ndim != 4 or tuple(weight.shape[1:]) != (x.shape[-1], 3, 3):
        raise ValueError(f"conv3x3_fused: need x (N, H, W, Cin) and weight (Cout, Cin, 3, 3), "
                         f"got {tuple(x.shape)} and {tuple(weight.shape)}")
    cout, cin = weight.shape[:2]
    if x.numel() == 0 or cin % 8:
        raise ValueError(f"conv3x3_fused: Cin {cin} must be a multiple of the 8-element "
                         "(16-byte) vector, and x not empty")
    if x.shape[2] % 8:
        raise ValueError(f"conv3x3_fused: image width {x.shape[2]} is not a multiple of 8 "
                         "(the narrowest tile)")
    if tuple(packed.shape) != (3, 3, cout, cin):
        raise ValueError(f"conv3x3_fused: packed weight {tuple(packed.shape)} is not "
                         f"(3, 3, {cout}, {cin})")
    for name, t in (("x", x), ("packed weight", packed)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"conv3x3_fused: {name} must be contiguous bf16 on x's device, got "
                             f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"conv3x3_fused: {name} must start on a 16-byte boundary")
    if bias is not None and (bias.shape != (cout,) or not bias.is_contiguous()
                             or bias.device != x.device
                             or bias.dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError(f"conv3x3_fused: bias must be a contiguous ({cout},) bf16 or fp32 "
                         "tensor on x's device")


def conv3x3_fused(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                  packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8 on CUDA tensors, the plain version on CPU tensors. x (N, H, W, Cin)
    NHWC; weight (Cout, Cin, 3, 3); ``packed`` is ``pack_weight(weight)`` where
    the caller keeps it (``packed_weight``), else it is made here."""
    return differentiable(lambda a, w, b: _conv3x3_fused(a, w, b, packed),
                          plain_vjp(conv3x3_plain), x, weight, bias)


def _conv3x3_fused(x, weight, bias, packed) -> torch.Tensor:
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_fused: unsupported device {x.device}")
    if packed is None:
        packed = pack_weight(weight)
    _check_operands(x, weight, bias, packed)
    n, h, w, cin = x.shape
    cout = weight.shape[0]
    plan = tile_plan(n, h, w, cout)
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    K8.launch(x.data_ptr(), packed.data_ptr(), None if bias is None else bias.data_ptr(),
              y.data_ptr(), n, h, w, cin, cout,
              int(bias is not None and bias.dtype == torch.float32), plan.bn, plan.wb, plan.hb,
              torch.cuda.current_stream(x.device).cuda_stream)
    return y
