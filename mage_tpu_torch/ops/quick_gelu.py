"""QuickGELU, ``x * sigmoid(1.702 x)``, forward and backward each in one pass.

It replaces no kernel of the JAX package, where XLA fuses the activation
(``mage_tpu/models/layers.py::quick_gelu``). On a CUDA tensor ``quick_gelu``
launches ``csrc/quick_gelu.cu``: the forward alone when no gradient is
needed, else ``_QuickGelu``, which saves x only and whose backward launches
the gradient kernel. The forward is bit-equal to ``quick_gelu_plain`` on the
card (the same rounding points); the backward computes in f32 and rounds
once (``quick_gelu_grad_plain``, its oracle). On a CPU tensor it runs
``quick_gelu_plain``, with autograd through it.

The kernels take contiguous, 16-byte aligned f32 or bf16 tensors of any
shape and raise on anything else.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from mage_tpu_torch import _build

KERNEL = _build.Kernel("mage_quick_gelu", [ctypes.c_void_p] * 2
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
KERNEL_BWD = _build.Kernel("mage_quick_gelu_bwd", [ctypes.c_void_p] * 3
                           + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def quick_gelu_plain(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), as the JAX package writes it."""
    return x * torch.sigmoid(1.702 * x)


def quick_gelu_grad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The backward kernel's formula: ``g * (s + x s (1 - s) 1.702)`` with
    ``s = sigmoid(1.702 x)``, in f32 (or x's wider dtype), rounded once to
    x's dtype."""
    wide = torch.promote_types(x.dtype, torch.float32)
    xw, gw = x.to(wide), g.to(wide)
    s = torch.sigmoid(xw * 1.702)
    return (gw * (s + (xw * (s * (1 - s))) * 1.702)).to(x.dtype)


def _check(name: str, *tensors: torch.Tensor) -> None:
    """Dtype, layout and alignment first (so that they are checked whatever
    the device), then the shared device checks."""
    for t in tensors:
        if t.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel takes 16-byte aligned tensors")
        if t.shape != tensors[0].shape:
            raise ValueError(f"{name}: shapes {tuple(tensors[0].shape)} and {tuple(t.shape)}")
    _build.check_cuda(name, *tensors)


@_build.launcher("quick_gelu")
def _forward_cuda(x: torch.Tensor) -> torch.Tensor:
    _check("quick_gelu", x)
    y = torch.empty_like(x)
    KERNEL(x.data_ptr(), y.data_ptr(), x.numel(), _build.dtype_code(x),
           _build.stream_ptr(x.device))
    return y


@_build.launcher("quick_gelu_bwd")
def _backward_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    _check("quick_gelu_bwd", x, g)
    dx = torch.empty_like(x)
    KERNEL_BWD(x.data_ptr(), g.data_ptr(), dx.data_ptr(), x.numel(), _build.dtype_code(x),
               _build.stream_ptr(x.device))
    return dx


class _QuickGelu(torch.autograd.Function):
    """The forward kernel, saving x only; the backward kernel from x and
    the output's gradient."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _forward_cuda(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _backward_cuda(x, g.contiguous())


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(1.702 x)`` in x's dtype: the kernels for a CUDA tensor
    (through ``_QuickGelu`` when autograd records and x needs a gradient),
    ``quick_gelu_plain`` for a CPU tensor."""
    if not _on_card(x):
        return quick_gelu_plain(x)
    if torch.is_grad_enabled() and x.requires_grad:
        return _QuickGelu.apply(x)
    return _forward_cuda(x)
