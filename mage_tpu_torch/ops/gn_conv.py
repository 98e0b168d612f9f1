"""Fused GroupNorm -> SiLU -> 3x3 conv for the KL-AE decoder (inference).

Port of ``mage_tpu/ops/gn_conv.py``. Every decoder ``ResnetBlock`` chain is
``GroupNorm -> silu -> conv3x3``. The GroupNorm statistics stay plain
PyTorch reductions (``gn_affine_rows``) and collapse to per-(image, channel)
affine rows ``a``, ``b`` in f32; ``gn_silu_conv3x3`` then computes
``conv3x3(silu(x * a + b)) + bias`` with the zero padding applied after the
activation. On a CUDA tensor it launches the hand-written kernel in
``csrc/gn_conv.cu``; on a CPU tensor, or with ``impl="torch"``, it runs
``_gn_conv_plain``, which follows ``gn_silu_conv3x3_xla`` rounding point for
rounding point and is the kernel's oracle.

Layouts are the JAX package's: x (B, H, W, C) NHWC, output (B, H, W, Cout).
The weight is the (Cout, C, 3, 3) tensor of the ``nn.Conv2d`` state dict.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mage_tpu_torch import _build

KERNEL = _build.Kernel(
    "mage_gn_silu_conv3x3",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)


def gn_affine_rows(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   groups: int, eps: float):
    """Per-(B, C) f32 rows (a, b) with GroupNorm(x) == x * a + b: statistics
    in f32 over (H, W, C // groups), variance as E[x^2] - mean^2 clamped at
    0, as in the JAX package and flax's ``nn.GroupNorm``. Both sums
    accumulate in f32 straight from x's dtype (the sum of squares as a
    squared 2-norm), so a bf16 x is never copied to f32."""
    b, h, w, c = x.shape
    gs = c // groups
    xg = x.reshape(b, h * w, groups, gs)
    n = h * w * gs
    mean = xg.sum(dim=(1, 3), dtype=torch.float32) / n
    sumsq = torch.linalg.vector_norm(xg, 2, dim=(1, 3), dtype=torch.float32).square()
    var = torch.clamp(sumsq / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    a = gamma.float()[None, :] * inv.repeat_interleave(gs, dim=1)
    return a, beta.float()[None, :] - mean.repeat_interleave(gs, dim=1) * a


def _gn_conv_plain(x, gamma, beta, weight, bias, groups: int, eps: float) -> torch.Tensor:
    """Plain version: the activation rounded to x's dtype, the conv in f32 on
    the rounded activation and the weight rounded to x's dtype, the bias
    added in f32, one final cast."""
    a, b = gn_affine_rows(x, gamma, beta, groups, eps)
    h = F.silu(x.float() * a[:, None, None, :] + b[:, None, None, :]).to(x.dtype)
    out = F.conv2d(h.float().permute(0, 3, 1, 2), weight.to(x.dtype).float(), padding=1)
    return (out.permute(0, 2, 3, 1) + bias.float()).to(x.dtype).contiguous()


def _gn_conv_cuda(x, gamma, beta, weight, bias, groups: int, eps: float) -> torch.Tensor:
    _build.check_cuda("gn_silu_conv3x3", x)
    for t in (gamma, beta, weight, bias):
        if t.device != x.device:
            raise ValueError(f"gn_silu_conv3x3: x on {x.device}, a parameter on {t.device}")
    b, h, w, c = x.shape
    cout = weight.shape[0]
    if c % 16 or cout % 16:
        raise ValueError(f"gn_silu_conv3x3: the kernel takes C and Cout that are "
                         f"multiples of 16, got {c} -> {cout}")
    if x.data_ptr() % 16:
        raise ValueError("gn_silu_conv3x3: x must be 16-byte aligned")
    a, shift = gn_affine_rows(x, gamma, beta, groups, eps)
    # (Cout, C, 3, 3) -> (Cout, 9 * C): w[o][(dy * 3 + dx) * C + c]
    wk = weight.to(x.dtype).permute(0, 2, 3, 1).reshape(cout, 9 * c).contiguous()
    bias32 = bias.float().contiguous()
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    KERNEL(x.data_ptr(), a.data_ptr(), shift.data_ptr(), wk.data_ptr(), bias32.data_ptr(),
           out.data_ptr(), b, h, w, c, cout, _build.dtype_code(x),
           _build.stream_ptr(x.device))
    return out


def gn_silu_conv3x3(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    weight: torch.Tensor, bias: torch.Tensor, *, groups: int = 32,
                    eps: float = 1e-6, impl: str = "auto") -> torch.Tensor:
    """``conv3x3(silu(GroupNorm(x)), weight, bias)``: x (B, H, W, C), gamma
    and beta (C,), weight (Cout, C, 3, 3), bias (Cout,) -> (B, H, W, Cout) in
    x's dtype. The kernel takes contiguous x with C and Cout multiples of 16
    and raises on anything else."""
    if x.ndim != 4 or tuple(weight.shape[1:]) != (x.shape[-1], 3, 3):
        raise ValueError(f"gn_silu_conv3x3: x {tuple(x.shape)} (B, H, W, C) and weight "
                         f"{tuple(weight.shape)} (Cout, C, 3, 3) do not match")
    if _build.use_kernel(impl, x):
        return _gn_conv_cuda(x, gamma, beta, weight, bias, groups, eps)
    return _gn_conv_plain(x, gamma, beta, weight, bias, groups, eps)
