"""Fused GroupNorm -> SiLU -> 3x3 conv for the KL-AE decoder (inference).

Port of ``mage_tpu/ops/gn_conv.py``. Every decoder ``ResnetBlock`` chain is
``GroupNorm -> silu -> conv3x3``. The GroupNorm statistics collapse to
per-(image, channel) affine rows ``a``, ``b`` in f32 (``gn_stats``: the
hand-written one-pass kernel in ``csrc/gn_stats.cu`` on a CUDA tensor, the
plain ``gn_affine_rows`` otherwise); ``gn_silu_conv3x3`` then computes
``conv3x3(silu(x * a + b)) + bias`` with the zero padding applied after the
activation. On a CUDA tensor it launches the hand-written kernels:
statistics, then ``csrc/gn_conv.cu`` (for bf16 an activation pass into a
scratch tensor, then the TMA/``wgmma`` conv); on a CPU tensor, or with
``impl="torch"``, it runs ``_gn_conv_plain``, which follows
``gn_silu_conv3x3_xla`` rounding point for rounding point and is the
kernels' oracle.

Layouts are the JAX package's: x (B, H, W, C) NHWC, output (B, H, W, Cout).
The weight is the (Cout, C, 3, 3) tensor of the ``nn.Conv2d`` state dict;
the kernel reads it packed as (Cout, 9 * C), made once per parameter
(``_packed``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mage_tpu_torch import _build

KERNEL = _build.Kernel(
    "mage_gn_silu_conv3x3",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
KERNEL_STATS = _build.Kernel(
    "mage_gn_affine_rows",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2
    + [ctypes.c_void_p],
)
# partial-sum blocks the statistics kernel aims for: about 8 on each of the
# H100's 132 SMs, so that enough 16-byte loads are in flight to read x at
# the memory's rate
STATS_BLOCKS = 1024
_PACKED = "_mage_gn_conv_packed"


def gn_affine_rows(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   groups: int, eps: float):
    """Per-(B, C) f32 rows (a, b) with GroupNorm(x) == x * a + b: statistics
    in f32 over (H, W, C // groups), the mean and the mean of the f32
    squares, variance as E[x^2] - mean^2 clamped at 0, as in the JAX package
    and flax's ``nn.GroupNorm``. The plain version of ``gn_stats``."""
    b, h, w, c = x.shape
    gs = c // groups
    xg = x.float().reshape(b, h * w, groups, gs)
    n = h * w * gs
    mean = xg.sum(dim=(1, 3)) / n
    var = torch.clamp((xg * xg).sum(dim=(1, 3)) / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    a = gamma.float()[None, :] * inv.repeat_interleave(gs, dim=1)
    return a, beta.float()[None, :] - mean.repeat_interleave(gs, dim=1) * a


def _stats_splits(batch: int, hw: int) -> int:
    """Pixel ranges each image's statistics are cut into: enough blocks to
    fill the card, at least 32 pixels a range."""
    return max(1, min(-(-STATS_BLOCKS // batch), hw // 32))


def _param_dtype(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype in _build.DTYPE_CODES else t.float()


@_build.launcher("gn_stats")
def _stats_cuda(x, gamma, beta, groups: int, eps: float):
    _build.check_cuda("gn_stats", x)
    if x.ndim != 4:
        raise ValueError(f"gn_stats: x {tuple(x.shape)} is not (B, H, W, C)")
    b, h, w, c = x.shape
    if c % 16 or groups <= 0 or c % groups:
        raise ValueError(f"gn_stats: the kernel takes C a multiple of 16 and of the "
                         f"group count, got C={c}, groups={groups}")
    if x.data_ptr() % 16:
        raise ValueError("gn_stats: x must be 16-byte aligned")
    gamma = _param_dtype(gamma).contiguous()
    beta = beta.to(gamma.dtype).contiguous()
    for t in (gamma, beta):
        if t.device != x.device or tuple(t.shape) != (c,):
            raise ValueError(f"gn_stats: gamma and beta must be ({c},) on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    splits = _stats_splits(b, h * w)
    a = torch.empty((b, c), dtype=torch.float32, device=x.device)
    shift = torch.empty_like(a)
    part = torch.empty(b * splits * c * 2, dtype=torch.float32, device=x.device)
    KERNEL_STATS(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), a.data_ptr(),
                 shift.data_ptr(), part.data_ptr(), b, h * w, c, groups, splits, eps,
                 _build.dtype_code(x), _build.dtype_code(gamma), _build.stream_ptr(x.device))
    return a, shift


def gn_stats(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *, groups: int = 32,
             eps: float = 1e-6, impl: str = "auto"):
    """GroupNorm's per-(B, C) affine rows (a, b) in f32 for x (B, H, W, C):
    the one-pass kernel for a CUDA tensor (contiguous, C a multiple of 16),
    ``gn_affine_rows`` for a CPU tensor or with ``impl="torch"``."""
    if _build.use_kernel(impl, x):
        return _stats_cuda(x, gamma, beta, groups, eps)
    return gn_affine_rows(x, gamma, beta, groups, eps)


def _packed(weight: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype):
    """The kernel's weight (Cout, 9 * C) in ``dtype``, w[o][(dy * 3 + dx) * C +
    c], and the bias in f32. Made once per parameter: cached on the weight
    tensor and made again when the weight or the bias is written in place
    (their version counters), replaced, moved or cast. The cache holds the
    tensors it was made from, so their memory cannot be reused under it."""
    cacheable = not (weight.is_inference() or bias.is_inference())
    if cacheable:
        key = (dtype, weight.data_ptr(), weight._version, tuple(weight.shape),
               bias.data_ptr(), bias._version)
        cached = getattr(weight, _PACKED, None)
        if cached is not None and cached[0] == key:
            return cached[2], cached[3]
    cout, c = weight.shape[:2]
    wk = weight.detach().to(dtype).permute(0, 2, 3, 1).reshape(cout, 9 * c).contiguous()
    bias32 = bias.detach().float().contiguous()
    if cacheable:
        setattr(weight, _PACKED, (key, (weight.detach(), bias.detach()), wk, bias32))
    return wk, bias32


def silu_conv3x3_rows(x, a, b, weight, bias) -> torch.Tensor:
    """The plain version of the conv kernel, on given affine rows a, b (B, C):
    the activation rounded to x's dtype, the conv in f32 on the rounded
    activation and the weight rounded to x's dtype, the bias added in f32,
    one final cast."""
    h = F.silu(x.float() * a[:, None, None, :] + b[:, None, None, :]).to(x.dtype)
    out = F.conv2d(h.float().permute(0, 3, 1, 2), weight.to(x.dtype).float(), padding=1)
    return (out.permute(0, 2, 3, 1) + bias.float()).to(x.dtype).contiguous()


def _gn_conv_plain(x, gamma, beta, weight, bias, groups: int, eps: float) -> torch.Tensor:
    """Plain version of the whole op: ``gn_affine_rows``, then
    ``silu_conv3x3_rows``."""
    a, b = gn_affine_rows(x, gamma, beta, groups, eps)
    return silu_conv3x3_rows(x, a, b, weight, bias)


@_build.launcher("gn_conv")
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
    a, shift = _stats_cuda(x, gamma, beta, groups, eps)
    wk, bias32 = _packed(weight, bias, x.dtype)
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    # bf16: the activated input, once per element, in the kernel's own layout
    act = torch.empty_like(x) if x.dtype == torch.bfloat16 else None
    KERNEL(x.data_ptr(), a.data_ptr(), shift.data_ptr(), wk.data_ptr(), bias32.data_ptr(),
           out.data_ptr(), None if act is None else act.data_ptr(), b, h, w, c, cout,
           _build.dtype_code(x), _build.stream_ptr(x.device))
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
