"""The VQ-VAE f8 decoder's tail in one op: the last ``DecoderBlock``'s final
3x3 conv, its residual, the decoder's ReLU, 1x1 output conv and tanh.

For h (B, H, W, C), the last block's ``block[5]`` output, and x (B, H / 2,
W / 2, Cout), the block's input and id path,
``vq_decode_tail(h, x, w7, b7, w8, b8)`` is

    tanh(conv1x1_w8(relu(up2(x) + conv3x3_w7(relu(h)) + b7)) + b8)

(B, H, W, O), where ``up2`` is the nearest 2x upsample; w7 (Cout, C, 3, 3),
b7 and w8 (O, Cout, 1, 1), b8 are the ``nn.Conv2d`` parameters of
``block[7]`` and ``decoder[8]``. It replaces no kernel of the JAX package:
on a CUDA tensor it launches ``csrc/vq_decode_tail.cu``, which writes only
the O-channel frames (the layer chain writes several 256-channel tensors at
128 px); on a CPU tensor, or with ``impl="torch"``, it runs
``_vq_tail_plain``, the kernel's oracle, which computes in f32 from the
inputs and the weights in h's dtype and rounds once at the end.

The kernel takes bf16 only, the f8 decoder's widths at dim 256 (C = 64,
Cout = 256, O = 3: ``kernel_takes``) and even H and W, and raises on
anything else.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mage_tpu_torch import _build
from mage_tpu_torch.ops.gn_conv import _packed

KERNEL = _build.Kernel(
    "mage_vq_decode_tail",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
)


def kernel_takes(c: int, cout: int, out_channels: int) -> bool:
    """Whether the kernel takes a tail of C -> Cout (3x3) -> O (1x1)."""
    return (c, cout, out_channels) == (64, 256, 3)


def _vq_tail_plain(h, x, w7, b7, w8, b8) -> torch.Tensor:
    """Plain version: relu(h) and the weights in h's dtype, then everything
    in f32 (the conv's sums, + b7, + the upsampled x, the ReLU, the 1x1
    product, + b8, tanh) and one rounding to h's dtype."""
    dt = h.dtype
    a = F.relu(h).float().permute(0, 3, 1, 2)
    s = F.conv2d(a, w7.to(dt).float(), padding=1).permute(0, 2, 3, 1) + b7.to(dt).float()
    s = s + x.float().repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    w = w8.to(dt).float().reshape(w8.shape[0], -1)
    out = F.relu(s) @ w.T + b8.to(dt).float()
    return torch.tanh(out).to(dt)


@_build.launcher("vq_tail")
def _vq_tail_cuda(h, x, w7, b7, w8, b8) -> torch.Tensor:
    _build.check_cuda("vq_decode_tail", h, x, w8, b8)
    if h.dtype != torch.bfloat16:
        raise TypeError(f"vq_decode_tail: the kernel takes bfloat16, got {h.dtype}")
    for t in (w7, b7):
        if t.device != h.device:
            raise ValueError(f"vq_decode_tail: h on {h.device}, a parameter on {t.device}")
    b, hh, ww, c = h.shape
    cout, o = w7.shape[0], w8.shape[0]
    if not kernel_takes(c, cout, o) or hh % 2 or ww % 2:
        raise ValueError(f"vq_decode_tail: the kernel takes 64 -> 256 -> 3 channels and even "
                         f"H, W; got h {tuple(h.shape)}, {c} -> {cout} -> {o}")
    if h.data_ptr() % 16 or x.data_ptr() % 4:
        raise ValueError("vq_decode_tail: h must be 16-byte and x 4-byte aligned")
    wk, b7_32 = _packed(w7, b7, h.dtype)
    out = torch.empty((b, hh, ww, o), dtype=h.dtype, device=h.device)
    KERNEL(h.data_ptr(), x.data_ptr(), wk.data_ptr(), b7_32.data_ptr(), w8.data_ptr(),
           b8.data_ptr(), out.data_ptr(), b, hh, ww, _build.stream_ptr(h.device))
    return out


def vq_decode_tail(h: torch.Tensor, x: torch.Tensor, w7: torch.Tensor, b7: torch.Tensor,
                   w8: torch.Tensor, b8: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """``tanh(conv1x1(relu(up2(x) + conv3x3(relu(h)) + b7)) + b8)``: h (B, H,
    W, C), x (B, H / 2, W / 2, Cout), w7 (Cout, C, 3, 3), b7 (Cout,), w8 (O,
    Cout, 1, 1), b8 (O,) -> (B, H, W, O) in h's dtype."""
    b, hh, ww, c = h.shape
    cout = w7.shape[0]
    if (tuple(w7.shape[1:]) != (c, 3, 3) or tuple(x.shape) != (b, hh // 2, ww // 2, cout)
            or w8.shape[1] != cout):
        raise ValueError(f"vq_decode_tail: h {tuple(h.shape)}, x {tuple(x.shape)}, w7 "
                         f"{tuple(w7.shape)} and w8 {tuple(w8.shape)} do not match")
    if _build.use_kernel(impl, h):
        return _vq_tail_cuda(h, x, w7, b7, w8, b8)
    return _vq_tail_plain(h, x, w7, b7, w8, b8)
