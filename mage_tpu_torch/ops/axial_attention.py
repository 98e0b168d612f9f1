"""Unmasked multi-head attention along S on a flat (G, S, D) layout.

Port of ``mage_tpu/ops/axial_attention.py::axial_slot_attention``: the
sampler's spatial (H and W) blocks attend over one short axis for G
independent groups. On a CUDA tensor it launches the hand-written kernel in
``csrc/axial_attention.cu``; on a CPU tensor, or with ``impl="torch"``, it
runs ``_axial_plain`` (the math of ``_axial_xla``), the kernel's oracle.

The whole-block fused variant (``_block_kernel``) is not ported yet.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mage_tpu_torch import _build

KERNEL = _build.Kernel(
    "mage_axial_attention",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
)
_SMEM_LIMIT = 227 * 1024  # bytes of shared memory one Hopper block may use


def _axial_plain(q, k, v, n_head: int) -> torch.Tensor:
    """Plain version. Scores and softmax run in f32 (as in the TPU kernel);
    the result is cast back to the input dtype."""
    g, s, d = q.shape
    hd = d // n_head
    qh = q.float().reshape(g, s, n_head, hd)
    kh = k.float().reshape(g, s, n_head, hd)
    vh = v.float().reshape(g, s, n_head, hd)
    scores = torch.einsum("gqhd,gkhd->ghqk", qh, kh) / math.sqrt(hd)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("ghqk,gkhd->gqhd", w, vh).reshape(g, s, d).to(q.dtype)


def _axial_cuda(q, k, v, n_head: int) -> torch.Tensor:
    _build.check_cuda("axial_slot_attention", q, k, v)
    g, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or d % n_head:
        raise ValueError(f"q, k, v must share (G, S, D) with D % n_head == 0, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    hd = d // n_head
    smem = 4 * (2 * s * hd + s * (hd + 1) + s * s)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S={s}, head width {hd} need {smem} bytes of shared memory")
    out = torch.empty_like(q)
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g, s, d, n_head,
           _build.dtype_code(q), _build.stream_ptr(q.device))
    return out


def axial_slot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n_head: int, *, impl: str = "auto") -> torch.Tensor:
    """(G, S, D) q, k, v with heads merged in D -> (G, S, D)."""
    if _build.use_kernel(impl, q):
        return _axial_cuda(q.contiguous(), k.contiguous(), v.contiguous(), n_head)
    return _axial_plain(q, k, v, n_head)
