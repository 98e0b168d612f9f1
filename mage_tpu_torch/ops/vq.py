"""Vector quantization: nearest codebook ids and the codebook gather.

``nearest_codebook_indices`` is the port of ``mage_tpu/ops/vq.py`` (same
layouts, same math): ``dist = |e|^2 - 2 z.e`` in f32, argmin with ties to
the lowest index. On a CUDA tensor it launches the hand-written kernel in
``csrc/vq.cu``; on a CPU tensor, or with ``impl="torch"``, it runs the plain
version ``_vq_plain``, which is also the oracle the kernel is checked
against.

The straight-through gradient (``vq_straight_through``) comes with training.
"""

from __future__ import annotations

import ctypes

import torch

from mage_tpu_torch import _build

KERNEL = _build.Kernel(
    "mage_vq_nearest",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)


def _vq_plain(z_flat: torch.Tensor, codebook: torch.Tensor):
    """Plain version (the reference math of ``_vq_xla``)."""
    z = z_flat.float()
    cb = codebook.float()
    dist = (cb * cb).sum(dim=1)[None, :] - 2.0 * (z @ cb.T)
    idx = torch.argmin(dist, dim=1).to(torch.int32)  # first minimum on ties
    return idx, codebook[idx]


def _vq_cuda(z_flat: torch.Tensor, codebook: torch.Tensor):
    _build.check_cuda("nearest_codebook_indices", z_flat, codebook)
    n, d = z_flat.shape
    k = codebook.shape[0]
    if codebook.shape[1] != d:
        raise ValueError(f"codebook width {codebook.shape[1]} != token width {d}")
    cbsq = torch.empty(k, dtype=torch.float32, device=z_flat.device)
    idx = torch.empty(n, dtype=torch.int32, device=z_flat.device)
    codes = torch.empty((n, d), dtype=codebook.dtype, device=z_flat.device)
    KERNEL(z_flat.data_ptr(), codebook.data_ptr(), cbsq.data_ptr(), idx.data_ptr(),
           codes.data_ptr(), n, k, d, _build.dtype_code(z_flat),
           _build.stream_ptr(z_flat.device))
    return idx, codes


def nearest_with_codes(z: torch.Tensor, codebook: torch.Tensor, *, impl: str = "auto"):
    """(..., D) tokens -> ((...,) int32 ids, (..., D) codes)."""
    batch_shape = z.shape[:-1]
    d = z.shape[-1]
    z_flat = z.reshape(-1, d)
    if _build.use_kernel(impl, z_flat):
        idx, codes = _vq_cuda(z_flat.contiguous(), codebook.contiguous())
    else:
        idx, codes = _vq_plain(z_flat, codebook)
    return idx.reshape(batch_shape), codes.reshape(*batch_shape, d)


def nearest_codebook_indices(z: torch.Tensor, codebook: torch.Tensor, *,
                             impl: str = "auto") -> torch.Tensor:
    """Nearest-neighbour codebook ids for ``z``: (..., D) -> (...,) int32."""
    return nearest_with_codes(z, codebook, impl=impl)[0]


def codebook_lookup(codebook: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``codebook[idx]``: (...,) int -> (..., D)."""
    return codebook[idx.long()]
