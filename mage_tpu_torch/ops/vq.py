"""Vector quantization: nearest codebook ids and the codebook gather.

``nearest_codebook_indices`` is the port of ``mage_tpu/ops/vq.py`` (same
layouts, same math): ``dist = |e|^2 - 2 z.e`` in f32, argmin with ties to
the lowest index. On a CUDA tensor it launches the hand-written kernel in
``csrc/vq.cu``; on a CPU tensor, or with ``impl="torch"``, it runs the plain
version ``_vq_plain``, which is also the oracle the kernel is checked
against.

The kernel has two variants, chosen by :func:`route` from the inputs alone:
``"wgmma"`` (bf16 tensor cores fed by TMA) for bf16 with a width that is a
multiple of 8 and 16-byte aligned rows, which is every shape the main path
gives it, and ``"simt"`` (f32 FMAs in sequence, ids those of an f32
computation) for f32 and any other shape. ``nearest_codebook_indices``
launches it without a codes buffer, so it writes ids only;
``nearest_with_codes`` also has it gather the codes. Both are one entry
point (``KERNEL``) and one launcher (``vq``).

``vq_straight_through`` is the VQ-VAE training forward's quantizer, a
``torch.autograd.Function`` over ``nearest_with_codes`` (the kernel with
codes on a CUDA tensor, the SIMT variant in f32; ``_vq_plain`` on the CPU).
Its backward is plain PyTorch, as the JAX package's ``custom_vjp`` backward
is XLA: the gradient of the codes passes to ``z`` unchanged and is
``index_add_``ed into the chosen codebook rows. The kernel's outputs reach
autograd only through this Function.
"""

from __future__ import annotations

import ctypes

import torch

from mage_tpu_torch import _build

KERNEL = _build.Kernel(
    "mage_vq_nearest",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
)
ROUTES = ("simt", "wgmma")  # position = the C entry's route code


def _vq_plain(z_flat: torch.Tensor, codebook: torch.Tensor):
    """Plain version (the reference math of ``_vq_xla``)."""
    z = z_flat.float()
    cb = codebook.float()
    dist = (cb * cb).sum(dim=1)[None, :] - 2.0 * (z @ cb.T)
    idx = torch.argmin(dist, dim=1).to(torch.int32)  # first minimum on ties
    return idx, codebook[idx]


def route(z_flat: torch.Tensor, codebook: torch.Tensor) -> str:
    """The kernel variant for these (N, D) tokens and (K, D) codebook:
    ``"wgmma"`` when both are bf16 with D % 8 == 0 and 16-byte aligned (TMA
    needs 16-byte rows and bases), ``"simt"`` otherwise."""
    if (z_flat.dtype == torch.bfloat16 and codebook.dtype == torch.bfloat16
            and z_flat.shape[-1] % 8 == 0 and z_flat.data_ptr() % 16 == 0
            and codebook.data_ptr() % 16 == 0):
        return "wgmma"
    return "simt"


@_build.launcher("vq")
def _vq_cuda(z_flat: torch.Tensor, codebook: torch.Tensor, with_codes: bool):
    _build.check_cuda("nearest_codebook_indices", z_flat, codebook)
    n, d = z_flat.shape
    k = codebook.shape[0]
    if codebook.shape[1] != d:
        raise ValueError(f"codebook width {codebook.shape[1]} != token width {d}")
    if k < 1:
        raise ValueError("the codebook is empty")
    dev = z_flat.device
    variant = route(z_flat, codebook)
    cbsq = torch.empty(k, dtype=torch.float32, device=dev)
    # the SIMT variant's cross-CTA merge; the wgmma variant reads no keys
    keys = torch.empty(n, dtype=torch.int64, device=dev) if variant == "simt" else None
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    codes = torch.empty((n, d), dtype=codebook.dtype, device=dev) if with_codes else None
    KERNEL(z_flat.data_ptr(), codebook.data_ptr(), cbsq.data_ptr(),
           None if keys is None else keys.data_ptr(),
           idx.data_ptr(), None if codes is None else codes.data_ptr(), n, k, d,
           _build.dtype_code(z_flat), ROUTES.index(variant), _build.stream_ptr(dev))
    return idx, codes


def _nearest(z: torch.Tensor, codebook: torch.Tensor, impl: str, with_codes: bool):
    d = z.shape[-1]
    z_flat = z.reshape(-1, d)
    if _build.use_kernel(impl, z_flat):
        return _vq_cuda(z_flat.contiguous(), codebook.contiguous(), with_codes)
    return _vq_plain(z_flat, codebook)


def nearest_with_codes(z: torch.Tensor, codebook: torch.Tensor, *, impl: str = "auto"):
    """(..., D) tokens -> ((...,) int32 ids, (..., D) codes)."""
    idx, codes = _nearest(z, codebook, impl, with_codes=True)
    return idx.reshape(z.shape[:-1]), codes.reshape(z.shape)


def nearest_codebook_indices(z: torch.Tensor, codebook: torch.Tensor, *,
                             impl: str = "auto") -> torch.Tensor:
    """Nearest-neighbour codebook ids for ``z``: (..., D) -> (...,) int32.
    The kernel writes no codes for it."""
    return _nearest(z, codebook, impl, with_codes=False)[0].reshape(z.shape[:-1])


class _StraightThrough(torch.autograd.Function):
    """Forward: the exact codes and their ids. Backward: ``grad_z`` is the
    codes' gradient, ``grad_codebook`` its scatter-add into the rows of the
    ids (``_vq_st_bwd`` in the JAX package)."""

    @staticmethod
    def forward(ctx, z, codebook, impl):
        idx, codes = _nearest(z, codebook, impl, with_codes=True)
        ctx.save_for_backward(idx)
        ctx.k = codebook.shape[0]
        ctx.mark_non_differentiable(idx)
        return codes.reshape(z.shape), idx.reshape(z.shape[:-1])

    @staticmethod
    def backward(ctx, g_codes, _g_idx):
        (idx,) = ctx.saved_tensors
        g_codebook = None
        if ctx.needs_input_grad[1]:
            d = g_codes.shape[-1]
            g_codebook = g_codes.new_zeros(ctx.k, d).index_add_(0, idx, g_codes.reshape(-1, d))
        return g_codes, g_codebook, None


def vq_straight_through(z: torch.Tensor, codebook: torch.Tensor, *, impl: str = "auto"):
    """Quantize with straight-through gradients: (..., D) tokens ->
    ((..., D) codes, (...,) int32 ids). The codes are the codebook rows
    themselves, not ``z + (codes - z).detach()``; the ids carry no gradient.
    Pass ``codebook.detach()`` for the reference's detached-codebook call."""
    return _StraightThrough.apply(z, codebook, impl)


def codebook_lookup(codebook: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``codebook[idx]``: (...,) int -> (..., D)."""
    return codebook[idx.long()]
