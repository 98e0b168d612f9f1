"""Single-slot causal attention over a time-major (L, N, D) KV cache.

Port of ``mage_tpu/ops/cached_attention.py::cached_slot_attention``
(unquantized cache): each of N queries attends over the cache slots
``0..pos``. On a CUDA tensor it launches the hand-written kernel in
``csrc/cached_attention.cu``; on a CPU tensor, or with ``impl="torch"``, it
runs ``_attn_plain`` (the math of ``_attn_xla``, additive bias -1e9 past
``pos``), the kernel's oracle.

The quantized cache (the JAX package's ``MAGE_KV_QUANT``; here the
decoder's ``kv_quant`` option) is ``quantize_kv_slot`` and
``cached_slot_attention_quant``, plain PyTorch on every device, as JAX
runs them in XLA: no kernel is launched for it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mage_tpu_torch import _build

NEG_INF = -1e9

KERNEL = _build.Kernel(
    "mage_cached_attention",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
)
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements per 16-byte load


def _attn_plain(q, cache_k, cache_v, pos: int, n_head: int) -> torch.Tensor:
    """Plain version: softmax(q.K^T / sqrt(hd) + bias) V per head, in f32,
    with bias -1e9 on slots after ``pos``; cast back to the input dtype."""
    n, d = q.shape
    length = cache_k.shape[0]
    hd = d // n_head
    bias = torch.where(torch.arange(length, device=q.device) <= pos, 0.0, NEG_INF)
    qh = q.float().reshape(n, n_head, hd)
    kh = cache_k.float().reshape(length, n, n_head, hd)
    vh = cache_v.float().reshape(length, n, n_head, hd)
    scores = torch.einsum("nhd,knhd->nhk", qh, kh) / math.sqrt(hd)
    scores = scores + bias.to(scores.dtype).reshape(1, 1, length)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("nhk,knhd->nhd", w, vh).reshape(n, d).to(q.dtype)


@_build.launcher("cached")
def _attn_cuda(q, cache_k, cache_v, pos: int, n_head: int) -> torch.Tensor:
    _build.check_cuda("cached_slot_attention", q, cache_k, cache_v)
    n, d = q.shape
    length = cache_k.shape[0]
    if cache_k.shape != (length, n, d) or cache_v.shape != cache_k.shape:
        raise ValueError(f"caches must be (L, {n}, {d}), got {tuple(cache_k.shape)} "
                         f"and {tuple(cache_v.shape)}")
    if not 0 <= pos < length:
        raise ValueError(f"pos {pos} outside the cache's {length} slots")
    vec = _VEC[q.dtype]
    hd = d // n_head if d % n_head == 0 else 0
    lanes = hd // vec
    threads_per_row = d // vec
    rows = 1 if threads_per_row >= 256 else 256 // threads_per_row
    if (hd == 0 or hd % vec or lanes & (lanes - 1) or lanes > 32
            or threads_per_row > 1024 or (threads_per_row * rows) % 32):
        raise ValueError(f"D={d} with {n_head} heads does not fit the kernel's "
                         f"{vec}-wide loads")
    for t in (q, cache_k, cache_v):
        if t.data_ptr() % 16:
            raise ValueError("cached_slot_attention: tensors must be 16-byte aligned")
    out = torch.empty_like(q)
    KERNEL(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), out.data_ptr(), n, d,
           n_head, int(pos), _build.dtype_code(q), _build.stream_ptr(q.device))
    return out


def cached_slot_attention(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, pos: int, n_head: int, *,
                          impl: str = "auto") -> torch.Tensor:
    """(N, D) queries over (L, N, D) caches, keys after ``pos`` masked -> (N, D)."""
    if _build.use_kernel(impl, q):
        return _attn_cuda(q.contiguous(), cache_k.contiguous(), cache_v.contiguous(),
                          int(pos), n_head)
    return _attn_plain(q, cache_k, cache_v, int(pos), n_head)


# ---- quantized KV cache (``kv_quant="int8"|"int4"``) ------------------------


def quantize_kv_slot(x: torch.Tensor, n_head: int, bits: int = 8):
    """Symmetric per-head quantization of one new cache slot: x (N, D) ->
    (codes (N, D) int8, scale (1, n_head) f32), scale = max(amax, 1e-8) /
    qmax with qmax = 2**(bits-1) - 1 and codes = clip(round(x / scale)).
    Rounding is half to even, as ``jnp.round``. Torch has no int4 dtype, so
    4-bit codes are int8 values clipped to +-7: they take int8's bytes."""
    n, d = x.shape
    hd = d // n_head
    qmax = float(2 ** (bits - 1) - 1)
    xf = x.float().reshape(n, n_head, hd)
    amax = xf.abs().amax(dim=(0, 2))  # (H,)
    # true divisions by tensors: CUDA divides by a Python scalar through its
    # reciprocal, one ulp off the quotient XLA computes
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, qmax)
    codes = torch.clamp(torch.round(xf / scale[None, :, None]), -qmax, qmax)
    return codes.reshape(n, d).to(torch.int8), scale[None, :]


def cached_slot_attention_quant(q: torch.Tensor, cache_k: torch.Tensor,
                                cache_v: torch.Tensor, scale_k: torch.Tensor,
                                scale_v: torch.Tensor, pos: int,
                                n_head: int) -> torch.Tensor:
    """``cached_slot_attention`` over (L, N, D) int8 code caches with
    (L, n_head) f32 per-slot, per-head scales: the codes are cast to q's
    dtype, scores[n, h, l] are multiplied by scale_k[l, h] before the bias
    and the softmax, and the weights by scale_v[l, h] before the value sum,
    each scale cast to the dtype of what it multiplies (as JAX casts them).
    Slots after ``pos`` get the -1e9 bias -> (N, D) in q's dtype."""
    n, d = q.shape
    length = cache_k.shape[0]
    hd = d // n_head
    bias = torch.where(torch.arange(length, device=q.device) <= int(pos), 0.0, NEG_INF)
    qh = q.reshape(n, n_head, hd)
    kh = cache_k.reshape(length, n, n_head, hd).to(q.dtype)
    vh = cache_v.reshape(length, n, n_head, hd).to(q.dtype)
    scores = torch.einsum("nhd,knhd->nhk", qh, kh) / torch.sqrt(
        torch.tensor(float(hd), dtype=q.dtype, device=q.device))
    scores = scores * scale_k.T[None].to(scores.dtype)  # (1, H, L)
    scores = scores + bias.to(scores.dtype).reshape(1, 1, length)
    w = torch.softmax(scores, dim=-1)
    w = w * scale_v.T[None].to(w.dtype)
    return torch.einsum("nhk,knhd->nhd", w, vh).reshape(n, d)
