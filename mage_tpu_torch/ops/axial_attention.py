"""Spatial axial attention on a flat (G, S, D) layout, alone or as a whole block.

Port of ``mage_tpu/ops/axial_attention.py``. The sampler's spatial (H and W)
blocks attend over one short axis for G independent groups.

- ``axial_slot_attention`` ports ``axial_slot_attention``: the attention
  alone, between the block's projections. On a CUDA tensor it launches the
  hand-written kernel in ``csrc/axial_attention.cu``; on a CPU tensor, or
  with ``impl="torch"``, it runs ``_axial_plain`` (the math of
  ``_axial_xla``), the kernel's oracle.
- ``axial_block_fused`` ports ``axial_block_fused`` (the TPU kernel
  ``_block_kernel``): the whole pre-LN block, LN1 -> QKV -> attention ->
  out-proj -> residual -> LN2 -> QuickGELU MLP -> residual, in one launch of
  ``csrc/axial_block.cu``. ``_block_plain`` rounds to x's dtype at the same
  points as the TPU kernel and is its CPU path and oracle.

Both are differentiable on the kernel route: the gradient is the plain
version's at the same inputs (``_build.launch_differentiable``), so an
eval-mode forward that runs a kernel still trains every parameter.
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
# x, the 16 block parameters and out; G, S, D, n_head, dtype; scale, eps; stream
KERNEL_BLOCK = _build.Kernel(
    "mage_axial_block",
    [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
)
_SMEM_LIMIT = 227 * 1024  # bytes of shared memory one Hopper block may use
# what csrc/axial_block.cu takes (kept equal to its constants)
BLOCK_MAX_S = 32      # S_MAX: the rows of one group fit one block's 32-row tile
BLOCK_MAX_D = 512     # D_MAX: the out-proj and c_proj sums of a row fit in registers
BLOCK_MAX_HD = 64     # one head fits the f32 kernel's 64-column q/k/v chunk


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


@_build.launcher("axial")
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
        return _build.launch_differentiable(
            lambda *qkv: _axial_cuda(*qkv, n_head), lambda *qkv: _axial_plain(*qkv, n_head),
            q.contiguous(), k.contiguous(), v.contiguous())
    return _axial_plain(q, k, v, n_head)


# ---- the whole block ---------------------------------------------------------


def _block_plain(x: torch.Tensor, params, n_head: int, eps: float) -> torch.Tensor:
    """Plain version of the whole block on x (G, S, D). ``params`` is
    (g1, b1, wq, bq, wk, bk, wv, bv, wo, bo, g2, b2, wfc, bfc, wp, bp) with
    torch's (out, in) weights, cast to x's dtype as the TPU kernel's caller
    casts them. Products and LayerNorm run in f32; each named intermediate
    is rounded to x's dtype where the TPU kernel rounds it."""
    dt = x.dtype
    g1, b1, wq, bq, wk, bk, wv, bv, wo, bo, g2, b2, wfc, bfc, wp, bp = (
        p.to(dt).float() for p in params)
    g, s, d = x.shape
    hd = d // n_head

    def ln(y, gamma, beta):
        yf = y.float()
        mu = yf.mean(-1, keepdim=True)
        var = ((yf - mu) ** 2).mean(-1, keepdim=True)
        return ((yf - mu) * torch.rsqrt(var + eps) * gamma + beta).to(dt)

    def mm(a, w, b):
        return (a.float() @ w.T + b).to(dt)

    h = ln(x, g1, b1)
    q, k, v = (mm(h, w, b).float().reshape(g, s, n_head, hd)
               for w, b in ((wq, bq), (wk, bk), (wv, bv)))
    sc = torch.einsum("gqhd,gkhd->ghqk", q * (1.0 / hd ** 0.5), k)
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    w = e / e.sum(-1, keepdim=True)
    attn = torch.einsum("ghqk,gkhd->gqhd", w, v).reshape(g, s, d).to(dt)
    seq = (x.float() + mm(attn, wo, bo).float()).to(dt)
    fc = mm(ln(seq, g2, b2), wfc, bfc).float()
    act = (fc * torch.sigmoid(1.702 * fc)).to(dt)
    return (seq.float() + mm(act, wp, bp).float()).to(dt)


# parameter sets that passed _check_block, by their tensors' addresses,
# shapes, strides, dtype and device: a block's 64 calls a generate check once
_CHECKED_BLOCKS: set = set()


def _check_block(x: torch.Tensor, params, n_head: int) -> None:
    _build.check_cuda("axial_block_fused", x, *params)
    g, s, d = x.shape
    if d % 16 or d > BLOCK_MAX_D or d % n_head:
        raise ValueError(f"D={d}: the kernel takes D a multiple of 16 up to "
                         f"{BLOCK_MAX_D}, divisible by n_head={n_head}")
    hd = d // n_head
    if hd % 8 or hd > BLOCK_MAX_HD:
        raise ValueError(f"head width {hd}: the kernel takes a multiple of 8 up to "
                         f"{BLOCK_MAX_HD}")
    if not 1 <= s <= BLOCK_MAX_S:
        raise ValueError(f"S={s}: the kernel takes 1 <= S <= {BLOCK_MAX_S}")
    want = [(d,), (d,)] + [(d, d), (d,)] * 4 + [(d,), (d,), (4 * d, d), (4 * d,),
                                                 (d, 4 * d), (d,)]
    got = [tuple(p.shape) for p in params]
    if got != want:
        raise ValueError(f"block parameter shapes {got}, expected {want}")
    if any(t.data_ptr() % 16 for t in (x, *params)):
        raise ValueError("the kernel takes 16-byte aligned tensors")


@_build.launcher("axial_block")
def _block_cuda(x: torch.Tensor, params, n_head: int, eps: float) -> torch.Tensor:
    if x.dim() != 3:
        raise ValueError(f"axial_block_fused takes x (G, S, D), got {tuple(x.shape)}")
    key = (x.dtype, x.device, x.shape[1:], n_head,
           tuple((p.data_ptr(), p.shape, p.stride(), p.dtype, p.device) for p in params))
    if key in _CHECKED_BLOCKS:
        _build.check_cuda("axial_block_fused", x)
        if x.data_ptr() % 16:
            raise ValueError("the kernel takes 16-byte aligned tensors")
    else:
        _check_block(x, params, n_head)
        if len(_CHECKED_BLOCKS) > 1024:
            _CHECKED_BLOCKS.clear()
        _CHECKED_BLOCKS.add(key)
    g, s, d = x.shape
    hd = d // n_head
    out = torch.empty_like(x)
    KERNEL_BLOCK(x.data_ptr(), *(p.data_ptr() for p in params), out.data_ptr(),
                 g, s, d, n_head, _build.dtype_code(x), 1.0 / hd ** 0.5, eps,
                 _build.stream_ptr(x.device))
    return out


def axial_block_fused(x: torch.Tensor, params, n_head: int, *, eps: float = 1e-5,
                      impl: str = "auto") -> torch.Tensor:
    """One whole pre-LN attention + QuickGELU MLP block along S of x
    (G, S, D) -> (G, S, D); ``params`` as in ``_block_plain``."""
    if _build.use_kernel(impl, x):
        return _build.launch_differentiable(
            lambda y, *p: _block_cuda(y, p, n_head, eps),
            lambda y, *p: _block_plain(y, p, n_head, eps), x.contiguous(), *params)
    return _block_plain(x, params, n_head, eps)
