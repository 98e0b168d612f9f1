"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each test needs a CUDA device and skips without one (the decision is taken
inside the test). The shapes are ragged against the kernels' tiles, which
``chip_smoke.py`` (main-path shapes only) does not reach. On the card's
machine, which has no JAX, run them with
``python3 -m pytest --noconftest -q tests/test_torch_port_kernels.py``.
"""

import pytest
import torch

from mage_tpu_torch.ops import axial_attention as ax
from mage_tpu_torch.ops import cached_attention as ca
from mage_tpu_torch.ops import gn_conv as gc
from mage_tpu_torch.ops import vq

DTYPES = [torch.float32, torch.bfloat16]
# f32: the same math in another order; bf16: one rounding step of the output
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2**-7, atol=1e-5)}


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,k,d", [(1000, 100, 72), (33, 512, 1024), (5, 7, 3)])
def test_vq_kernel_matches_plain(gen, dtype, n, k, d):
    z = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
    cb = torch.randn(k, d, generator=gen, device="cuda").to(dtype)
    cb[k // 2] = cb[k // 3]  # an exact tie: the lower index must win
    z[0] = cb[k // 3]
    before = vq.KERNEL.launches
    idx, codes = vq.nearest_with_codes(z, cb)
    assert vq.KERNEL.launches == before + 1
    ref_idx, _ = vq.nearest_with_codes(z, cb, impl="torch")
    assert int(idx[0]) == k // 3 and int(ref_idx[0]) == k // 3
    torch.testing.assert_close(codes, cb[idx.long()], rtol=0, atol=0)
    dist = (cb.double() ** 2).sum(1)[None] - 2 * z.double() @ cb.double().T
    rows = torch.arange(n, device="cuda")
    gap = (dist[rows, idx.long()] - dist[rows, ref_idx.long()]).abs()
    assert bool((gap <= 1e-5 * dist.abs().amax(1)).all())  # differ only at near-ties


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g,s,d,heads", [(37, 7, 64, 2), (3, 16, 512, 16), (10, 1, 96, 3)])
def test_axial_kernel_matches_plain(gen, dtype, g, s, d, heads):
    q, k, v = (torch.randn(g, s, d, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    got = ax.axial_slot_attention(q, k, v, heads)
    want = ax.axial_slot_attention(q, k, v, heads, impl="torch")
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,length,d,heads", [(1001, 5, 64, 2), (7, 16, 512, 16),
                                              (130, 3, 256, 8)])
def test_cached_kernel_matches_plain(gen, dtype, n, length, d, heads):
    q = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
    ck = torch.randn(length, n, d, generator=gen, device="cuda").to(dtype)
    cv = torch.randn(length, n, d, generator=gen, device="cuda").to(dtype)
    for pos in range(length):
        got = ca.cached_slot_attention(q, ck, cv, pos, heads)
        want = ca.cached_slot_attention(q, ck, cv, pos, heads, impl="torch")
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_kernels_reject_what_they_do_not_take(gen):
    q = torch.randn(4, 8, 64, generator=gen, device="cuda")
    with pytest.raises(ValueError):
        ax.axial_slot_attention(q, q, q, 3)  # 64 % 3 != 0
    with pytest.raises(TypeError):
        ax.axial_slot_attention(q.half(), q.half(), q.half(), 2)
    with pytest.raises(ValueError):
        ca.cached_slot_attention(q[0], q, q, 8, 2)  # pos past the cache
    with pytest.raises(TypeError):
        vq.nearest_codebook_indices(q[0], q[0].to(torch.bfloat16))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c,cout", [(3, 1, 7, 16, 48), (1, 5, 130, 32, 16),
                                          (2, 16, 16, 512, 512)])
def test_gn_conv_kernel_matches_plain(gen, dtype, b, h, w, c, cout, monkeypatch):
    """16 GroupNorm groups (C=16 has no 32). bf16: one rounding step of the
    output, plus a 1e-3 floor for the rare activation that rounds to the
    neighbouring bf16 value (the kernel and the plain version sum in other
    orders)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x = (torch.randn(b, h, w, c, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    gamma = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1
    beta = torch.randn(c, generator=gen, device="cuda") * 0.2
    weight = torch.randn(cout, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5
    bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
    before = gc.KERNEL.launches
    got = gc.gn_silu_conv3x3(x, gamma, beta, weight, bias, groups=16)
    assert gc.KERNEL.launches == before + 1
    want = gc.gn_silu_conv3x3(x, gamma, beta, weight, bias, groups=16, impl="torch")
    assert got.shape == (b, h, w, cout) and got.dtype == dtype
    tol = TOL[dtype] if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-3)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_gn_conv_rejects_what_it_does_not_take(gen):
    x = torch.randn(2, 4, 4, 32, generator=gen, device="cuda")
    ones, zeros = torch.ones(32, device="cuda"), torch.zeros(32, device="cuda")
    weight = torch.randn(32, 32, 3, 3, generator=gen, device="cuda")
    with pytest.raises(ValueError):  # C % 16 != 0
        gc.gn_silu_conv3x3(x[..., :24].contiguous(), ones[:24], zeros[:24],
                           weight[:, :24].contiguous(), zeros)
    with pytest.raises(ValueError):  # not contiguous
        gc.gn_silu_conv3x3(x.transpose(1, 2), ones, zeros, weight, zeros)
    with pytest.raises(ValueError):  # a parameter on the CPU
        gc.gn_silu_conv3x3(x, ones, zeros, weight.cpu(), zeros)


def _block_params(gen, d, dtype):
    """The fused block's parameters at normal(0.02) scale, LayerNorms near unit."""
    def t(*shape, base=0.0, scale=0.02):
        return (base + torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    return (t(d, base=1.0, scale=0.1), t(d), t(d, d), t(d), t(d, d), t(d), t(d, d), t(d),
            t(d, d), t(d), t(d, base=1.0, scale=0.1), t(d), t(4 * d, d), t(4 * d),
            t(d, 4 * d), t(d))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g,s,d,heads", [(37, 7, 64, 2), (3, 16, 512, 16), (10, 1, 96, 3)])
def test_axial_block_kernel_matches_plain(gen, dtype, g, s, d, heads):
    """Ragged G against the kernel's 32-row tile. bf16: one rounding step of
    each value plus 2**-7 of the largest |output|, for an intermediate (seq,
    whose residual reaches the output) that rounds to its neighbouring bf16
    value (the kernel and the plain version sum in other orders)."""
    x = torch.randn(g, s, d, generator=gen, device="cuda").to(dtype)
    params = _block_params(gen, d, dtype)
    before = ax.KERNEL_BLOCK.launches
    got = ax.axial_block_fused(x, params, heads)
    assert ax.KERNEL_BLOCK.launches == before + 1
    want = ax.axial_block_fused(x, params, heads, impl="torch")
    assert got.shape == (g, s, d) and got.dtype == dtype
    scale = float(want.float().abs().max())
    tol = TOL[dtype] if dtype == torch.float32 else dict(rtol=2**-7, atol=2**-7 * scale)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_axial_block_rejects_what_it_does_not_take(gen):
    x = torch.randn(4, 8, 64, generator=gen, device="cuda")
    params = _block_params(gen, 64, torch.float32)
    with pytest.raises(ValueError):  # a CPU tensor
        ax._block_cuda(x.cpu(), tuple(p.cpu() for p in params), 2, 1e-5)
    with pytest.raises(TypeError):  # mixed dtypes
        ax.axial_block_fused(x.to(torch.bfloat16), params, 2)
    with pytest.raises(ValueError):  # not contiguous
        ax._block_cuda(x.transpose(0, 1), params, 2, 1e-5)
    with pytest.raises(ValueError):  # a weight that is not contiguous
        ax.axial_block_fused(x, params[:2] + (params[2].T,) + params[3:], 2)
    with pytest.raises(ValueError):  # 64 % 3 != 0
        ax.axial_block_fused(x, params, 3)
    with pytest.raises(ValueError):  # S past the limit
        ax.axial_block_fused(torch.randn(2, ax.BLOCK_MAX_S + 1, 64, generator=gen,
                                         device="cuda"), params, 2)
