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
