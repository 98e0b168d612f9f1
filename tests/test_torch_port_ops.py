"""The port's ops (``mage_tpu_torch.ops``) against the JAX ops they port.

On the CPU each op runs its plain PyTorch version, the oracle its Hopper
kernel is checked against on the card (``chip_smoke.py``). Inputs come from
``numpy.random.RandomState`` and go to both packages; everything is f32.
The JAX side runs both its XLA path and its Pallas kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mage_tpu.ops import axial_attention as jax_axial  # noqa: E402
from mage_tpu.ops import cached_attention as jax_cached  # noqa: E402
from mage_tpu.ops import vq as jax_vq  # noqa: E402
from mage_tpu_torch.ops import (  # noqa: E402
    axial_slot_attention,
    cached_slot_attention,
    codebook_lookup,
    nearest_codebook_indices,
    nearest_with_codes,
)
from mage_tpu_torch.ops import vq as torch_vq  # noqa: E402

JAX_IMPLS = ["xla", "pallas_interpret"]


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("n", [64, 37])  # 37: ragged against the kernel's tiles
def test_nearest_codebook_ids_match_jax(impl, n):
    """Ids identical to JAX, including a planted exact tie (lowest index wins)."""
    rng = np.random.RandomState(0)
    z = rng.randn(n, 32).astype(np.float32)
    cb = rng.randn(16, 32).astype(np.float32)
    cb[9] = cb[3]  # codes 3 and 9 are equal ...
    z[5] = cb[3]   # ... and token 5 sits on them: an exact tie
    want = np.asarray(jax_vq.nearest_codebook_indices(jnp.asarray(z), jnp.asarray(cb),
                                                      impl=impl))
    got = nearest_codebook_indices(torch.from_numpy(z), torch.from_numpy(cb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[5] == 3


def test_nearest_with_codes_keeps_batch_shape_and_gathers():
    rng = np.random.RandomState(1)
    z = torch.from_numpy(rng.randn(2, 3, 5, 8).astype(np.float32))
    cb = torch.from_numpy(rng.randn(12, 8).astype(np.float32))
    idx, codes = nearest_with_codes(z, cb)
    assert idx.shape == (2, 3, 5) and codes.shape == (2, 3, 5, 8)
    torch.testing.assert_close(codes, codebook_lookup(cb, idx), rtol=0, atol=0)
    torch.testing.assert_close(idx, nearest_codebook_indices(z, cb, impl="torch"))
    with pytest.raises(ValueError):
        nearest_codebook_indices(z, cb, impl="pallas")


@pytest.mark.parametrize("dtype,n,k,d,offset,want", [
    (torch.bfloat16, 8192, 512, 1024, 0, "wgmma"),  # the main path's shape
    (torch.bfloat16, 129, 520, 1040, 0, "wgmma"),
    (torch.bfloat16, 5, 7, 3, 0, "simt"),           # rows not 16-byte multiples
    (torch.bfloat16, 64, 512, 1024, 1, "simt"),     # base not 16-byte aligned
    (torch.float32, 8192, 512, 1024, 0, "simt"),    # f32: sequential FMAs
])
def test_vq_route_picks_the_kernel_variant_from_the_inputs(dtype, n, k, d, offset, want):
    """``route`` (the choice the CUDA wrapper passes to the kernel) sends
    bf16 with D % 8 == 0 and 16-byte aligned bases to the TMA/wgmma variant
    and everything else to the SIMT one."""
    z = torch.zeros(n * d + 8, dtype=dtype)[offset:offset + n * d].view(n, d)
    cb = torch.zeros(k, d, dtype=dtype)
    assert z.data_ptr() % 16 == (0 if offset == 0 else offset * z.element_size())
    assert torch_vq.route(z, cb) == want


G, S, D, HEADS = 20, 6, 64, 2  # G=20 is ragged against the JAX kernel's 8-row tiles


@pytest.mark.parametrize("impl", JAX_IMPLS)
def test_axial_slot_attention_matches_jax(impl):
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(G, S, D).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_axial.axial_slot_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), HEADS, impl=impl))
    got = axial_slot_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), HEADS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", JAX_IMPLS)
def test_axial_slot_attention_matches_jax_at_main_width(impl):
    """The main path's width (S=16, D=512, 16 heads of 32) on 5 groups: the
    oracle the card's kernel is held to."""
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(5, 16, 512).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_axial.axial_slot_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 16, impl=impl))
    got = axial_slot_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


N, L = 44, 5  # N=44 is ragged against the JAX kernel's 8-row tiles


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("pos", range(L))
def test_cached_slot_attention_matches_jax(impl, pos):
    rng = np.random.RandomState(3)
    q = rng.randn(N, D).astype(np.float32)
    ck = rng.randn(L, N, D).astype(np.float32)
    cv = rng.randn(L, N, D).astype(np.float32)
    want = np.asarray(jax_cached.cached_slot_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.int32(pos), HEADS,
        impl=impl))
    got = cached_slot_attention(torch.from_numpy(q), torch.from_numpy(ck),
                                torch.from_numpy(cv), pos, HEADS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_cached_slot_attention_ignores_slots_after_pos():
    """Slots after ``pos`` carry exactly zero weight: the kernel's licence
    to skip reading them."""
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(N, D).astype(np.float32))
    ck = torch.from_numpy(rng.randn(L, N, D).astype(np.float32))
    cv = torch.from_numpy(rng.randn(L, N, D).astype(np.float32))
    a = cached_slot_attention(q, ck, cv, 2, HEADS)
    ck[3:] = 1e4
    cv[3:] = -1e4
    b = cached_slot_attention(q, ck, cv, 2, HEADS)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
