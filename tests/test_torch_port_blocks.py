"""The port's modules against the JAX modules they port, block by block.

Each JAX module is initialised, its parameters are carried across by
``mage_tpu_torch.compat.from_jax`` and strict-loaded into the port's
module, and both run on the same numpy inputs in f32 with dropout off.
The carrier itself is held key for key, shape for shape and value for value
against the JAX package's exporter (``mage_tpu.compat.torch_export``), here
for the VQ-VAE and in ``test_torch_port_pipeline.py`` for the core.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mage_tpu.compat import torch_export  # noqa: E402
from mage_tpu.models import layers as jl  # noqa: E402
from mage_tpu.models.mage import causal_temporal_bias as jax_bias  # noqa: E402
from mage_tpu.models.vqvae import VectorQuantizedVAE as JaxVQVAE  # noqa: E402
from mage_tpu_torch.compat import from_jax  # noqa: E402
from mage_tpu_torch.models import layers as tl  # noqa: E402
from mage_tpu_torch.models.mage import causal_temporal_bias  # noqa: E402
from mage_tpu_torch.models.vqvae import VectorQuantizedVAE  # noqa: E402

D, HEADS = 64, 2
RTOL, ATOL = 1e-5, 1e-5  # f32, same math in another summation order


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _axial_pair(axial_dim, x):
    jb = jl.AxialAttentionBlock(d_model=D, n_head=HEADS, dropout=0.1, axial_dim=axial_dim)
    params = jb.init(jax.random.PRNGKey(axial_dim), jnp.asarray(x), train=False)["params"]
    tb = tl.AxialAttentionBlock(D, HEADS, axial_dim=axial_dim)
    from_jax.load(tb, from_jax.export_axial_block(params))
    return jb, {"params": params}, tb


@pytest.mark.parametrize("axial_dim", [1, 2, 3])
def test_axial_block_forward(axial_dim):
    x = np.random.RandomState(axial_dim).randn(2, 4, 3, 5, D).astype(np.float32)
    jb, variables, tb = _axial_pair(axial_dim, x)
    bias = jax_bias(4) if axial_dim == 1 else None
    want = jb.apply(variables, jnp.asarray(x), attn_bias=bias, train=False)
    got = tb(_t(x), attn_bias=causal_temporal_bias(4) if axial_dim == 1 else None)
    _close(got, want)


def test_causal_temporal_bias_matches_jax():
    np.testing.assert_array_equal(causal_temporal_bias(5).numpy(), np.asarray(jax_bias(5)))


@pytest.mark.parametrize("pos", [0, 2, 3])
def test_axial_block_incremental_temporal(pos):
    rng = np.random.RandomState(10 + pos)
    x = rng.randn(2, 4, 3, 5, D).astype(np.float32)
    slot = rng.randn(2, 3, 5, D).astype(np.float32)
    ck = rng.randn(4, 30, D).astype(np.float32)
    cv = rng.randn(4, 30, D).astype(np.float32)
    jb, variables, tb = _axial_pair(1, x)
    y, jk, jv = jb.apply(variables, jnp.asarray(slot), jnp.asarray(ck), jnp.asarray(cv),
                         jnp.int32(pos), method="incremental_temporal")
    tk, tv = _t(ck.copy()), _t(cv.copy())
    got = tb.incremental_temporal(_t(slot), tk, tv, pos)
    _close(got, y)
    _close(tk, jk)  # written in place at slot pos
    _close(tv, jv)


@pytest.mark.parametrize("axial_dim", [2, 3])
def test_axial_block_single_slot_spatial(axial_dim):
    rng = np.random.RandomState(20 + axial_dim)
    x = rng.randn(2, 1, 3, 5, D).astype(np.float32)
    jb, variables, tb = _axial_pair(axial_dim, x)
    want = jb.apply(variables, jnp.asarray(x[:, 0]), method="single_slot_spatial")
    _close(tb.single_slot_spatial(_t(x[:, 0])), want)


def test_text_encoder_with_padding():
    text = np.array([[1, 5, 7, 9, 2, 0, 0, 0], [1, 4, 2, 0, 0, 0, 0, 0]], np.int32)
    je = jl.TransformerTextEncoder(vocab_size=30, transformer_width=D, transformer_layers=2,
                                   output_dim=48, context_length=8)
    params = je.init(jax.random.PRNGKey(0), jnp.asarray(text), train=False)["params"]
    te = tl.TransformerTextEncoder(vocab_size=30, transformer_width=D, transformer_layers=2,
                                   output_dim=48, context_length=8)
    from_jax.load(te, from_jax.export_text_encoder(params, 2, prefix=""))
    want = je.apply({"params": params}, jnp.asarray(text), train=False)
    _close(te(_t(text)), want)


def test_ma_encoder():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 16, D).astype(np.float32)
    kv = rng.randn(2, 8, D).astype(np.float32)
    jm = jl.MAEncoder(layers=2, d_model=D, dropout=0.1)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(kv),
                     train=False)["params"]
    tm = tl.MAEncoder(layers=2, d_model=D)
    from_jax.load(tm, from_jax.export_ma_encoder(params, 2, prefix=""))
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(kv), train=False)
    _close(tm(_t(x), _t(kv)), want)


def test_adain2d():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 4, 4, 32).astype(np.float32)
    y = rng.randn(2, 4, 4, 32).astype(np.float32)
    ja = jl.AdaIN2D(32)
    params = ja.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(y))["params"]
    ta = tl.AdaIN2D(32)
    from_jax.load(ta, from_jax.export_adain(params, prefix=""))
    want = ja.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
    _close(ta(_t(x), _t(y)), want)


@pytest.fixture(scope="module")
def vqvae_pair():
    jm = JaxVQVAE(input_dim=3, down_ratio=8, dim=8, K=16)
    variables = jax.jit(lambda key: jm.init(key, jnp.zeros((1, 64, 64, 3)), train=True))(
        jax.random.PRNGKey(3))
    tm = VectorQuantizedVAE(input_dim=3, down_ratio=8, dim=8, K=16)
    from_jax.load(tm, from_jax.export_vqvae(variables, 8))
    return jm, variables, tm


def test_vqvae_encode_ids_and_decode_pixels(vqvae_pair):
    jm, variables, tm = vqvae_pair
    frames = np.random.RandomState(7).rand(3, 64, 64, 3).astype(np.float32) * 2 - 1
    want_ids = jax.jit(lambda v, x: jm.apply(v, x, method="encode"))(
        variables, jnp.asarray(frames))
    ids = tm.encode(_t(frames))
    assert ids.shape == (3, 8, 8)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    want = jax.jit(lambda v, i: jm.apply(v, i, method="decode"))(variables, want_ids)
    _close(tm.decode(ids), want)


def test_carrier_matches_jax_exporter_vqvae(vqvae_pair):
    _, variables, _ = vqvae_pair
    _assert_same_state(from_jax.export_vqvae(variables, 8),
                       torch_export.export_vqvae(variables, down_ratio=8))


def _assert_same_state(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        a, b = np.asarray(ours[key]), np.asarray(theirs[key])
        assert a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
