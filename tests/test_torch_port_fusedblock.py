"""The fused whole-block spatial route (``spatial_attn="fusedblock"``) against
the JAX package's ``MAGE_SPATIAL_ATTN=fusedblock_interpret``.

The op is held against JAX's ``_block_pallas`` in interpret mode (the TPU
kernel ``_block_kernel`` run on the CPU) on the same numpy inputs and
weights, in f32 and in bf16; the block, MAGE and MAGE+ against JAX's
modules with the same carried weights, in f32. JAX reads the variable while
it traces, so each JAX call is a fresh ``jax.jit`` of a lambda made after
``monkeypatch.setenv``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mage_tpu.models import layers as jl  # noqa: E402
from mage_tpu.ops.axial_attention import _block_pallas  # noqa: E402
from mage_tpu_torch.compat import from_jax  # noqa: E402
from mage_tpu_torch.models import layers as tl  # noqa: E402
from mage_tpu_torch.models.pipeline import MagePipeline  # noqa: E402
from mage_tpu_torch.ops import axial_attention as ax  # noqa: E402

D = 64
F32_TOL = 1e-5
BF16_STEP = 2.0 ** -7  # one bf16 rounding step, relative
LAYERS = dict(text_layers=2, ma_layers=1, dec_layers=3)


def _weights(rng, d, n_head):
    """JAX-layout block parameters ((in, out) weights, (1, F) rows) at the
    TPU kernel's init scale at D=64, narrowed as 1 / sqrt(fan-in) past it so
    wider blocks keep D=64's magnitudes, LayerNorm near unit."""
    def mat(i, o):
        return (rng.randn(i, o) * 0.02 * 8 * min(1.0, (64 / i) ** 0.5)).astype(np.float32)

    def row(n, base=0.0, scale=0.1):
        return (base + rng.randn(1, n) * scale).astype(np.float32)

    return (row(d, 1.0), row(d),
            mat(d, d), row(d), mat(d, d), row(d), mat(d, d), row(d),
            mat(d, d), row(d), row(d, 1.0), row(d),
            mat(d, 4 * d), row(4 * d), mat(4 * d, d), row(d))


def _port_params(jax_params):
    """(in, out) weights -> torch's (out, in); (1, F) rows -> (F,)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(p.T if p.shape[0] > 1 else p[0]))
                 for p in jax_params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,s,n_head,tile_g", [(7, 6, 2, 4), (10, 1, 4, 4), (3, 16, 4, 2)])
def test_op_matches_jax_block_kernel(dtype, g, s, n_head, tile_g):
    """Ragged G against the TPU kernel's tile. f32 within 1e-5; bf16 within
    one bf16 step of the output (an intermediate may round to its neighbour
    after a sum taken in another order)."""
    rng = np.random.RandomState(g * 100 + s)
    x = rng.randn(g, s, D).astype(np.float32)
    params = _weights(rng, D, n_head)
    jdt = jnp.dtype(dtype)
    want = _block_pallas(jnp.asarray(x, jdt), tuple(jnp.asarray(p, jdt) for p in params),
                         n_head, eps=1e-5, tile_g=tile_g, interpret=True)
    tdt = getattr(torch, dtype)
    got = ax.axial_block_fused(torch.from_numpy(x).to(tdt),
                               tuple(p.to(tdt) for p in _port_params(params)), n_head)
    assert got.dtype == tdt and got.shape == (g, s, D)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_STEP, atol=BF16_STEP)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,s,d,n_head,tile_g", [(3, 32, 64, 2, 2), (5, 8, 128, 2, 4)])
def test_op_matches_jax_block_kernel_at_the_kernel_limits(dtype, g, s, d, n_head, tile_g):
    """S=32 (two groups a 64-row tile of the card's kernel) and hd=64 (D=128,
    2 heads). f32 within 1e-5. bf16 within one step of each value plus one
    step of the largest |output|: at these sizes an intermediate (seq, whose
    residual reaches the output) that rounds to its bf16 neighbour moves an
    output by a step at seq's magnitude, as the card's checks allow."""
    rng = np.random.RandomState(g * 1000 + s + d)
    x = rng.randn(g, s, d).astype(np.float32)
    params = _weights(rng, d, n_head)
    jdt = jnp.dtype(dtype)
    want = _block_pallas(jnp.asarray(x, jdt), tuple(jnp.asarray(p, jdt) for p in params),
                         n_head, eps=1e-5, tile_g=tile_g, interpret=True)
    tdt = getattr(torch, dtype)
    got = ax.axial_block_fused(torch.from_numpy(x).to(tdt),
                               tuple(p.to(tdt) for p in _port_params(params)), n_head)
    assert got.dtype == tdt and got.shape == (g, s, d)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_STEP,
                                   atol=BF16_STEP * float(np.abs(want).max()))


def test_op_without_a_card_raises_instead_of_falling_back():
    """The kernel path takes CUDA tensors only; on the CPU the dispatcher
    picks the plain version because the tensor lies there, and asking the
    kernel wrapper directly raises."""
    rng = np.random.RandomState(0)
    params = _port_params(_weights(rng, D, 2))
    x = torch.from_numpy(rng.randn(2, 4, D).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        ax._block_cuda(x, params, 2, 1e-5)
    torch.testing.assert_close(ax.axial_block_fused(x, params, 2),
                               ax.axial_block_fused(x, params, 2, impl="torch"),
                               rtol=0, atol=0)


@pytest.mark.parametrize("axial_dim", [2, 3])
def test_fusedblock_axial_block_matches_jax(axial_dim, monkeypatch):
    monkeypatch.setenv("MAGE_SPATIAL_ATTN", "fusedblock_interpret")
    x = np.random.RandomState(30 + axial_dim).randn(2, 3, 5, 4, D).astype(np.float32)
    jb = jl.AxialAttentionBlock(d_model=D, n_head=2, dropout=0.1, axial_dim=axial_dim)
    params = jax.jit(lambda k, a: jb.init(k, a, train=False))(
        jax.random.PRNGKey(axial_dim), jnp.asarray(x))["params"]
    want = jax.jit(lambda p, a: jb.apply({"params": p}, a, attn_bias=None, train=False))(
        params, jnp.asarray(x))
    tb = tl.AxialAttentionBlock(D, 2, axial_dim=axial_dim, spatial_attn="fusedblock").eval()
    from_jax.load(tb, from_jax.export_axial_block(params))
    with torch.no_grad():
        got = tb(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    # the fused route reads the block's own parameters, no copy
    fused = tb.fused_block_params()
    assert fused[2].data_ptr() == tb.attn.in_proj_weight.data_ptr()
    assert fused[14] is tb.mlp.c_proj.weight


def test_unknown_spatial_attn_raises():
    with pytest.raises(ValueError, match="spatial_attn"):
        tl.AxialAttentionBlock(D, 2, axial_dim=2, spatial_attn="pallas")
    with pytest.raises(ValueError, match="spatial_attn"):
        MagePipeline(**_mage_config(), device="cpu", spatial_attn="fused")


# ---- MAGE and MAGE+ ------------------------------------------------------------

B, FRAMES, LAT = 2, 4, 4


def _common(use_cids):
    return dict(
        text_encoder_config={"target": "mage_tpu.models.layers.TransformerTextEncoder",
                             "params": {"vocab_size": 30, "context_length": 12,
                                        "transformer_width": D, "transformer_layers": 2,
                                        "output_dim": D, "padding_idx": 0, "dropout": 0.1}},
        ma_config={"target": "mage_tpu.models.layers.MAEncoder",
                   "params": {"layers": 1, "d_model": D}},
        generate_decoder_config={"target": "mage_tpu.models.mage.FlatAxialDecoder",
                                 "params": {"layers": 3, "model_channels": D,
                                            "in_channels": D,
                                            "out_channels": 16 if use_cids else 4,
                                            "frames_length": FRAMES}},
        frames_length=FRAMES, image_resolution=LAT, vision_width=D, dropout=0.1,
        use_cids=use_cids, randomness=False)


def _mage_config():
    return dict(first_stage_config={"target": "mage_tpu.models.vqvae.VectorQuantizedVAE",
                                    "params": {"input_dim": 3, "down_ratio": 8, "dim": 8,
                                               "K": 16}},
                codebook_size=16, **_common(True))


def _magep_config():
    dd = {"double_z": True, "z_channels": 4, "resolution": 8, "in_channels": 3, "out_ch": 3,
          "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [],
          "dropout": 0.0}
    return dict(first_stage_config={"target": "mage_tpu.models.autoencoder_kl.AutoencoderKL",
                                    "params": {"embed_dim": 4, "ddconfig": dd}},
                codebook_size=512, **_common(False))


def _inputs(seed, use_cids):
    rng = np.random.RandomState(seed)
    text = np.zeros((B, 12), np.int32)
    text[:, 0] = 1
    text[:, 1:4] = rng.randint(3, 29, size=(B, 3))
    text[:, 4] = 2
    lat0 = (rng.randint(0, 16, size=(B, 1, LAT, LAT)).astype(np.int32) if use_cids
            else rng.randn(B, 1, LAT, LAT, 4).astype(np.float32))
    return (lat0, text, rng.rand(B).astype(np.float32),
            rng.randn(B, LAT, LAT, 64).astype(np.float32))


def _jax_pipeline(config, use_cids):
    import flax

    from mage_tpu.models.autoencoder_kl import FirstStageKL as JaxFirstStageKL
    from mage_tpu.models.pipeline import MagePipeline as JaxPipeline
    from mage_tpu.models.vqvae import VectorQuantizedVAE as JaxVQVAE

    # the first stage's own init, jitted (the JAX pipeline runs it eagerly)
    fs_params = config["first_stage_config"]["params"]
    res = LAT * (8 if use_cids else 2)  # VQ-VAE f8, KL-AE f2 (ch_mult 1, 2)
    frame = jnp.zeros((1, res, res, 3), jnp.float32)
    if use_cids:
        model = JaxVQVAE(**fs_params)
        fs_vars = jax.jit(lambda k: model.init(k, frame, train=True))(jax.random.PRNGKey(0))
    else:
        model = JaxFirstStageKL.from_config(fs_params, variables={}).model
        fs_vars = jax.jit(lambda k: model.init({"params": k}, frame, k))(jax.random.PRNGKey(0))
    jp = JaxPipeline(**config, first_stage_variables=fs_vars)
    batch = {"images": np.zeros((B, FRAMES, res, res, 3), np.float32),
             "text": _inputs(0, True)[1], "speed": np.zeros(B, np.float32)}
    params = flax.core.unfreeze(jax.jit(lambda k: jp.init(k, batch))(jax.random.PRNGKey(0)))
    if not use_cids:  # a live continuous head (JAX zero-initialises its conv)
        out_conv = params["generate_model"]["out_conv"]
        out_conv["kernel"] = jnp.asarray(
            np.random.RandomState(9).randn(*out_conv["kernel"].shape) * 0.3, jnp.float32)
    return jp, params


def _both_samplers(jp, params, args, monkeypatch):
    monkeypatch.setenv("MAGE_SPATIAL_ATTN", "fusedblock_interpret")
    out = {}
    for method in ("generate_cached", "generate"):
        fn = jax.jit(lambda p, *a, _m=method: jp.core.apply({"params": p}, *a, method=_m))
        out[method] = np.asarray(fn(params, *(jnp.asarray(a) for a in args)))
    return out


def _port_core(config, jp, params, spatial_attn):
    tp = MagePipeline(**config, device="cpu", spatial_attn=spatial_attn)
    from_jax.load_pipeline(tp, params, jp.first_stage.variables, **LAYERS)
    return tp.core


def _run(core, args):
    lat0, text, speed, noise = (torch.from_numpy(a) for a in args)
    return {m: getattr(core, m)(lat0, text, speed, video_noise=noise).numpy()
            for m in ("generate_cached", "generate")}


def test_mage_fusedblock_ids_match_jax(monkeypatch):
    """Both samplers' ids bit-identical to JAX's fused route; the flat route
    strict-loads the same carried state dict and gives the same ids."""
    config = _mage_config()
    jp, params = _jax_pipeline(config, True)
    args = _inputs(1, True)
    want = _both_samplers(jp, params, args, monkeypatch)
    fused = _port_core(config, jp, params, "fusedblock")
    flat = _port_core(config, jp, params, "flat")
    assert fused.state_dict().keys() == flat.state_dict().keys()
    got, got_flat = _run(fused, args), _run(flat, args)
    for method, ids in want.items():
        assert got[method].shape == (B, FRAMES - 1, LAT, LAT)
        np.testing.assert_array_equal(got[method], ids, err_msg=method)
        np.testing.assert_array_equal(got_flat[method], ids, err_msg=method)


def test_magep_fusedblock_latents_match_jax(monkeypatch):
    """Both samplers' continuous latents within 1e-4 of JAX's fused route."""
    config = _magep_config()
    jp, params = _jax_pipeline(config, False)
    args = _inputs(2, False)
    want = _both_samplers(jp, params, args, monkeypatch)
    got = _run(_port_core(config, jp, params, "fusedblock"), args)
    for method, lat in want.items():
        assert got[method].shape == (B, FRAMES - 1, LAT, LAT, 4)
        assert float(np.std(got[method])) > 0.01, method  # a live head
        np.testing.assert_allclose(got[method], lat, rtol=0, atol=1e-4, err_msg=method)
