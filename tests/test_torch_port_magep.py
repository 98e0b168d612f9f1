"""MAGE+ generation in the port against the JAX pipeline's own pieces.

The KL first stage and the continuous stage 2 (``use_cids=False``,
``pre_ln`` cross-attention, causal-GroupNorm head) get the same weights
(carried by ``compat.from_jax``), frame, caption, speed and noise in both
packages, in f32. The JAX side is composed in the order ``mage_tpu``'s
``MagePipeline.generate`` runs: the first frame's posterior moments plus the
numpy posterior noise, ``generate_cached`` and ``generate`` on the core with
the prior noise passed in, then the KL decode. It runs with the JAX defaults
and with the JAX Pallas kernels (spatial, cached attention and the fused
GroupNorm-SiLU-conv) in interpret mode.

JAX zero-initialises the continuous head's conv, which would make every
generated latent 0; the fixture gives it, and ``ln_q``/``ln_kv``, random
values first.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mage_tpu.models.autoencoder_kl import DiagonalGaussian as JaxGaussian  # noqa: E402
from mage_tpu_torch.compat import from_jax  # noqa: E402
from mage_tpu_torch.models.pipeline import FirstStageKL, MagePipeline  # noqa: E402

B, FRAMES, RES, LAT, Z = 2, 4, 16, 8, 4
LAYERS = dict(text_layers=2, ma_layers=1, dec_layers=3)


def _config():
    dd = {"double_z": True, "z_channels": Z, "resolution": RES, "in_channels": 3,
          "out_ch": 3, "ch": 128, "ch_mult": [1, 2], "num_res_blocks": 1,
          "attn_resolutions": [], "dropout": 0.0}
    return dict(
        first_stage_config={"target": "mage_tpu.models.autoencoder_kl.AutoencoderKL",
                            "params": {"monitor": "val/rec_loss", "embed_dim": Z,
                                       "ddconfig": dd}},
        text_encoder_config={"target": "mage_tpu.models.layers.TransformerTextEncoder",
                             "params": {"vocab_size": 30, "context_length": 12,
                                        "transformer_width": 64, "transformer_layers": 2,
                                        "output_dim": 64, "padding_idx": 0,
                                        "dropout": 0.1}},
        ma_config={"target": "mage_tpu.models.layers.MAEncoder",
                   "params": {"layers": 1, "d_model": 64}},
        generate_decoder_config={"target": "mage_tpu.models.mage.FlatAxialDecoder",
                                 "params": {"layers": 3, "model_channels": 64,
                                            "in_channels": 64, "out_channels": Z,
                                            "frames_length": FRAMES}},
        codebook_size=512, frames_length=FRAMES, image_resolution=LAT, vision_width=64,
        dropout=0.1, use_cids=False, randomness=True,
    )


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    text = np.zeros((B, 12), np.int32)
    text[:, 0] = 1
    text[:, 1:4] = rng.randint(3, 29, size=(B, 3))
    text[0, 4] = 2
    text[1, 3] = 2
    return {"images": rng.rand(B, FRAMES, RES, RES, 3).astype(np.float32) * 2 - 1,
            "text": text, "speed": rng.rand(B).astype(np.float32)}


def _noise(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, LAT, LAT, 64).astype(np.float32),
            rng.randn(B, 1, LAT, LAT, Z).astype(np.float32))


@pytest.fixture(scope="module")
def jax_pipeline():
    import flax

    from mage_tpu.models.autoencoder_kl import FirstStageKL as JaxFirstStageKL
    from mage_tpu.models.pipeline import MagePipeline as JaxPipeline

    # the first stage's own init, jitted (FirstStageKL.from_config runs it eagerly)
    model = JaxFirstStageKL.from_config(_config()["first_stage_config"]["params"],
                                        variables={}).model
    fs_vars = jax.jit(model.init)({"params": jax.random.PRNGKey(0)},
                                  jnp.zeros((1, RES, RES, 3), jnp.float32),
                                  jax.random.PRNGKey(0))
    jp = JaxPipeline(**_config(), first_stage_variables=fs_vars)
    params = flax.core.unfreeze(jp.init(jax.random.PRNGKey(0), _batch()))
    rng = np.random.RandomState(9)
    out_conv = params["generate_model"]["out_conv"]
    out_conv["kernel"] = jnp.asarray(rng.randn(*out_conv["kernel"].shape) * 0.3, jnp.float32)
    out_conv["bias"] = jnp.asarray(rng.randn(*out_conv["bias"].shape) * 0.1, jnp.float32)
    for ln in ("ln_q", "ln_kv"):
        p = params["ma_encoder"]["block_0"][ln]
        p["scale"] = jnp.asarray(1 + rng.randn(*p["scale"].shape) * 0.2, jnp.float32)
        p["bias"] = jnp.asarray(rng.randn(*p["bias"].shape) * 0.2, jnp.float32)
    return jp, params


def _port(jp, params):
    tp = MagePipeline(**_config(), device="cpu")
    from_jax.load_pipeline(tp, params, jp.first_stage.variables, **LAYERS)
    return tp


@pytest.mark.parametrize("jax_kernels", ["defaults", "pallas_interpret"])
def test_magep_generate_matches_jax(jax_kernels, jax_pipeline, monkeypatch):
    """Latents of both samplers within 1e-4, frames within 1e-4."""
    if jax_kernels == "pallas_interpret":
        monkeypatch.setenv("MAGE_SPATIAL_ATTN", "pallas_interpret")
        monkeypatch.setenv("MAGE_CACHED_ATTN", "pallas_interpret")
        monkeypatch.setenv("MAGE_KL_FUSED", "gnconv_interpret")
    jp, params = jax_pipeline
    batch = _batch()
    video_noise, post_noise = _noise()
    first = jnp.asarray(batch["images"][:, 0])
    fs_vars = jp.first_stage.variables
    moments = jax.jit(lambda v, x: jp.first_stage.model.apply(v, x, method="encode_moments"))(
        fs_vars, first)
    post = JaxGaussian(moments)
    lat0 = (post.mean + post.std * jnp.asarray(post_noise[:, 0]))[:, None]
    args = (lat0, jnp.asarray(batch["text"]), jnp.asarray(batch["speed"]),
            jnp.asarray(video_noise))

    def core(method):
        return jax.jit(lambda p, *a: jp.core.apply({"params": p}, *a, method=method))

    j_cached = core("generate_cached")(params, *args)
    j_naive = core("generate")(params, *args)
    j_video = jnp.concatenate([first[:, None], jax.jit(jp.first_stage.decode)(j_cached)], 1)

    tp = _port(jp, params)
    t_lat0 = tp.first_stage.encode(torch.from_numpy(batch["images"][:, 0:1]),
                                   noise=torch.from_numpy(post_noise))
    np.testing.assert_allclose(t_lat0.numpy(), np.asarray(lat0), rtol=1e-5, atol=1e-5)
    text, speed = torch.from_numpy(batch["text"]), torch.from_numpy(batch["speed"])
    t_args = (t_lat0, text, speed)
    t_cached = tp.core.generate_cached(*t_args, video_noise=torch.from_numpy(video_noise))
    t_naive = tp.core.generate(*t_args, video_noise=torch.from_numpy(video_noise))
    assert t_cached.shape == t_naive.shape == (B, FRAMES - 1, LAT, LAT, Z)
    assert float(t_cached.std()) > 0.1  # the head is live: not all-zero latents
    np.testing.assert_allclose(t_cached.numpy(), np.asarray(j_cached), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_naive.numpy(), np.asarray(j_naive), rtol=0, atol=1e-4)

    video = tp.generate(batch, video_noise=torch.from_numpy(video_noise),
                        posterior_noise=torch.from_numpy(post_noise), cached=True)
    assert video.shape == (B, FRAMES, RES, RES, 3)
    np.testing.assert_allclose(video.numpy(), np.asarray(j_video), rtol=0, atol=1e-4)


def test_magep_generate_defaults_to_the_naive_sampler(jax_pipeline, monkeypatch):
    """Without ``cached``, MAGE+ takes the naive reference loop, as the JAX
    pipeline does (``cached`` defaults to ``use_cids``)."""
    jp, params = jax_pipeline
    tp = _port(jp, params)
    called = []
    for name in ("generate", "generate_cached"):
        real = getattr(tp.core, name)
        monkeypatch.setattr(tp.core, name,
                            lambda *a, _n=name, _r=real, **k: (called.append(_n), _r(*a, **k))[1])
    video_noise, post_noise = _noise(2)
    kw = dict(video_noise=torch.from_numpy(video_noise),
              posterior_noise=torch.from_numpy(post_noise))
    default = tp.generate(_batch(3), **kw)
    assert called == ["generate"]
    torch.testing.assert_close(default, tp.generate(_batch(3), cached=False, **kw),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="discrete"):
        tp.generate(_batch(3), cached=True, temperature=1.0, **kw)


def test_magep_carrier_matches_jax_exporter(jax_pipeline):
    """``export_mage_core(use_cids=False, pre_ln=True)`` equals the JAX
    exporter key for key, shape for shape and value for value (continuous
    head, latent projection, real ``ln_q``/``ln_kv``) and strict-loads into
    the port's MAGE+ core; the KL first stage strict-loads under
    ``first_stage_model.``."""
    from mage_tpu.compat import torch_export

    jp, params = jax_pipeline
    kw = dict(use_cids=False, randomness=True, pre_ln=True, **LAYERS)
    ours = from_jax.export_mage_core(params, **kw)
    theirs = torch_export.export_mage_core(params, **kw)
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        a, b = np.asarray(ours[key]), np.asarray(theirs[key])
        assert a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert not np.allclose(ours["ma_encoder.blocks.0.ln_q.weight"], 1.0)
    tp = MagePipeline(**_config(), device="cpu")
    assert isinstance(tp.first_stage, FirstStageKL) and tp.core.pre_ln
    from_jax.load(tp.core, ours)
    assert set(tp.core.state_dict()) == set(ours)
    fs = from_jax.export_autoencoder_kl(jp.first_stage.variables)
    tp.load_state_dict(from_jax.to_torch({**ours, **{f"first_stage_model.{k}": v
                                                     for k, v in fs.items()}}))
    assert set(tp.state_dict()) == set(ours) | {f"first_stage_model.{k}" for k in fs}
