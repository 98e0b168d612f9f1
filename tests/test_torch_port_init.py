"""The port's initial weights against the JAX package's init distributions.

Every parameter of ``build_pipeline(..., device="cpu")`` for a shipped MAGE
and MAGE+ config, at the config's widths, and of the KL-AE trainer's model,
is compared with the same tensor of the JAX init tree (carried to reference
keys by ``compat.from_jax``): its empirical standard deviation and its mean
absolute value within 10% (a wider sampling bound for tensors under 900
values). The mean absolute value tells a normal from
flax's truncated LeCun normal (their ratios to the std are 0.80 and 0.82)
only loosely, so the truncation is also read from the largest |value|,
which a truncated draw keeps within two of its widened standard deviations.
No forward runs.
"""

import pathlib

import numpy as np
import pytest
import torch

from mage_tpu_torch.compat import from_jax
from mage_tpu_torch.models import layers as port_layers
from mage_tpu_torch.models import pipeline as port_pipeline

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FRAMES = 4


def _compare(jax_sd: dict, port_sd: dict) -> None:
    assert set(jax_sd) == set(port_sd), set(jax_sd) ^ set(port_sd)
    bad = []
    for key in sorted(jax_sd):
        a = np.asarray(jax_sd[key], np.float64)
        b = port_sd[key].double().numpy()
        assert a.shape == b.shape, key
        # 10%, or three of a sample statistic's relative standard errors
        # (about 1/sqrt(n)) for tensors under 900 values
        tol = max(0.1, 3 / np.sqrt(a.size))
        for stat in (np.std, lambda x: np.abs(x).mean()):
            sa, sb = stat(a), stat(b)
            if abs(sa - sb) > tol * sa + 1e-12:
                bad.append((key, a.shape, float(sa), float(sb)))
        # a truncated draw stays inside 2 / 0.8796 of its std; a plain
        # normal of these sizes goes past it
        cut = 2 / 0.87962566103423978 * a.std() * 1.02
        if a.size > 1000 and (np.abs(a).max() <= cut) != (np.abs(b).max() <= cut):
            bad.append((key, "truncation", float(np.abs(a).max()), float(np.abs(b).max())))
    assert not bad, bad


@pytest.mark.parametrize("config", ["mage_caterv1", "mage+_caterv2"])
def test_pipeline_init_matches_jax_distributions(config):
    from mage_tpu.config import load_config
    from mage_tpu.models.mage import MAGECore

    p = load_config(ROOT / "config" / f"{config}.yaml").model.params
    te, ma = p.text_encoder_config.params, p.ma_config.params
    dec = p.generate_decoder_config.params
    use_cids = bool(p.get("use_cids", False))
    core = MAGECore(
        codebook_size=p.codebook_size, frames_length=FRAMES,
        image_resolution=p.image_resolution, vision_width=p.vision_width,
        embed_dim=p.first_stage_config.params.get("embed_dim", 4), use_cids=use_cids,
        randomness=bool(p.get("randomness", False)), pre_ln=not use_cids,
        text_vocab_size=te.vocab_size, text_context_length=te.context_length,
        text_width=te.transformer_width, text_layers=te.transformer_layers,
        text_output_dim=te.output_dim, ma_layers=ma.layers, ma_d_model=ma.d_model,
        dec_layers=dec.layers, dec_out_channels=dec.out_channels)
    r = p.image_resolution
    latents = (jnp.zeros((1, FRAMES, r, r), jnp.int32) if use_cids
               else jnp.zeros((1, FRAMES, r, r, 4), jnp.float32))
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda k: core.init({"params": k, "dropout": k, "latent": k}, latents,
                                         jnp.zeros((1, te.context_length), jnp.int32),
                                         jnp.zeros((1,)), train=True)["params"])(key)
    want = from_jax.export_mage_core(
        jax.tree_util.tree_map(np.asarray, params), randomness=core.randomness,
        text_layers=te.transformer_layers, ma_layers=ma.layers, dec_layers=dec.layers,
        use_cids=use_cids, pre_ln=not use_cids)
    pipe = port_pipeline.build_pipeline(ROOT / "config" / f"{config}.yaml", FRAMES,
                                        device="cpu")
    _compare(want, pipe.core.state_dict())


def test_klae_trainer_init_matches_jax_distributions(tmp_path):
    """The KL-AE of ``train_cater_kl_e2e --ae-ch 64`` (4 levels), as
    ``KLAETrainer.init_state`` draws it, against JAX's LeCun-normal convs."""
    from mage_tpu.models.autoencoder_kl import AutoencoderKL as JaxKL
    from mage_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from mage_tpu_torch.training.autoencoder_kl_trainer import KLAETrainer

    jm = JaxKL(embed_dim=4, ch=64, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4,
               resolution=128)
    variables = jax.jit(jm.init)({"params": jax.random.PRNGKey(0)},
                                 jnp.zeros((1, 16, 16, 3), jnp.float32), jax.random.PRNGKey(0))
    want = from_jax.export_autoencoder_kl(jax.tree_util.tree_map(np.asarray, variables))
    model = AutoencoderKL(embed_dim=4, ch=64, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
                          z_channels=4, resolution=128)
    KLAETrainer(model, log_dir=str(tmp_path / "log"), ckpt_dir=str(tmp_path / "ckpt"),
                device="cpu").init_state()
    _compare(want, model.state_dict())


def test_truncated_normal_has_flax_moments():
    gen = torch.Generator().manual_seed(0)
    p = torch.empty(512, 4096)
    port_layers.lecun_normal_(p, gen)
    want = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (4096, 512)))
    assert float(p.std()) == pytest.approx(float(want.std()), rel=2e-3)
    assert float(p.abs().max()) <= 2 / 0.87962566103423978 / 64 * (1 + 1e-6)
    assert float(p.abs().mean()) == pytest.approx(float(np.abs(want).mean()), rel=2e-3)
