"""The port's main path as a whole: ``MagePipeline.generate`` against the
JAX pipeline's own pieces, and the port's isolation from JAX.

The JAX side is composed in the order ``mage_tpu``'s ``MagePipeline.generate``
runs: first-stage encode of frame 0, ``generate_cached`` on the core with
the prior noise passed in (flax would draw its own), first-stage decode,
first frame prepended. Both packages get the same weights (carried by
``compat.from_jax``), frame, caption, speed and noise, in f32. It runs once
with the JAX defaults and once with the JAX Pallas kernels in interpret mode.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from mage_tpu_torch.config import load_config, target_path
from mage_tpu_torch.models import pipeline as port_pipeline
from mage_tpu_torch.models.pipeline import MagePipeline

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, FRAMES, RES, LAT, K = 2, 4, 64, 8, 32


def _config():
    return dict(
        first_stage_config={"target": "mage_tpu.models.vqvae.VectorQuantizedVAE",
                            "params": {"input_dim": 3, "down_ratio": 8, "dim": 8, "K": K}},
        text_encoder_config={"target": "mage_tpu.models.layers.TransformerTextEncoder",
                             "params": {"vocab_size": 30, "context_length": 12,
                                        "transformer_width": 64, "transformer_layers": 2,
                                        "output_dim": 64, "padding_idx": 0,
                                        "dropout": 0.1}},
        ma_config={"target": "mage_tpu.models.layers.MAEncoder",
                   "params": {"layers": 1, "d_model": 64}},
        generate_decoder_config={"target": "mage_tpu.models.mage.FlatAxialDecoder",
                                 "params": {"layers": 3, "model_channels": 64,
                                            "in_channels": 64, "out_channels": K,
                                            "frames_length": FRAMES}},
        codebook_size=K, frames_length=FRAMES, image_resolution=LAT, vision_width=64,
        dropout=0.1, use_cids=True, randomness=True,
    )


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    text = np.zeros((B, 12), np.int32)
    text[:, 0] = 1
    text[:, 1:4] = rng.randint(3, 29, size=(B, 3))
    text[0, 4] = 2
    text[1, 3] = 2  # a shorter caption: more padding
    return {
        "images": rng.rand(B, FRAMES, RES, RES, 3).astype(np.float32) * 2 - 1,
        "text": text,
        "speed": rng.rand(B).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_pipeline():
    jax = pytest.importorskip("jax")
    from mage_tpu.models.pipeline import MagePipeline as JaxPipeline

    jp = JaxPipeline(**_config())
    return jp, jp.init(jax.random.PRNGKey(0), _batch())


@pytest.mark.parametrize("jax_kernels", ["defaults", "pallas_interpret"])
def test_generate_matches_jax_pipeline(jax_kernels, jax_pipeline, monkeypatch):
    import jax
    import jax.numpy as jnp

    from mage_tpu_torch.compat import from_jax

    if jax_kernels == "pallas_interpret":
        monkeypatch.setenv("MAGE_SPATIAL_ATTN", "pallas_interpret")
        monkeypatch.setenv("MAGE_CACHED_ATTN", "pallas_interpret")
    jp, params = jax_pipeline
    batch = _batch()
    noise = np.random.RandomState(1).randn(B, LAT, LAT, 64).astype(np.float32)
    first = jnp.asarray(batch["images"][:, 0:1])
    lat0 = jax.jit(jp.encode_first_stage)(first)
    j_ids = jax.jit(lambda p, *a: jp.core.apply({"params": p}, *a, method="generate_cached"))(
        params, lat0, jnp.asarray(batch["text"]), jnp.asarray(batch["speed"]),
        jnp.asarray(noise))
    j_video = jnp.concatenate([first, jax.jit(jp.first_stage.decode)(j_ids)], axis=1)

    tp = MagePipeline(**_config(), device="cpu")
    from_jax.load_pipeline(tp, params, jp.first_stage.variables, text_layers=2,
                           ma_layers=1, dec_layers=3)
    t_lat0 = tp.first_stage.encode(torch.from_numpy(batch["images"][:, 0:1]))
    np.testing.assert_array_equal(t_lat0.numpy(), np.asarray(lat0))
    text = torch.from_numpy(batch["text"])
    speed = torch.from_numpy(batch["speed"])
    t_ids = tp.core.generate_cached(t_lat0, text, speed, video_noise=torch.from_numpy(noise))
    assert t_ids.shape == (B, FRAMES - 1, LAT, LAT)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    naive = tp.core.generate(t_lat0, text, speed, video_noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(naive.numpy(), t_ids.numpy())

    video = tp.generate(batch, video_noise=torch.from_numpy(noise))
    assert video.shape == (B, FRAMES, RES, RES, 3)
    np.testing.assert_allclose(video.numpy(), np.asarray(j_video), rtol=0, atol=1e-4)


def test_carrier_matches_jax_exporter_mage_core(jax_pipeline):
    """Discrete core with the stochastic branch (use_cids, randomness,
    pre_ln=False): the carrier's state dict equals the JAX exporter's key for
    key, shape for shape and value for value, and strict-loads into the
    port's ``MAGECore``."""
    from mage_tpu.compat import torch_export
    from mage_tpu_torch.compat import from_jax

    _, params = jax_pipeline
    layers = dict(text_layers=2, ma_layers=1, dec_layers=3)
    ours = from_jax.export_mage_core(params, randomness=True, **layers)
    theirs = torch_export.export_mage_core(params, use_cids=True, randomness=True, **layers)
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        a, b = np.asarray(ours[key]), np.asarray(theirs[key])
        assert a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    core = MagePipeline(**_config(), device="cpu").core
    from_jax.load(core, ours)
    assert set(core.state_dict()) == set(ours)


def test_temperature_sampling_uses_the_generator():
    tp = MagePipeline(**_config(), device="cpu")
    batch = _batch(2)
    lat0 = tp.first_stage.encode(torch.from_numpy(batch["images"][:, 0:1]))
    text, speed = torch.from_numpy(batch["text"]), torch.from_numpy(batch["speed"])
    noise = torch.zeros(B, LAT, LAT, 64)

    def gen(seed, **kw):
        return tp.core.generate_cached(lat0, text, speed, video_noise=noise,
                                       generator=torch.Generator().manual_seed(seed), **kw)

    greedy = gen(0)
    hot = gen(5, temperature=1.5)
    assert ((hot >= 0) & (hot < K)).all()
    torch.testing.assert_close(hot, gen(5, temperature=1.5), rtol=0, atol=0)
    torch.testing.assert_close(gen(6, temperature=0.7, top_k=1), greedy, rtol=0, atol=0)
    assert (hot != greedy).any()


def test_first_stage_loads_a_reference_checkpoint(tmp_path):
    """A ``ckpt_path`` in the first-stage config strict-loads a reference
    VQ-VAE state dict saved with ``torch.save``."""
    params = dict(_config()["first_stage_config"]["params"])
    saved = port_pipeline.FirstStageVQVAE.from_config(params).model
    torch.nn.init.normal_(saved.codebook.embedding.weight)
    torch.save(saved.state_dict(), tmp_path / "vqvae.pt")
    loaded = port_pipeline.FirstStageVQVAE.from_config(
        {**params, "ckpt_path": str(tmp_path / "vqvae.pt")}).model
    for key, value in saved.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[key], value, rtol=0, atol=0)


def test_entry_points_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MagePipeline(**_config())
    assert port_pipeline.resolve_device("cpu") == torch.device("cpu")


def test_config_targets_resolve_to_the_port():
    cfg = load_config(ROOT / "config" / "mage_caterv1.yaml")
    assert target_path(cfg.model.target) == "mage_tpu_torch.models.pipeline.MagePipeline"
    assert target_path("modules.mage_model.FlatAxialDecoder") == (
        "mage_tpu_torch.models.mage.FlatAxialDecoder")
    pipe = port_pipeline.build_pipeline(ROOT / "config" / "mage_caterv1.yaml", 4,
                                        device="cpu")
    assert pipe.core.generate_model.frames_length == 4
    assert pipe.first_stage.model.codebook.embedding.weight.shape == (512, 1024)
    assert len(pipe.core.generate_model.blocks) == 6
    # MAGE+: the KL-AE first stage (ldm keys) and the continuous, pre-LN core
    plus = port_pipeline.build_pipeline(ROOT / "config" / "mage+_caterv1.yaml", 4,
                                        device="cpu")
    assert isinstance(plus.first_stage, port_pipeline.FirstStageKL)
    assert plus.first_stage.model.decoder.up[3].upsample.conv.weight.shape == (512, 512, 3, 3)
    assert not plus.core.use_cids and plus.core.pre_ln
    assert plus.core.visual_token_embedding.weight.shape == (512, 4)
    assert plus.core.generate_model.out[2].weight.shape == (4, 512, 1, 1, 1)
    assert not plus.core.generate_model.out[2].weight.any()  # zero-init, as in JAX


def test_package_imports_with_jax_and_mage_tpu_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'orbax', 'mage_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import mage_tpu_torch, mage_tpu_torch.config, mage_tpu_torch.ops\n"
        "import mage_tpu_torch.models, mage_tpu_torch.compat.from_jax\n"
        "import mage_tpu_torch.training.mage_trainer, mage_tpu_torch.training.autoresume\n"
        "import mage_tpu_torch.training.vqvae_trainer\n"
        "import mage_tpu_torch.training.autoencoder_kl_trainer\n"
        "import mage_tpu_torch.utils.metrics, mage_tpu_torch.utils.timer\n"
        "import mage_tpu_torch.utils.media\n"
        "import mage_tpu_torch.data, mage_tpu_torch.data.datasets\n"
        "import mage_tpu_torch.data.device_data, mage_tpu_torch.data.transforms\n"
        "import mage_tpu_torch.data.video\n"
        "from mage_tpu_torch.data.generators import (cater_synthetic, cater_text_anno,\n"
        "    cater_vqvae_store, mnist_common, mnist_double, mnist_double_modified,\n"
        "    mnist_single)\n"
        "from mage_tpu_torch.cli import main_mage, train_autoencoder_kl, train_vqvae\n"
        "from mage_tpu_torch.cli import (train_cater_e2e, train_cater_kl_e2e,\n"
        "    train_mnist2_e2e, train_mnist_e2e, train_mnist_kl_e2e)\n"
        "import mage_tpu_torch.training.e2e, mage_tpu_torch.evals\n"
        "from mage_tpu_torch.evals import fvd, i3d, metrics, precision\n"
        "from mage_tpu_torch.cli import (eval_fvd_e2e, eval_precision, eval_speed_control,\n"
        "    eval_speed_control_cater, train_fvd_extractor)\n"
        "from mage_tpu_torch.compat import convert, reference\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|flax|optax|orbax|mage_tpu)\b",
                        re.MULTILINE)


def test_no_jax_or_mage_tpu_import_in_the_port():
    files = sorted((ROOT / "mage_tpu_torch").rglob("*.py")) + [
        ROOT / name for name in ("chip_smoke.py", "gn_conv_probe.py", "axial_block_probe.py")]
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits
    package = ROOT / "mage_tpu_torch"
    scanned = {f.relative_to(package).parts[0] for f in files if package in f.parents}
    assert {"cli", "compat", "data", "evals", "models", "ops", "training", "utils"} <= scanned
    assert _FORBIDDEN.search("from mage_tpu.ops import vq")
    assert not _FORBIDDEN.search("from mage_tpu_torch.ops import vq")


def test_every_port_directory_with_modules_is_an_installed_package():
    # pyproject.toml's package finder skips a directory without __init__.py
    # and everything under it, so an install would ship the port without it
    import setuptools

    found = set(setuptools.find_packages(str(ROOT), include=["mage_tpu*"]))
    dirs = {f.parent.relative_to(ROOT) for f in (ROOT / "mage_tpu_torch").rglob("*.py")}
    wanted = {".".join(d.parts) for d in dirs}
    assert {"mage_tpu_torch.data", "mage_tpu_torch.data.generators", "mage_tpu_torch.cli",
            "mage_tpu_torch.evals"} <= wanted
    assert wanted <= found, sorted(wanted - found)
