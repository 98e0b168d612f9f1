"""Reference-checkpoint conversion (``compat.convert``, ``compat.reference``)
against the JAX package's exporter.

JAX's ``export_mage_core`` (with its VQ-VAE merged under
``first_stage_model.`` by ``export_vqvae``) writes a reference MAGE
checkpoint, and ``export_vqvae`` a VQ-VAE one, as DDP saves them: under
``state_dict``, every key prefixed ``module.``. The port's ``convert vqvae`` and ``convert mage`` turn it into
the port's own checkpoints; loaded into ``build_pipeline(device="cpu")``,
the first-frame ids and the ``generate_cached`` ids on explicit noise are
bit-identical to JAX's on the same weights. ``export-mage`` (with the
converted VQ-VAE as ``--first-stage``) after ``mage`` gives back the file's
tensors exactly, and ``export-vqvae`` after ``vqvae`` the VQ-VAE's.
"""

import numpy as np
import pytest
import torch

from mage_tpu_torch.compat import convert, reference
from mage_tpu_torch.config import save_config
from mage_tpu_torch.models.pipeline import build_pipeline

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from test_torch_port_pipeline import B, LAT, _batch, _config  # noqa: E402


@pytest.fixture(scope="module")
def reference_file(tmp_path_factory):
    """(directory, the YAML config, the JAX pipeline and params, the
    reference file's state dict without wrapper or prefix)."""
    from mage_tpu.compat.torch_export import export_mage_core, export_vqvae, to_torch
    from mage_tpu.models.pipeline import MagePipeline as JaxPipeline
    from mage_tpu.models.vqvae import VectorQuantizedVAE

    tmp = tmp_path_factory.mktemp("reference")
    config = str(tmp / "mage.yaml")
    save_config({"model": {"target": "mage_tpu.models.pipeline.MagePipeline",
                           "params": _config()}}, config)
    # the first stage's own init, jitted (from_config runs it eagerly)
    vqvae = VectorQuantizedVAE(**_config()["first_stage_config"]["params"])
    fs_vars = jax.jit(lambda k: vqvae.init(k, jnp.zeros((1, 16, 16, 3)), train=True))(
        jax.random.PRNGKey(0))
    jp = JaxPipeline(**_config(), first_stage_variables=fs_vars)
    params = jp.init(jax.random.PRNGKey(0), _batch())
    vq = export_vqvae(jp.first_stage.variables, down_ratio=8)
    sd = to_torch(export_mage_core(
        params, use_cids=True, randomness=True, text_layers=2, ma_layers=1, dec_layers=3,
        first_stage=vq))
    for name, tensors in (("model_best.pth", sd), ("vqvae.pt", to_torch(vq))):
        torch.save({"state_dict": {"module." + k: v for k, v in tensors.items()}}, tmp / name)
    return tmp, config, jp, params, sd


def test_reference_checkpoint_unwraps_and_strips(tmp_path):
    sd = {"a.weight": torch.ones(2), "b": torch.zeros(1)}
    for obj in (sd, {"state_dict": sd}, {"module." + k: v for k, v in sd.items()},
                {"state_dict": {"module." + k: v for k, v in sd.items()}}):
        torch.save(obj, tmp_path / "x.pth")
        got = reference.load_reference_checkpoint(str(tmp_path / "x.pth"))
        assert list(got) == list(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    # a prefix only some keys carry is not DDP's
    mixed = {"module.a": 1, "b": 2}
    assert reference.strip_ddp_prefix(mixed) == mixed


def test_converted_checkpoint_generates_jax_ids(reference_file):
    tmp, config, jp, params, _ = reference_file
    ref = str(tmp / "model_best.pth")
    convert.main(["vqvae", "--input", str(tmp / "vqvae.pt"), "--down-ratio", "8", "--output",
                  str(tmp / "vqvae_converted")])
    convert.main(["mage", "--input", ref, "--config", config, "--output",
                  str(tmp / "model_converted")])
    vq = torch.load(tmp / "vqvae_converted", weights_only=True)
    core = torch.load(tmp / "model_converted", weights_only=True)
    assert set(vq) == {"step", "state_dict"} and set(core) == {"step", "model"}
    assert not any(k.startswith("first_stage_model.") for k in core["model"])

    pipe = build_pipeline(config, device="cpu")
    pipe.first_stage.model.load_state_dict(vq["state_dict"], strict=True)
    pipe.core.load_state_dict(core["model"], strict=True)
    batch = _batch()
    noise = np.random.RandomState(1).randn(B, LAT, LAT, 64).astype(np.float32)
    first = jnp.asarray(batch["images"][:, 0:1])
    lat0 = jax.jit(jp.encode_first_stage)(first)
    j_ids = jax.jit(lambda p, *a: jp.core.apply({"params": p}, *a, method="generate_cached"))(
        params, lat0, jnp.asarray(batch["text"]), jnp.asarray(batch["speed"]),
        jnp.asarray(noise))
    t_lat0 = pipe.first_stage.encode(torch.from_numpy(batch["images"][:, 0:1]))
    np.testing.assert_array_equal(t_lat0.numpy(), np.asarray(lat0))
    t_ids = pipe.core.generate_cached(t_lat0, torch.from_numpy(batch["text"]),
                                      torch.from_numpy(batch["speed"]),
                                      video_noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))

    # back out: the reference file's tensors, exactly
    convert.main(["export-mage", "--input", str(tmp / "model_converted"), "--config", config,
                  "--first-stage", str(tmp / "vqvae_converted"), "--output",
                  str(tmp / "exported.pth")])
    _, _, _, _, sd = reference_file
    back = torch.load(tmp / "exported.pth", weights_only=True)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    convert.main(["export-vqvae", "--input", str(tmp / "vqvae_converted"), "--output",
                  str(tmp / "vqvae_exported.pt")])
    vq_back = torch.load(tmp / "vqvae_exported.pt", weights_only=True)
    prefix = "first_stage_model."
    assert set(vq_back) == {k[len(prefix):] for k in sd if k.startswith(prefix)}
    for k, v in vq_back.items():
        assert torch.equal(v, sd[prefix + k]), k


def test_conversion_rejects_a_checkpoint_of_another_model(reference_file, tmp_path):
    tmp, config, _, _, sd = reference_file
    bad = dict(sd)
    bad.pop("generate_model.out.weight")
    bad["generate_model.extra"] = torch.zeros(1)
    torch.save(bad, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="Missing key.*\n.*Unexpected key"):
        convert.main(["mage", "--input", str(tmp_path / "bad.pth"), "--config", config,
                      "--output", str(tmp_path / "out")])
    with pytest.raises(RuntimeError):  # an f8 VQ-VAE read as f4
        convert.main(["vqvae", "--input", str(tmp / "vqvae.pt"), "--down-ratio", "4",
                      "--output", str(tmp_path / "vq")])
    assert not (tmp_path / "out").exists() and not (tmp_path / "vq").exists()
