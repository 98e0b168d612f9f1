"""The run diagnostics of ``scripts/`` in the port against the JAX package,
on the CPU, in f32.

- Model quantities, on weights carried by ``compat.from_jax`` and JAX's
  noise draws passed in (``jax.random.normal`` patched while JAX traces to
  return the numpy draws the port gets): the composed clips equal, VQ
  encode ids equal, teacher-forced argmax ids and ``generate_cached`` ids
  equal; MAGE+ posterior moments, teacher-forced predictions under the
  posterior and the prior, the rollout and ``kl_loss`` within 1e-5 of the
  tensor's largest value.
- The reductions: the ``diag_*`` scripts are module-level code over fixed
  run paths and 600-9000-scene datasets, so they cannot run here; the
  port's reductions are held to their numpy expressions, quoted by
  ``file:line``, on the same arrays (accuracies equal; MSEs and energies
  within 1e-6 relative; the 0.90-quantile motion mask equal away from its
  threshold; the speed-1 positions equal).
- ``eval_mnist2_ceiling``: the JAX script's ``main`` over a JAX-format run
  directory against the port's ``main`` over the carried weights (PSNRs
  within 1e-4 relative, SSIM within 1e-4, codebook counts and tracking
  ceilings equal).
- Each port ``main`` runs end to end over a run directory written here
  with seeded weights in the chains' layout, and defaults to the GPU.
"""

import importlib.util
import json
import math
import os
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mage_tpu_torch.cli import diag_ar_drift, diag_magep_drift, diag_magep_semantic  # noqa: E402
from mage_tpu_torch.cli import diag_recon_bound, eval_mnist2_ceiling  # noqa: E402
from mage_tpu_torch.cli import train_cater_e2e as tc  # noqa: E402
from mage_tpu_torch.compat import from_jax  # noqa: E402

TOL = 1e-5  # model quantities, of the tensor's largest |value|
REDUCE_RTOL = 1e-6
CATER_CHAIN = ["--tiny", "--num-train", "16", "--num-val", "8"]
KL_CHAIN = ["--tiny", "--num-train", "4", "--num-val", "2", "--frames-length", "4"]
MNIST2 = ["--num-train", "16", "--num-val", "8", "--dim", "16", "--codebook", "32",
          "--videos", "8"]


@pytest.fixture(scope="module", autouse=True)
def keep_global_torch_rng():
    """Leave torch's global generator as this module found it: tests in
    other files draw from it unseeded."""
    with torch.random.fork_rng():
        yield


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * float(np.abs(want).max()))


def _normals(monkeypatch, *draws):
    """``jax.random.normal`` returns ``draws`` in turn where the shape is
    theirs (read while JAX traces)."""
    real, queue = jax.random.normal, list(draws)

    def normal(key, shape=(), dtype=jnp.float32):
        if queue and tuple(shape) == queue[0].shape:
            return jnp.asarray(queue.pop(0), dtype)
        return real(key, shape, dtype)

    monkeypatch.setattr(jax.random, "normal", normal)


# ---- composed clips and positions --------------------------------------------


def test_clip_frames_and_positions_equal_jax():
    """``clip_frames`` is diag_ar_drift.py:64-70's ``ce.frames_at`` over
    ``repeat(arange(G), L)`` x ``tile(pos, G)``; the recon bound's positions
    are diag_recon_bound.py:86-91's at speed 1.0."""
    import train_cater_e2e as jax_ce

    from mage_tpu_torch.data.generators import cater_synthetic as cs

    compact = cs.build_compact_cater(4, 4, 0, dataset="CATER-GEN-v2", context_length=38)
    norm = lambda u8: jnp.asarray(u8, jnp.float32) / 127.5 - 1.0  # noqa: E731
    jdev = {"bank": jnp.concatenate([norm(compact["bank"][..., :3]),
                                     jnp.asarray(compact["bank"][..., 3:], jnp.float32)], -1),
            "background": norm(compact["background"]),
            "val": {k: jnp.asarray(v) for k, v in compact["val"].items() if k != "meta"}}
    g, length = 3, 10
    pos = np.asarray(jax_ce.clip_positions(jnp.float32(1.0), length))
    want = jax_ce.frames_at(jdev, "val", jnp.repeat(jnp.arange(g), length),
                            jnp.tile(jnp.asarray(pos), g))
    got = diag_ar_drift.clip_frames(tc.upload(compact, "cpu"), g, length)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    G, T_STORE = diag_recon_bound.G, diag_recon_bound.T_STORE
    speed = jnp.full((G,), 1.0, jnp.float32)
    q = T_STORE / (1.0 + 1.4 * speed)
    count = jnp.maximum(jnp.round(q).astype(jnp.int32), 10)
    i = jnp.arange(10, dtype=jnp.int32)
    want_pos = (i[None, :] * (T_STORE - 1)) // jnp.maximum(count[:, None] - 1, 1)
    np.testing.assert_array_equal(diag_recon_bound.eval_positions(G, "cpu").numpy(),
                                  np.asarray(want_pos))


# ---- model quantities on carried weights --------------------------------------


def _jax_pipeline(mage_plus: bool):
    """A tiny JAX MAGE (f8 VQ-VAE) or MAGE+ (a live KL-AE, the head's
    zero-init conv given random values) and its params."""
    import flax
    from test_torch_port_train import KL_RES, RES, _batch, _config

    from mage_tpu.models.autoencoder_kl import FirstStageKL as JaxFirstStageKL
    from mage_tpu.models.pipeline import MagePipeline as JaxPipeline
    from mage_tpu.models.vqvae import VectorQuantizedVAE as JaxVQVAE

    cfg = _config(mage_plus)
    fs_params = cfg["first_stage_config"]["params"]
    if mage_plus:
        model = JaxFirstStageKL.from_config(fs_params, variables={}).model
        fs_vars = jax.jit(model.init)({"params": jax.random.PRNGKey(1)},
                                      jnp.zeros((1, KL_RES, KL_RES, 3), jnp.float32),
                                      jax.random.PRNGKey(0))
    else:
        fs_vars = jax.jit(JaxVQVAE(**fs_params).init)(
            {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, RES, RES, 3), jnp.float32))
    jp = JaxPipeline(**cfg, first_stage_variables=fs_vars)
    params = flax.core.unfreeze(jp.init(jax.random.PRNGKey(0), _batch(mage_plus)))
    if mage_plus:
        out_conv = params["generate_model"]["out_conv"]
        out_conv["kernel"] = jnp.asarray(
            np.random.RandomState(9).randn(*out_conv["kernel"].shape) * 0.3, jnp.float32)
    return cfg, jp, fs_vars, params


def _port(cfg, params, fs_vars):
    from test_torch_port_train import LAYERS

    from mage_tpu_torch.models.pipeline import MagePipeline

    tp = MagePipeline(**cfg, device="cpu")
    from_jax.load_pipeline(tp, params, fs_vars, **LAYERS)
    return tp


def test_discrete_ids_equal_jax(monkeypatch):
    """Encode ids, teacher-forced argmax ids and ``generate_cached`` ids of
    diag_ar_drift.py:69-93, on JAX's posterior and prior draws."""
    from test_torch_port_train import B, FRAMES, LAT, RES, _batch

    cfg, jp, fs_vars, params = _jax_pipeline(False)
    tp = _port(cfg, params, fs_vars)
    rng = np.random.RandomState(2)
    frames = (rng.rand(B * FRAMES, RES, RES, 3) * 2 - 1).astype(np.float32)
    batch = _batch(False, seed=1)
    text, speed = batch["text"], batch["speed"]
    post, prior = (rng.randn(B, LAT, LAT, 64).astype(np.float32) for _ in range(2))

    want_ids = np.asarray(jp.first_stage.model.apply(fs_vars, jnp.asarray(frames),
                                                     method="encode", mutable=False))
    ids = diag_ar_drift.encode_ids(tp.first_stage.model.eval(), torch.from_numpy(frames), B)
    np.testing.assert_array_equal(ids.numpy(), want_ids.reshape(B, FRAMES, LAT, LAT))
    args = (jnp.asarray(ids.numpy()), jnp.asarray(text), jnp.asarray(speed))
    t_args = (ids, torch.from_numpy(text), torch.from_numpy(speed))

    _normals(monkeypatch, post)
    want_tf = jax.jit(lambda p, *a: jnp.argmax(jp.core.apply(
        {"params": p}, *a, train=False, rngs={"latent": jax.random.PRNGKey(0)})["predict"],
        axis=-1))(params, *args)
    tf = diag_ar_drift.teacher_forced(tp.core, *t_args, posterior_noise=torch.from_numpy(post))
    np.testing.assert_array_equal(tf["predict"].argmax(-1).numpy(), np.asarray(want_tf))

    want_gen = jax.jit(lambda p, *a: jp.core.apply({"params": p}, *a,
                                                   method="generate_cached"))(
        params, args[0][:, :1], *args[1:], jnp.asarray(prior))
    gen = tp.core.generate_cached(ids[:, :1], *t_args[1:], video_noise=torch.from_numpy(prior))
    np.testing.assert_array_equal(gen.numpy(), np.asarray(want_gen))


def test_magep_moments_predictions_kl_and_rollout_match_jax(monkeypatch):
    """diag_magep_semantic.py:94-136 on carried weights: moments, one
    posterior sample, the posterior and prior teacher-forced predictions and
    KL, the rollout."""
    from test_torch_port_train import B, FRAMES, KL_RES, LAT, Z, _batch

    import train_cater_kl_e2e as jax_ke

    from mage_tpu_torch.cli import train_mnist_kl_e2e as mkl

    cfg, jp, fs_vars, params = _jax_pipeline(True)
    tp = _port(cfg, params, fs_vars)
    rng = np.random.RandomState(3)
    frames = (rng.rand(B * FRAMES, KL_RES, KL_RES, 3) * 2 - 1).astype(np.float32)
    batch = _batch(True, seed=1)
    text, speed = jnp.asarray(batch["text"]), jnp.asarray(batch["speed"])
    t_text, t_speed = torch.from_numpy(batch["text"]), torch.from_numpy(batch["speed"])
    sample_noise = rng.randn(B, FRAMES, LAT, LAT, Z).astype(np.float32)
    post, prior, video = (rng.randn(B, LAT, LAT, 64).astype(np.float32) for _ in range(3))

    want_mom = jp.first_stage.model.apply(fs_vars, jnp.asarray(frames), method="encode_moments")
    want_mom = want_mom.reshape(B, FRAMES, *want_mom.shape[1:])
    mom = diag_magep_semantic.encode_moments(tp.first_stage.model.eval(),
                                             torch.from_numpy(frames), B)
    _close(mom.numpy(), want_mom)

    _normals(monkeypatch, sample_noise)
    want_lat = jax_ke.sample_latents(want_mom, jax.random.PRNGKey(3), -4.0).astype(jnp.float32)
    lat = mkl.sample_latents(mom, None, -4.0, noise=torch.from_numpy(sample_noise)).float()
    _close(lat.numpy(), want_lat, 2.0 ** -8)  # one bf16 rounding step
    lat = torch.from_numpy(np.array(want_lat))  # the same inputs from here on

    def jax_tf(test_flag, *draws):
        _normals(monkeypatch, *draws)
        out = jax.jit(lambda p, x: jp.core.apply(
            {"params": p}, x, text, speed, train=False, test_flag=test_flag,
            rngs={"latent": jax.random.PRNGKey(11)}))(params, jnp.asarray(lat.numpy()))
        return np.asarray(out["predict"]), float(out["kl_loss"])

    for test_flag, draws in ((False, (post,)), (True, (post, prior))):
        want_pred, want_kl = jax_tf(test_flag, *draws)
        out = diag_ar_drift.teacher_forced(
            tp.core, lat, t_text, t_speed, test_flag=test_flag,
            posterior_noise=torch.from_numpy(post), video_noise=torch.from_numpy(prior))
        _close(out["predict"].numpy(), want_pred)
        assert float(out["kl_loss"]) == pytest.approx(want_kl, rel=TOL)

    want_gen = jax.jit(lambda p, *a: jp.core.apply({"params": p}, *a,
                                                   method="generate_cached"))(
        params, jnp.asarray(lat.numpy())[:, :1], text, speed, jnp.asarray(video))
    gen = tp.core.generate_cached(lat[:, :1], t_text, t_speed,
                                  video_noise=torch.from_numpy(video))
    assert float(gen.std()) > 0.01  # the head is live
    _close(gen.numpy(), want_gen)


# ---- the reductions against the scripts' numpy expressions --------------------


def test_ar_drift_accuracies_equal_the_scripts_expressions():
    """diag_ar_drift.py:96-131, with one position where no token moves."""
    rng = np.random.RandomState(0)
    gt = rng.randint(0, 3, size=(4, 6, 4, 4)).astype(np.int32)
    gt[:, 3] = gt[:, 2]
    tf_ids = np.where(rng.rand(4, 5, 4, 4) < 0.7, gt[:, 1:], 0).astype(np.int32)
    gen_ids = np.where(rng.rand(4, 5, 4, 4) < 0.5, gt[:, 1:], 1).astype(np.int32)
    got = diag_ar_drift.drift_report(*map(torch.from_numpy, (tf_ids, gen_ids, gt)))

    labels = gt[:, 1:]
    prev = gt[:, :-1]
    moving = labels != prev

    def acc(pred, mask=None):
        ok = pred == labels
        if mask is not None:
            return float(ok[mask].mean()) if mask.any() else float("nan")
        return float(ok.mean())

    assert got["tokens"] == labels.size
    assert got["moving_fraction"] == moving.mean()
    for key, pred in (("teacher_forced", tf_ids), ("rollout", gen_ids)):
        assert got[key] == {"all": acc(pred), "moving": acc(pred, moving),
                            "static": acc(pred, ~moving)}
    with warnings.catch_warnings():  # numpy's mean of an empty slice: nan
        warnings.simplefilter("ignore", RuntimeWarning)
        want_rows = [{"pos": j + 1,
                      "tf_all": float((tf_ids[:, j] == labels[:, j]).mean()),
                      "tf_moving": float((tf_ids[:, j] == labels[:, j])[moving[:, j]].mean()),
                      "gen_all": float((gen_ids[:, j] == labels[:, j]).mean()),
                      "gen_moving": float((gen_ids[:, j] == labels[:, j])[moving[:, j]].mean())}
                     for j in range(labels.shape[1])]
    np.testing.assert_equal(got["per_position"], want_rows)
    assert math.isnan(got["per_position"][2]["tf_moving"])
    assert got["agreement"] == float((gen_ids == tf_ids).mean())


def _latent_streams(seed: int):
    rng = np.random.RandomState(seed)
    g, length, r, z = 3, 6, 4, 4
    means = rng.randn(g, length, r, r, z).astype(np.float32)
    latents = (means + 0.1 * rng.randn(*means.shape)).astype(np.float32)
    preds = [rng.randn(g, length - 1, r, r, z).astype(np.float32) for _ in range(3)]
    return means, latents, preds


def _numpy_mask(means):
    """diag_magep_semantic.py:141-148 (diag_magep_drift.py:100-103) -> (d2,
    the threshold, the mask, the tokens within 1e-6 relative of it)."""
    tmean, pmean = means[:, 1:], means[:, :-1]
    d2 = ((tmean - pmean) ** 2).mean(-1)
    thresh = np.quantile(d2, 0.90)
    return d2, thresh, d2 > thresh, np.abs(d2 - thresh) <= REDUCE_RTOL * abs(thresh)


def test_magep_semantic_report_matches_the_scripts_expressions():
    """diag_magep_semantic.py:137-187."""
    means, latents, (pred_post, pred_prior, gen) = _latent_streams(0)
    d2, thresh, moving, near = _numpy_mask(means)
    _, t_thresh, t_moving = diag_magep_semantic.motion_mask(torch.from_numpy(means))
    np.testing.assert_array_equal(t_moving.numpy()[~near], moving[~near])
    assert not near.any()  # so every masked reduction below takes the same tokens
    assert float(t_thresh) == pytest.approx(float(thresh), rel=REDUCE_RTOL)

    got = diag_magep_semantic.semantic_report(
        *map(torch.from_numpy, (pred_post, pred_prior, gen, latents, means)),
        torch.tensor(3.25))
    target = latents[:, 1:]
    tmean = means[:, 1:]
    want = {"kl_nats": 3.25, "moving_frac": float(moving.mean()), "samples": 3}

    def mse(pred, mask=None):
        e = ((np.asarray(pred) - target) ** 2).mean(-1)
        return float(e[mask].mean()) if mask is not None else float(e.mean())

    for name, pred in (("posterior", pred_post), ("prior", pred_prior)):
        want[f"tf_{name}_mse_all"] = mse(pred)
        want[f"tf_{name}_mse_moving"] = mse(pred, moving)
        want[f"tf_{name}_mse_static"] = mse(pred, ~moving)

    def motion_energy(x):
        x = np.asarray(x)
        d = ((x[:, 1:] - x[:, :-1]) ** 2).mean(-1)
        return float(d[moving[:, 1:]].mean())

    want["gt_moving_energy"] = motion_energy(tmean)
    want["tf_posterior_moving_energy"] = motion_energy(pred_post)
    want["tf_prior_moving_energy"] = motion_energy(pred_prior)
    want["gen_moving_energy"] = motion_energy(gen)
    dp = ((np.asarray(pred_post) - np.asarray(pred_prior)) ** 2).mean(-1)
    want["pred_post_vs_prior_mse_moving"] = float(dp[moving].mean())
    want["pred_post_vs_prior_mse_static"] = float(dp[~moving].mean())
    assert set(got) == set(want)
    for key in ("moving_frac", "samples"):
        assert got[key] == want[key]
    for key in set(want) - {"moving_frac", "samples"}:
        assert got[key] == pytest.approx(want[key], rel=REDUCE_RTOL), key


def test_magep_drift_rows_match_the_scripts_expressions():
    """diag_magep_drift.py:100-130."""
    means, _, (tf_pred, gen, _) = _latent_streams(1)
    d2, _, moving, near = _numpy_mask(means)
    assert not near.any()
    target = means[:, 1:]
    got = diag_magep_drift.drift_rows(torch.from_numpy(tf_pred), torch.from_numpy(gen),
                                      torch.from_numpy(means))
    assert got["slot1_mse"] == pytest.approx(
        float(((tf_pred[:, 0] - gen[:, 0]) ** 2).mean()), rel=REDUCE_RTOL)
    assert got["slot1_signal_msq"] == pytest.approx(float((tf_pred[:, 0] ** 2).mean()),
                                                    rel=REDUCE_RTOL)
    assert len(got["rows"]) == target.shape[1]
    for j, row in enumerate(got["rows"]):
        m = moving[:, j]
        assert m.any()
        want = {"pos": j + 1,
                "tf_mse_moving": float((((tf_pred[:, j] - target[:, j]) ** 2
                                         ).mean(-1))[m].mean()),
                "gen_mse_moving": float((((gen[:, j] - target[:, j]) ** 2).mean(-1))[m].mean()),
                "gt_step_energy": float(d2[:, j][m].mean())}
        if j > 0:
            want["tf_motion"] = float((((tf_pred[:, j] - tf_pred[:, j - 1]) ** 2
                                        ).mean(-1))[m].mean())
            want["gen_motion"] = float((((gen[:, j] - gen[:, j - 1]) ** 2).mean(-1))[m].mean())
        assert row.keys() == want.keys()
        assert row == pytest.approx(want, rel=REDUCE_RTOL)


# ---- eval_mnist2_ceiling: the JAX script's main against the port's --------------


def test_mnist2_ceiling_matches_the_jax_script(tmp_path, capsys):
    from mage_tpu.models.vqvae import VectorQuantizedVAE as JaxVQVAE
    from mage_tpu.training import vqvae_trainer as jvt
    from mage_tpu.training.checkpoint import Checkpointer as JaxCheckpointer
    from mage_tpu_torch.training.checkpoint import Checkpointer

    spec = importlib.util.spec_from_file_location(
        "jax_eval_mnist2_ceiling", os.path.join("scripts", "eval_mnist2_ceiling.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)

    state = jvt.create_state(JaxVQVAE(input_dim=1, down_ratio=4, dim=16, K=32),
                             jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 1)),
                             jvt.make_tx(1e-4))
    jax_run, port_run = tmp_path / "jax", tmp_path / "port"
    JaxCheckpointer(str(jax_run / "vqvae")).save("best", state)
    sd = from_jax.export_vqvae({"params": state.params, "batch_stats": state.batch_stats}, 4)
    Checkpointer(str(port_run / "vqvae")).save("best", {"step": 0,
                                                        "state_dict": from_jax.to_torch(sd)})
    jax_tool.main(["--run", str(jax_run), *MNIST2])
    with open(jax_run / "e2e_metrics.json") as fp:
        want = [json.loads(line) for line in fp]
    got = eval_mnist2_ceiling.main(["--run", str(port_run), "--device", "cpu", *MNIST2])
    capsys.readouterr()
    with open(port_run / "e2e_metrics.json") as fp:
        assert [json.loads(line)["phase"] for line in fp] == [r["phase"] for r in got]
    assert [r["phase"] for r in want] == [r["phase"] for r in got]
    (w1, w2), (g1, g2) = want, got
    assert set(g1) == set(w1) - {"time"} and set(g2) == set(w2) - {"time"}
    for key in ("val_recon_mse", "val_recon_psnr", "val_recon_psnr_motion"):
        assert g1[key] == pytest.approx(w1[key], rel=1e-4), key
    assert abs(g1["val_ssim"] - w1["val_ssim"]) <= 1e-4
    assert (g1["codebook_used"], g1["codebook_used_motion"]) == (
        w1["codebook_used"], w1["codebook_used_motion"])
    assert g1["codebook_used"] > 1
    assert g2["recon_psnr_vs_gt_upper_bound"] == pytest.approx(
        w2["recon_psnr_vs_gt_upper_bound"], rel=1e-4)
    for key in ("samples", "recon_motion_correct_ceiling", "recon_track_error_px_ceiling",
                "recon_direction_acc_ceiling", "direction_cases"):
        assert g2[key] == w2[key], key


# ---- each main end to end over a run directory --------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run directories of seeded weights in the chains' layout (nothing is
    trained): discrete CATER (``vqvae/best``, ``mage/best``), MAGE+ CATER
    (``klae/best``, ``mage/final``, the head's zero-init conv made live) and
    double MNIST (``vqvae/best``)."""
    from mage_tpu_torch.cli import train_cater_kl_e2e as ke
    from mage_tpu_torch.cli import train_mnist2_e2e as m2
    from mage_tpu_torch.cli import train_mnist_e2e as tm
    from mage_tpu_torch.training.checkpoint import Checkpointer

    out = {}
    run = tmp_path_factory.mktemp("cater")
    a = tc.parse_args(["--out", str(run), "--device", "cpu", *CATER_CHAIN])
    a.config = "config/mage_caterv2.yaml"
    torch.manual_seed(0)
    model = tc.make_vqvae(a, "cpu")
    core = tc.build_pipeline(a, model, "cpu").core
    Checkpointer(str(run / "vqvae")).save("best", {"step": 0, "state_dict": model.state_dict()})
    Checkpointer(str(run / "mage")).save("best", {"step": 0, "model": core.state_dict()})
    out["cater"] = str(run)

    run = tmp_path_factory.mktemp("cater_kl")
    a = ke.parse_args(["--out", str(run), "--device", "cpu", *KL_CHAIN])
    ae = ke.make_ae(a, "cpu")
    core = ke.build_pipeline(a, ae, "cpu").core
    w = core.generate_model.out[2].weight
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(5)) * 0.02)
    Checkpointer(str(run / "klae")).save("best", {"step": 0, "state_dict": ae.state_dict()})
    Checkpointer(str(run / "mage")).save("final", {"step": 0, "model": core.state_dict()})
    out["cater_kl"] = str(run)

    run = tmp_path_factory.mktemp("mnist2")
    a = m2.parse_args(["--out", str(run), "--device", "cpu", "--tiny", *MNIST2[:4]])
    model = tm.make_vqvae(a, "cpu")
    Checkpointer(str(run / "vqvae")).save("best", {"step": 0, "state_dict": model.state_dict()})
    out["mnist2"] = str(run)
    return out


def _numbers(value) -> list:
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in _numbers(v)]
    return [float(value)] if isinstance(value, (int, float)) and not isinstance(value, bool) else []


def _report(run, name, rec):
    with open(os.path.join(run, f"{name}.json")) as fp:
        assert json.load(fp) == json.loads(json.dumps(rec))


def test_recon_bound_main_runs_over_a_run_directory(runs):
    rec = diag_recon_bound.main(["--run", runs["cater"], "--device", "cpu", *CATER_CHAIN])
    assert [r["frame"] for r in rec["stage1"]] == [0, 12, 23]
    assert rec["positions"] == [0, 2, 5, 7, 10, 12, 15, 17, 20, 23]
    assert len(rec["per_position"]) == 10
    assert all(map(math.isfinite, _numbers(rec)))
    _report(runs["cater"], "diag_recon_bound", rec)


def test_ar_drift_main_runs_over_a_run_directory(runs, tmp_path):
    report = str(tmp_path / "drift.json")
    rec = diag_ar_drift.main(["--run", runs["cater"], "--dataset", "caterv2", "--report",
                              report, "--device", "cpu", *CATER_CHAIN])
    assert rec["videos"] == 6 and len(rec["per_position"]) == 9
    assert rec["tokens"] == 6 * 9 * 16 * 16
    for key in ("teacher_forced", "rollout"):
        assert 0 <= rec[key]["all"] <= 1
    assert 0 <= rec["agreement"] <= 1
    with open(report) as fp:
        assert json.load(fp)["agreement"] == rec["agreement"]


@pytest.mark.parametrize("tool", ["diag_magep_semantic", "diag_magep_drift"])
def test_magep_diags_main_run_over_a_run_directory(tool, runs):
    module = {"diag_magep_semantic": diag_magep_semantic,
              "diag_magep_drift": diag_magep_drift}[tool]
    rec = module.main(["--run", runs["cater_kl"], "--device", "cpu", *KL_CHAIN])
    if tool == "diag_magep_semantic":
        assert rec["samples"] == 2 and rec["kl_nats"] > 0
        assert 0 < rec["moving_frac"] <= 0.11
        assert rec["gen_moving_energy"] > 0
    else:
        assert [r["pos"] for r in rec["rows"]] == [1, 2, 3]
        assert rec["slot1_signal_msq"] > 0
    assert all(map(math.isfinite, _numbers(rec)))
    _report(runs["cater_kl"], tool, rec)


def test_mnist2_ceiling_main_runs_over_a_run_directory(runs):
    stage1, tracking = eval_mnist2_ceiling.main(["--run", runs["mnist2"], "--device", "cpu",
                                                 *MNIST2])
    assert 1 <= stage1["codebook_used"] <= 32 and tracking["samples"] == 8
    assert all(map(math.isfinite, _numbers([stage1, tracking])))
    with open(os.path.join(runs["mnist2"], "e2e_metrics.json")) as fp:
        assert [json.loads(line)["phase"] for line in fp] == [
            "recon_ceiling_stage1", "recon_ceiling_tracking"]


@pytest.mark.parametrize("tool", [diag_recon_bound, diag_ar_drift, diag_magep_semantic,
                                  diag_magep_drift, eval_mnist2_ceiling],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_diags_default_to_the_gpu_and_raise_without_one(tool, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(["--run", str(tmp_path)])
