"""The port's evaluation path against the JAX package's, on the CPU.

- I3D BatchNorm in train mode moves its running statistics as flax does
  (momentum 0.9, the biased batch variance).
- ``train_fvd_extractor``: the label sets, the speed -> stored-frame maps
  and the composed clips equal JAX's; ``LabelI3D``'s logits and loss on
  carried weights within 1e-4 of JAX's for fixed clips, speeds and labels,
  and after one AdamW step the trunk within 1e-5 (of each tensor's largest
  |value|) of optax's; the CLI runs whole and resumes.
- ``load_trained_extractor``: a carried trunk's Mixed_4f features within
  1e-4 of JAX's ``make_extractor``; the trunk loads strictly.
- ``resolve_extractor``: every branch and error of JAX's order, with
  arguments in place of JAX's environment variables.
- ``evals.precision`` is JAX's, and ``cli.eval_precision --self-test`` passes.
- The speed-control reductions equal JAX's on the same arrays, and
  ``eval_fvd_e2e`` and both speed-control CLIs run on a run directory
  written from fresh port weights, their generated ids those of the
  pipeline's ``generate_cached`` on the same noise.
- Every new CLI defaults to the card and raises without one.
"""

import argparse
import json
import os
import random

import numpy as np
import pytest
import torch

from mage_tpu_torch.cli import eval_fvd_e2e, eval_precision, eval_speed_control
from mage_tpu_torch.cli import eval_speed_control_cater, train_fvd_extractor
from mage_tpu_torch.compat import from_jax
from mage_tpu_torch.evals import fvd, i3d, precision

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from test_torch_port_e2e import one_torch_thread  # noqa: E402,F401
from test_torch_port_evals import _state_dict  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _trunk(seed=3) -> dict:
    """Random pytorch-i3d weights cut at Mixed_4f, BatchNorm statistics drawn."""
    return {k: v for k, v in _state_dict(seed).items()
            if not k.startswith(("Mixed_5", "logits"))}


def _clip(seed, n=2, t=4, size=32):
    return np.random.RandomState(seed).rand(n, t, size, size, 3).astype(np.float32) * 2 - 1


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def test_i3d_train_mode_moves_batch_stats_as_flax():
    """32 px, 4 frames, batch 2, random running statistics: after one
    train-mode forward each running mean and variance is within 1e-5 of
    flax's ``mutable=["batch_stats"]`` result (torch's own update, momentum
    0.01 and the unbiased variance, misses by up to 1e-2). Both run in f64:
    flax's train-mode BatchNorm takes E[x^2] - E[x]^2, whose f32 rounding
    reaches 1e-5 of the deeper layers' statistics."""
    from mage_tpu.evals.i3d import I3D as JaxI3D, import_i3d_torch

    sd, x = _trunk(), _clip(1)
    with jax.enable_x64(True):
        variables = _f64(import_i3d_torch(sd))
        _, mutated = jax.jit(lambda v, a: JaxI3D(endpoint="Mixed_4f").apply(
            v, a, True, mutable=["batch_stats"]))(variables, jnp.asarray(x, jnp.float64))
        want = from_jax.export_i3d({"params": variables["params"],
                                    "batch_stats": mutated["batch_stats"]})
    model = i3d.I3D(endpoint="Mixed_4f", trunk=True)
    model.load_state_dict(sd, strict=True)
    model.double().train()(torch.from_numpy(x).double())
    got = model.state_dict()
    moved = 0
    for key in want:
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0, atol=1e-5,
                                       err_msg=key)
            moved += not np.allclose(want[key], sd[key].numpy())
    # every BatchNorm of the trunk moved both statistics
    assert moved == 2 * sum(isinstance(m, i3d.BatchNorm3d) for m in model.modules())


@pytest.mark.parametrize("name", ["i3d", "vqvae"])
def test_batchnorm_running_statistics_keep_an_f64_input_in_f64(name):
    """An f64 train-mode forward moves the running averages by the f64 batch
    statistics (momentum 0.1, biased variance), not by their f32 rounding,
    so an f64 step on the card can be held tensor by tensor to the CPU's.
    The input sits at 1e3, where f32 loses about 1e-8 of the mean."""
    from mage_tpu_torch.models import vqvae

    cls, shape = {"i3d": (i3d.BatchNorm3d, (2, 8, 3, 5, 5)),
                  "vqvae": (vqvae.BatchNorm2d, (2, 8, 5, 5))}[name]
    bn = cls(8).double().train()
    x = torch.from_numpy(np.random.RandomState(0).randn(*shape) * 3 + 1e3)
    bn(x)
    var, mean = torch.var_mean(x, dim=(0, *range(2, x.dim())), unbiased=False)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, rtol=1e-14, atol=0)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=1e-12, atol=0)


def _spec_args(dataset):
    return argparse.Namespace(dataset=dataset, num_train=4, num_val=4, seed=1000,
                              mnist_npz=None)


@pytest.mark.parametrize("dataset", ["mnist", "caterv1"])
def test_extractor_dataset_matches_jax(dataset):
    """Labels (``action_labels``, ``mnist_motion_labels``), the speed ->
    stored-frame map, the composed clips and the label groups equal JAX's."""
    import train_fvd_extractor as jfx

    prepare = {"mnist": (jfx.prepare_mnist, train_fvd_extractor.prepare_mnist),
               "caterv1": (jfx.prepare_cater, train_fvd_extractor.prepare_cater)}[dataset]
    js, ts = prepare[0](_spec_args(dataset)), prepare[1](_spec_args(dataset), "cpu")
    assert (ts.tag, ts.hw, ts.groups, ts.label_names) == (js.tag, js.hw, js.groups,
                                                          js.label_names)
    np.testing.assert_array_equal(ts.y_train.numpy(), np.asarray(js.y_train))
    np.testing.assert_array_equal(ts.y_val.numpy(), np.asarray(js.y_val))
    speed = np.concatenate([np.linspace(0, 1, 257, dtype=np.float32)[:-1],
                            np.float32([0.999999, 0.5])])
    for length in (4, 10):
        want = np.asarray(js.positions(jnp.asarray(speed), length))
        got = ts.positions(torch.from_numpy(speed), length)
        np.testing.assert_array_equal(got.numpy(), want)
    idx = np.array([3, 0, 2])
    pos = np.asarray(js.positions(jnp.asarray(speed[[5, 100, 250]]), 4))
    for split in ("train", "val"):
        want = np.asarray(js.clips_at(split, jnp.asarray(idx), jnp.asarray(pos)))
        got = ts.clips_at(split, torch.from_numpy(idx), torch.from_numpy(pos))
        np.testing.assert_array_equal(got.numpy(), want)
    logits = np.random.RandomState(0).randn(4, ts.y_val.shape[1]).astype(np.float32)
    labels = ts.y_val.numpy()
    assert (train_fvd_extractor.group_accuracies(ts.groups, logits, labels)
            == jfx.group_accuracies(js.groups, logits, labels))
    metas = [{"movements": {"a": [["_slide", None, 0, 5]], "b": [["_contain", "a", 3, 9]]}}]
    np.testing.assert_array_equal(train_fvd_extractor.action_labels(metas),
                                  jfx.action_labels(metas))


def test_label_i3d_step_matches_jax():
    """Fixed clips (MNIST, 4 frames, batch 2, 32 px), speeds and labels:
    logits and the mean sigmoid cross-entropy on carried weights (the
    port's ``init_label_i3d``) within 1e-4 of JAX's
    ``LabelI3D``; after one AdamW step (the CLI's ``make_optimizer`` and
    ``make_train_step`` against ``optax.adamw``, learning rate 3e-4) every
    parameter and running statistic within 1e-5 of its tensor's largest
    |value|. In f64 on both sides: in f32 JAX's train-mode BatchNorm
    (E[x^2] - E[x]^2 over the MNIST clips' flat background) puts its logits
    9e-4 from an f64 run, the port's 2e-5."""
    import optax
    import train_fvd_extractor as jfx
    from mage_tpu.evals.i3d import import_i3d_torch

    spec = train_fvd_extractor.prepare_mnist(_spec_args("mnist"), "cpu")
    idx, speed = torch.tensor([2, 0]), torch.tensor([0.3, 0.8])
    # the clips' centre 32 x 32 (the digit's path), to keep the f64 run short
    clips = spec.clips_at("train", idx, spec.positions(speed, 4))[:, :, 16:48, 16:48].double()
    labels = spec.y_train[idx].double()
    jm = jfx.LabelI3D(n_labels=14)
    model = i3d.LabelI3D(14)
    i3d.init_label_i3d(model, torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    trunk = import_i3d_torch({k[4:]: v for k, v in sd.items() if k.startswith("i3d.")})
    variables = {"params": {"i3d": trunk["params"],
                            "head": {"kernel": sd["head.weight"].T, "bias": sd["head.bias"]}},
                 "batch_stats": {"i3d": trunk["batch_stats"]}}

    def port_sd(p, s):
        sd = {"i3d." + k: v for k, v in from_jax.export_i3d(
            {"params": p["i3d"], "batch_stats": s["i3d"]}).items()}
        sd["head.weight"] = np.asarray(p["head"]["kernel"]).T
        sd["head.bias"] = np.asarray(p["head"]["bias"])
        return sd

    with jax.enable_x64(True):
        params, stats = _f64(variables["params"]), _f64(variables["batch_stats"])

        def loss_fn(p, x, y):
            logits, mutated = jm.apply({"params": p, "batch_stats": stats}, x, True,
                                       mutable=["batch_stats"])
            return (jnp.mean(optax.sigmoid_binary_cross_entropy(logits, y)),
                    (logits, mutated))

        (j_loss, (j_logits, mutated)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, jnp.asarray(clips.numpy()),
                                    jnp.asarray(labels.numpy()))
        tx = optax.adamw(3e-4)
        new = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
            grads, params)
        want = port_sd(new, mutated["batch_stats"])
        start = port_sd(params, stats)

    model = from_jax.load(model.double(), start)
    with torch.no_grad():
        logits = model.train()(clips)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=0, atol=1e-4)
    from_jax.load(model, start)
    step = train_fvd_extractor.make_train_step(
        model, train_fvd_extractor.make_optimizer(model, 3e-4))
    loss = step(clips, labels, 3e-4)
    assert float(loss) == pytest.approx(float(j_loss), abs=1e-4)
    got = model.state_dict()
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[key].numpy(), value, rtol=0,
                                   atol=1e-5 * np.abs(value).max(), err_msg=key)


def _write_extractor(out, dataset="CATER-GEN-v2", trunk=None):
    from mage_tpu_torch.training.checkpoint import Checkpointer

    Checkpointer(os.path.join(out, "i3d")).save("best", trunk or _trunk())
    with open(os.path.join(out, "provenance.json"), "w") as fp:
        json.dump({"dataset": dataset, "generator_seed": 1000,
                   "val_action_acc_per_label": 0.9, "val_action_acc_exact_set": 0.7}, fp)
    return str(out)


def test_trained_extractor_matches_jax_and_loads_strictly(tmp_path):
    from mage_tpu.evals.i3d import import_i3d_torch, make_extractor as jax_extractor

    sd = _trunk(5)
    out = _write_extractor(tmp_path / "fvdx", trunk=sd)
    x = _clip(2, n=3)
    want = jax_extractor(import_i3d_torch(sd), batch_size=2, endpoint="Mixed_4f")(x)
    for path in (out, os.path.join(out, "i3d"), os.path.join(out, "i3d", "best")):
        extract, prov, dim = i3d.load_trained_extractor(path, batch_size=2, device="cpu")
        assert dim == 832 and prov.startswith(i3d.PROVENANCE)
        assert "0.900" in prov and "exact-set 0.700" in prov and "seed 1000" in prov
        got = extract(x)
        assert got.shape == (3, 832) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    with pytest.raises(FileNotFoundError):
        i3d.load_trained_extractor(str(tmp_path / "missing"), device="cpu")
    # the trunk form is strict: an extra or a missing key raises
    extra = dict(sd, **{"Mixed_5b.b0.conv3d.weight": torch.zeros(256, 832, 1, 1, 1)})
    with pytest.raises(RuntimeError, match="Unexpected"):
        i3d.make_extractor(extra, endpoint="Mixed_4f", device="cpu")
    missing = {k: v for k, v in sd.items() if not k.startswith("Mixed_4f.b3b")}
    with pytest.raises(RuntimeError, match="Missing"):
        i3d.make_extractor(missing, endpoint="Mixed_4f", device="cpu")
    with pytest.raises(ValueError, match="trunk"):
        i3d.I3D(trunk=True)
    assert not any(k.startswith(("Mixed_5", "logits"))
                   for k in i3d.LabelI3D(4).state_dict())


def test_resolve_extractor_order_and_errors(tmp_path, monkeypatch):
    """As ``tests/test_fvd_extractor.py`` pins JAX's: a named checkpoint
    first; a named extractor directory must fit (provenance, a dataset, the
    family, a checkpoint) or raise; the default directories are skipped
    silently when they do not fit; then the random-init Mixed_3c
    extractor."""
    monkeypatch.chdir(tmp_path)
    cater = _write_extractor(tmp_path / "cater")
    for dataset in ("CATER-GEN-v1", "CATER-GEN-v2"):  # v1 and v2: one family
        _, prov, dim = fvd.resolve_extractor(dataset, 2, extractor_dir=cater, device="cpu")
        assert "action-trained" in prov and dim == 832
    with pytest.raises(ValueError, match="family mismatch"):
        fvd.resolve_extractor("MovingMNIST", 2, extractor_dir=cater, device="cpu")
    with pytest.raises(FileNotFoundError, match="provenance.json"):
        fvd.resolve_extractor(None, 2, extractor_dir=cater, device="cpu")
    with pytest.raises(FileNotFoundError, match="provenance.json"):
        fvd.resolve_extractor("CATER-GEN-v2", 2, extractor_dir=str(tmp_path / "nope"),
                              device="cpu")
    os.remove(os.path.join(cater, "i3d", "best"))
    with pytest.raises(FileNotFoundError, match="no trained FVD extractor"):
        fvd.resolve_extractor("CATER-GEN-v2", 2, extractor_dir=cater, device="cpu")
    # a named Kinetics checkpoint comes first
    path = tmp_path / "rgb.pt"
    torch.save(i3d.random_state_dict(7, num_classes=10), path)
    _, prov, dim = fvd.resolve_extractor("CATER-GEN-v2", 2, i3d_checkpoint=str(path),
                                         extractor_dir=cater, device="cpu")
    assert dim == 10 and "rgb.pt" in prov
    # default discovery under the working directory
    _, prov, dim = fvd.resolve_extractor("MovingMNIST", 2, device="cpu")
    assert "random-init" in prov and dim == 480
    _write_extractor(tmp_path / "runs" / "fvd_extractor")
    _write_extractor(tmp_path / "runs" / "fvd_extractor_mnist", "MovingMNIST")
    _, prov, dim = fvd.resolve_extractor("CATER-GEN-v1", 2, device="cpu")
    assert "action-trained" in prov and dim == 832
    _, prov, dim = fvd.resolve_extractor("MovingMNIST", 2, device="cpu")
    assert "action-trained" in prov  # the first default skipped: another family
    _, prov, dim = fvd.resolve_extractor(None, 2, device="cpu")
    assert "random-init" in prov and dim == 480  # no dataset: none fits


def test_extractor_cli_trains_resumes_and_is_found(tmp_path):
    """The CLI end to end on the CPU (MNIST, 4 + 4 clips, 2 steps): its
    metrics and provenance, a trunk ``resolve_extractor`` loads, and a
    relaunch with one more epoch resumes at epoch 1."""
    out = tmp_path / "fvdx"
    argv = ["--tiny", "--device", "cpu", "--dataset", "mnist", "--out", str(out),
            "--num-train", "4", "--num-val", "4", "--batch", "2", "--chunk", "1",
            "--frames-length", "4", "--calib-videos", "4", "--epochs", "1"]
    rows = train_fvd_extractor.main(argv)
    assert set(rows) == {"trained_Mixed_4f", "random_Mixed_3c"}
    for row in rows.values():
        assert {"floor", "static", "static_over_floor"} <= set(row)
        assert all(np.isfinite(row[k]) for k in ("floor", "static", "static_over_floor"))
    prov = json.loads((out / "provenance.json").read_text())
    assert prov["dataset"] == "MovingMNIST" and prov["generator_seed"] == 1000
    assert {"val_digit_acc", "val_axis_acc", "val_sign_acc", "calibration"} <= set(prov)
    extract, text, dim = fvd.resolve_extractor("MovingMNIST", 2, extractor_dir=str(out),
                                               device="cpu")
    assert dim == 832 and "generator seed 1000" in text
    assert extract(_clip(0, t=4, size=64)).shape == (2, 832)
    train_fvd_extractor.main(argv[:-1] + ["2"])
    epochs = [json.loads(line)["epoch"] for line in
              (out / "metrics.json").read_text().splitlines()
              if json.loads(line)["phase"] == "extractor"]
    assert epochs == [0, 1]
    assert torch.load(out / "i3d" / "last", weights_only=True)["epoch"] == 1


def test_precision_copy_equals_jax():
    import importlib

    import eval_precision as jax_cli
    from mage_tpu_torch.data.generators import cater_synthetic as cs
    from mage_tpu_torch.data.generators import cater_text_anno as cta

    # the package re-exports a function under the module's name
    jax_precision = importlib.import_module("mage_tpu.evals.precision")
    assert eval_precision.SELF_TEST_CASES == jax_cli.SELF_TEST_CASES
    captions = [c for gt, gen, _, _ in jax_cli.SELF_TEST_CASES for c in (gt, gen)]
    for dataset in ("CATER-GEN-v1", "CATER-GEN-v2"):
        metas = cs.build_compact_cater(6, 1, seed=2, dataset=dataset)["train"]["meta"]
        for mode in ("explicit", "ambiguous"):
            captions += [cta.caption_for_scene(m, mode, dataset, random.Random(i))
                         for i, m in enumerate(metas)]
    captions += ["the colored cube is moving toward the red thing .", ""]
    for mode in ("explicit", "ambiguous"):
        parsed = [precision.sen_parse(c, mode) for c in captions]
        assert parsed == [jax_precision.sen_parse(c, mode) for c in captions]
        for a in [q for q in parsed if q]:  # both raise on an empty ground truth
            for b in parsed[:12]:
                assert precision.cross_check(a, b) == jax_precision.cross_check(a, b)
    with pytest.raises(SystemExit) as done:
        eval_precision.main(["--self-test", "--device", "cpu"])
    assert done.value.code == 0


def test_speed_control_reductions_match_jax():
    import eval_speed_control as jsc

    rng = np.random.RandomState(0)
    video = (rng.rand(3, 4, 6, 16, 16, 1) - 0.5).astype(np.float32)  # (S, B, T, H, W, 1)
    gt = (rng.rand(3, 4, 6, 16, 16, 1) - 0.5).astype(np.float32)
    valid = np.float32([1, 1, 0, 1, 0])
    track = eval_speed_control.centroid_track(torch.from_numpy(video[0]))
    np.testing.assert_allclose(track.numpy(), np.asarray(jsc.centroid_track(video[0])),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        eval_speed_control.masked_speed(track, torch.from_numpy(valid)).numpy(),
        np.asarray(jsc.masked_speed(jnp.asarray(track.numpy()), jnp.asarray(valid))),
        rtol=1e-6, atol=1e-6)
    mse = np.float32([0.0, 1e-3, 0.25, 2.0])
    np.testing.assert_allclose(eval_speed_control.mse_to_psnr(torch.from_numpy(mse)).numpy(),
                               np.asarray(jsc.mse_to_psnr(jnp.asarray(mse))), rtol=1e-6)
    # the PSNR matrix as the JAX script reduces it, then the report
    s_range = range(3)
    j_mat = np.asarray(jnp.stack([jnp.stack([
        jsc.mse_to_psnr(jnp.mean((jnp.asarray(video[i]) - jnp.asarray(gt[j])) ** 2))
        for j in s_range]) for i in s_range]))
    t_mat = torch.stack([torch.stack([
        eval_speed_control.mse_to_psnr(torch.mean((torch.from_numpy(video[i])
                                                   - torch.from_numpy(gt[j])) ** 2))
        for j in s_range]) for i in s_range]).numpy()
    np.testing.assert_allclose(t_mat, j_mat, rtol=1e-5)
    # CATER: the per-(gen speed, gt speed, scene) MSE and motion-energy rates
    v, g = jnp.asarray(video), jnp.asarray(gt)
    j_mse = np.asarray(jnp.mean((v[:, None] - g[None, :]) ** 2, axis=(3, 4, 5, 6)))
    j_rate = np.asarray(jnp.mean(jnp.abs(jnp.diff(v, axis=2)), axis=(1, 2, 3, 4, 5)))
    tv, tg = torch.from_numpy(video), torch.from_numpy(gt)
    np.testing.assert_allclose(
        torch.mean((tv[:, None] - tg[None, :]) ** 2, dim=(3, 4, 5, 6)).numpy(), j_mse,
        rtol=1e-5)
    np.testing.assert_allclose(
        torch.mean(torch.abs(torch.diff(tv, dim=2)), dim=(1, 2, 3, 4, 5)).numpy(), j_rate,
        rtol=1e-5)
    rec = eval_speed_control_cater.record(j_mse, j_rate, j_rate[::-1], [0.0, 0.5, 1.0], 4)
    psnr = 10.0 * np.log10(4.0 / np.maximum(j_mse.astype(np.float64), 1e-12))
    assert rec["psnr_matrix"] == [[round(float(x), 3) for x in r] for r in psnr.mean(-1)]
    assert rec["per_scene_matched_frac"] == float(
        (psnr.argmax(axis=1) == np.arange(3)[:, None]).mean())
    assert rec["gen_gt_rate_correlation"] == round(float(np.corrcoef(j_rate, j_rate[::-1])[0, 1]), 4)


MNIST_RUN = ["--tiny", "--num-train", "4", "--num-val", "4", "--frames-length", "4"]
CATER_RUN = ["--tiny", "--frames-length", "4"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A ``train_mnist_e2e`` and a ``train_cater_e2e`` run directory at
    ``--tiny`` widths, written from fresh port weights (no training)."""
    from mage_tpu_torch.cli import train_cater_e2e as tc
    from mage_tpu_torch.cli import train_mnist_e2e as tm
    from mage_tpu_torch.models.pipeline import init_weights
    from mage_tpu_torch.training.checkpoint import Checkpointer

    root = tmp_path_factory.mktemp("runs")
    out = {}
    for name, module, argv in (
            ("mnist", tm, MNIST_RUN),
            ("cater", tc, CATER_RUN + ["--dataset", "caterv1", "--num-train", "2",
                                       "--num-val", "4", "--config",
                                       "config/mage_caterv1.yaml"])):
        run = str(root / name)
        a = module.parse_args(argv + ["--out", run, "--device", "cpu"])
        model = module.make_vqvae(a, "cpu")
        init_weights(model, torch.Generator().manual_seed(0))
        Checkpointer(os.path.join(run, "vqvae")).save("best", {"state_dict": model.state_dict()})
        pipeline = module.build_pipeline(a, model, "cpu")
        for ckpt in ("best", "final"):
            Checkpointer(os.path.join(run, "mage")).save(
                ckpt, {"step": 0, "model": pipeline.core.state_dict()})
        out[name] = run
    return out


@pytest.fixture()
def cached_calls(monkeypatch):
    """Each ``MAGECore.generate_cached`` call's inputs, generator state and
    ids."""
    from mage_tpu_torch.models.mage import MAGECore

    calls, old = [], MAGECore.generate_cached

    def wrapped(self, latents0, text, speed=None, **kwargs):
        gen = kwargs.get("generator")
        state = gen.get_state().clone() if gen is not None else None
        ids = old(self, latents0, text, speed, **kwargs)
        calls.append((self.state_dict(), latents0, text, speed, state, ids))
        return ids

    monkeypatch.setattr(MAGECore, "generate_cached", wrapped)
    return calls


def _replay(pipeline, call):
    """The ids of ``pipeline.core.generate_cached`` on a call's inputs and
    weights, its prior noise drawn from the call's generator state."""
    sd, latents0, text, speed, state, ids = call
    pipeline.core.load_state_dict(sd)
    gen = torch.Generator().manual_seed(0)
    gen.set_state(state)
    b, _, h, w = latents0.shape
    noise = torch.randn((b, h, w, 64), generator=gen)
    return pipeline.core.generate_cached(latents0, text, speed, video_noise=noise), ids


def _finite(value):
    if isinstance(value, float):
        return np.isfinite(value)
    if isinstance(value, list):
        return all(_finite(v) for v in value)
    return True


def test_eval_fvd_e2e_on_a_run(runs, cached_calls, tmp_path):
    from mage_tpu_torch.cli import train_mnist_e2e as tm

    out = str(tmp_path / "fvd.json")
    rec = eval_fvd_e2e.main(["--run", runs["mnist"], "--videos", "4", "--device", "cpu",
                             "--out", out] + MNIST_RUN)
    assert set(rec) == {"phase", "samples", "fvd_gen_vs_gt", "fvd_recon_vs_gt",
                        "fvd_same_split_floor", "fvd_gen_over_floor", "gen_psnr_vs_gt",
                        "extractor", "feature_dim", "fvd_regularized", "time"}
    assert rec["samples"] == 4 and rec["feature_dim"] == 480
    assert all(_finite(v) for v in rec.values())
    assert json.loads(open(out).read().splitlines()[-1]) == rec
    a = tm.parse_args(MNIST_RUN + ["--out", runs["mnist"], "--device", "cpu"])
    pipeline = tm.build_pipeline(a, tm.make_vqvae(a, "cpu"), "cpu")
    got, want = _replay(pipeline, cached_calls[0])
    assert torch.equal(got, want)


def test_eval_speed_control_on_a_run(runs, cached_calls):
    from mage_tpu_torch.cli import train_mnist_e2e as tm

    rec = eval_speed_control.main(["--run", runs["mnist"], "--videos", "2", "--speeds",
                                   "0.05", "0.5", "0.95", "--gifs", "1", "--device",
                                   "cpu"] + MNIST_RUN)
    assert np.asarray(rec["psnr_matrix_gen_x_gt"]).shape == (3, 3)
    assert np.asarray(rec["per_frame_psnr_matched"]).shape == (3, 3)
    assert {"psnr_diagonal_dominant", "pos_err_diagonal_dominant", "gen_speed_monotonic",
            "gen_gt_rate_correlation", "recon_ceiling_matched"} <= set(rec)
    assert all(_finite(v) for k, v in rec.items() if k != "gen_gt_rate_correlation")
    assert json.load(open(os.path.join(runs["mnist"], "speed_control_metrics.json"))) == rec
    assert os.path.isfile(os.path.join(runs["mnist"], "gifs", "speed_sweep_0.gif"))
    _, latents0, _, speed, _, ids = cached_calls[0]
    assert ids.shape[0] == 6 and torch.equal(speed, torch.tensor([0.05, 0.05, 0.5, 0.5,
                                                                   0.95, 0.95]))
    assert torch.equal(latents0[:2], latents0[2:4])  # one first frame at every speed
    a = tm.parse_args(MNIST_RUN + ["--out", runs["mnist"], "--device", "cpu"])
    got, want = _replay(tm.build_pipeline(a, tm.make_vqvae(a, "cpu"), "cpu"), cached_calls[0])
    assert torch.equal(got, want)


def test_eval_speed_control_cater_on_a_run(runs, cached_calls):
    from mage_tpu_torch.cli import train_cater_e2e as tc

    argv = ["--run", runs["cater"], "--videos", "2", "--dataset", "caterv1", "--num-train",
            "2", "--num-val", "4", "--gifs", "1", "--device", "cpu"] + CATER_RUN
    rec = eval_speed_control_cater.main(argv)
    assert set(rec) == {"phase", "videos", "speeds", "psnr_matrix", "psnr_diagonal_dominant",
                        "diag_margin_db", "per_scene_matched_frac", "gen_motion_rate",
                        "gt_motion_rate", "gen_gt_rate_correlation", "gen_rate_monotonic"}
    assert np.asarray(rec["psnr_matrix"]).shape == (3, 3)
    assert all(_finite(v) for v in rec.values())
    rows = [json.loads(line) for line in
            open(os.path.join(runs["cater"], "e2e_metrics.json")).read().splitlines()]
    assert rows[-1]["phase"] == "speed_control"
    _, a = eval_speed_control_cater.parse_args(argv)
    got, want = _replay(tc.build_pipeline(a, tc.make_vqvae(a, "cpu"), "cpu"),
                        cached_calls[0])
    assert torch.equal(got, want)


CLIS = {
    "train_fvd_extractor": (train_fvd_extractor, ["--out"]),
    "eval_fvd_e2e": (eval_fvd_e2e, ["--run"]),
    "eval_speed_control": (eval_speed_control, ["--run"]),
    "eval_speed_control_cater": (eval_speed_control_cater, ["--run"]),
    "eval_precision": (eval_precision, ["--self-test", "--data-root"]),
}


@pytest.mark.parametrize("name", list(CLIS))
def test_new_clis_default_to_cuda_and_raise_without_a_gpu(name, tmp_path, monkeypatch):
    module, flags = CLIS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(flags + [str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()  # raised before any data or output
