"""The three caption probes in the port against the JAX package's root
scripts, on the CPU, in f32.

- The helpers (token swaps, first directions, clause directions) equal the
  JAX probes' functions.
- The scoring and the tracking equal JAX's: each probe's ``--ceiling-only``
  line (ground-truth clips through the same window, gating and tracker) is
  the JAX probe's own, on the same tiny dataset.
- The measuring functions on carried weights: teacher-forced per-frame CE
  within 1e-5 relative (argmax ids equal), the centroid displacement of a
  given video within 1e-5 relative, the template-tracked one equal.
- Each probe's ``main`` runs end to end over a run directory written here
  with seeded weights in the chains' layout (``vqvae/best``, ``mage/final``).
"""

import math
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import probe_direction_binding as jax_probe1  # noqa: E402
import probe_direction_binding2 as jax_probe2  # noqa: E402
from mage_tpu_torch.cli import probe_direction_binding as probe1  # noqa: E402
from mage_tpu_torch.cli import probe_direction_binding2 as probe2  # noqa: E402
from mage_tpu_torch.cli import probe_text_sensitivity as probe_text  # noqa: E402
from mage_tpu_torch.data import device_data as dd  # noqa: E402

TOL = 1e-5
CHAIN = ["--tiny", "--num-train", "16", "--num-val", "8"]


@pytest.fixture(scope="module", autouse=True)
def keep_global_torch_rng():
    """Leave torch's global generator as this module found it: tests in
    other files draw from it unseeded, so their draws must not depend on
    whether this module ran first in their worker."""
    with torch.random.fork_rng():
        yield


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def double_val():
    return dd.build_compact_double_modified(12, 8, seed=3)["val"]


def test_token_maps_and_swaps_equal_jax(double_val):
    for name in ("DIR_TOKENS", "SIGN_SWAP", "AXIS_SWAP"):
        assert getattr(probe1, name) == getattr(jax_probe1, name)
        assert getattr(probe2, name) == getattr(jax_probe2, name)
    text = double_val["text"]
    for mapping in (probe1.SIGN_SWAP, probe1.AXIS_SWAP):
        want = jax_probe1.swap_tokens(text, mapping)
        np.testing.assert_array_equal(probe1.swap_tokens(text, mapping), want)
        np.testing.assert_array_equal(
            probe1.swap_tokens(torch.from_numpy(text), mapping).numpy(), want)
        np.testing.assert_array_equal(probe2.swap_tokens(text, mapping),
                                      jax_probe2.swap_tokens(text, mapping))


def test_first_and_clause_directions_equal_jax(double_val):
    single = dd.build_compact_single_mnist(12, 8, seed=3)["val"]["text"]
    rows = list(single) + list(double_val["text"]) + [np.zeros(8, np.int32)]
    for row in rows:
        assert probe1.first_direction(row) == jax_probe1.first_direction(row)
        assert probe2.clause_directions(row) == jax_probe2.clause_directions(row)


def _jax_ceiling(monkeypatch, capsys, jax_probe, chain_module, argv):
    """Run the JAX probe's ``--ceiling-only`` on the tiny dataset -> its line."""
    chain = pytest.importorskip(chain_module)
    real = chain.parse_args
    monkeypatch.setattr(chain, "parse_args",
                        lambda a: real([*a, "--num-train", "16", "--num-val", "8"]))
    capsys.readouterr()
    jax_probe.main(["--ceiling-only", *argv])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.search(r"axis agreement (\d+)/(\d+) .*sign given axis (\d+)/(\d+) .*, "
                  r"(\d+) wall-blocked", line)
    return dict(zip(("axis_agree", "n", "sign_agree", "n_axis_agree", "wall_blocked"),
                    map(int, m.groups())))


@pytest.mark.parametrize("which", ["single", "double"])
@pytest.mark.parametrize("frames, min_room", [(1, 12), (2, 4)])
def test_ceiling_scores_equal_the_jax_probes(which, frames, min_room, monkeypatch, capsys,
                                             tmp_path):
    argv = ["--run", str(tmp_path), "--videos", "8", "--frames", str(frames),
            "--min-room", str(min_room)]
    if which == "single":
        want = _jax_ceiling(monkeypatch, capsys, jax_probe1, "train_mnist_e2e", argv)
        got = probe1.main([*argv, "--ceiling-only", "--device", "cpu", *CHAIN])
    else:
        want = _jax_ceiling(monkeypatch, capsys, jax_probe2, "train_mnist2_e2e", argv)
        got = probe2.main([*argv, "--ceiling-only", "--device", "cpu", *CHAIN])
    assert {k: got["gt_ceiling"][k] for k in want} == want
    assert want["n"] > 0


def test_displacements_equal_jax_on_a_given_video():
    import train_mnist2_e2e as jax_mnist2
    from eval_speed_control import centroid_track as jax_centroid_track

    rng = np.random.RandomState(0)
    video = (rng.rand(3, 5, 64, 64, 1).astype(np.float32) - 0.5)
    start = rng.rand(3, 2).astype(np.float32) * 30
    want = np.asarray(jax_centroid_track(jnp.asarray(video)))[:, 1] - start
    got = probe1.displacement(torch.from_numpy(video), torch.from_numpy(start), 2).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL)
    template = rng.rand(28, 28).astype(np.float32)
    frames = video[0, ..., 0]
    frames[2, 10:38, 20:48] += 2 * template
    tr = jax_mnist2.track_digit(frames, template)
    assert probe2.digit_displacement(frames, template, 4, 6, 3) == (
        float(tr[2, 0] - 4), float(tr[2, 1] - 6)) == (6.0, 14.0)


def test_per_frame_ce_matches_jax_on_carried_weights(monkeypatch):
    """The probe's teacher-forced CE, with JAX's computed as the JAX probe
    computes it, on one posterior draw given to both."""
    from test_torch_port_train import B, LAT, _batch, _config, _patched_normal

    import flax

    from mage_tpu.models.pipeline import MagePipeline as JaxPipeline
    from mage_tpu.models.vqvae import VectorQuantizedVAE as JaxVQVAE
    from mage_tpu_torch.compat import from_jax
    from mage_tpu_torch.models.pipeline import MagePipeline

    cfg = _config(False)
    fs_vars = jax.jit(JaxVQVAE(**cfg["first_stage_config"]["params"]).init)(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3), jnp.float32))
    jp = JaxPipeline(**cfg, first_stage_variables=fs_vars)
    batch = _batch(False)
    params = flax.core.unfreeze(jp.init(jax.random.PRNGKey(0), batch))
    ids = np.array(jp.encode_first_stage(jnp.asarray(batch["images"]), fs_variables=fs_vars))
    text, speed = batch["text"], batch["speed"]
    noise = np.random.RandomState(4).randn(B, LAT, LAT, 64).astype(np.float32)
    _patched_normal(monkeypatch, noise)

    @jax.jit
    def jax_ce(txt):
        out = jp.core.apply({"params": params}, jnp.asarray(ids), txt,
                            jnp.asarray(speed), train=False,
                            rngs={"dropout": jax.random.PRNGKey(0),
                                  "latent": jax.random.PRNGKey(0)})
        logits = out["predict"].astype(jnp.float32)
        tgt = jnp.asarray(ids)[:, 1:]
        ll = jnp.take_along_axis(logits, tgt[..., None], axis=-1)[..., 0]
        ce = (jax.nn.logsumexp(logits, axis=-1) - ll).mean(axis=(0, 2, 3))
        return ce, jnp.argmax(logits, axis=-1)

    tp = MagePipeline(**cfg, device="cpu")
    from_jax.load_pipeline(tp, params, fs_vars, text_layers=1, ma_layers=1, dec_layers=3)
    for txt in (text, probe1.swap_tokens(text, probe1.SIGN_SWAP), np.roll(text, 1, axis=0)):
        want_ce, want_am = map(np.asarray, jax_ce(jnp.asarray(txt)))
        ce, am = probe_text.per_frame_ce(tp.core, torch.from_numpy(ids), torch.from_numpy(speed),
                                         torch.from_numpy(txt), torch.from_numpy(noise))
        np.testing.assert_allclose(ce.numpy(), want_ce, rtol=TOL)
        np.testing.assert_array_equal(am.numpy(), want_am)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A single and a double run directory of seeded weights in the chains'
    layout; nothing is trained."""
    from mage_tpu_torch.cli import train_mnist2_e2e
    from mage_tpu_torch.cli import train_mnist_e2e as tm
    from mage_tpu_torch.training.checkpoint import Checkpointer

    out = {}
    for which, chain in (("single", tm), ("double", train_mnist2_e2e)):
        run = tmp_path_factory.mktemp(which)
        targs = chain.parse_args(["--out", str(run), "--device", "cpu", *CHAIN])
        torch.manual_seed(0)
        model = tm.make_vqvae(targs, "cpu")
        pipeline = tm.build_pipeline(targs, model, "cpu")
        Checkpointer(str(run / "vqvae")).save("best", {"step": 0,
                                                       "state_dict": model.state_dict()})
        Checkpointer(str(run / "mage")).save("final", {"step": 0,
                                                       "model": pipeline.core.state_dict()})
        out[which] = str(run)
    return out


def _finite(values):
    return all(math.isfinite(v) for v in values)


@pytest.mark.parametrize("dataset", ["single", "double"])
def test_text_sensitivity_main_runs_over_a_run_directory(dataset, runs):
    rec = probe_text.main(["--dataset", dataset, "--run", runs[dataset], "--videos", "3",
                           "--device", "cpu", *CHAIN])
    assert rec["videos"] == 3
    assert set(rec["per_frame_ce"]) == {"true", "swapped", "shuffled"}
    assert all(len(v) == 15 and _finite(v) for v in rec["per_frame_ce"].values())
    assert _finite([rec["delta_swapped_pct"], rec["delta_shuffled_pct"],
                    rec["argmax_changed_swapped_pct"], rec["frames_1_4_delta_swapped_pct"]])
    assert rec["mean_ce"]["true"] > 0


@pytest.mark.parametrize("which", ["single", "double"])
def test_direction_binding_main_runs_over_a_run_directory(which, runs):
    probe = probe1 if which == "single" else probe2
    rec = probe.main(["--run", runs[which], "--videos", "3", "--device", "cpu", *CHAIN])
    for column in ("gt_ceiling", "true", "sign_swap", "axis_swap"):
        s = rec[column]
        assert s["n"] + s["wall_blocked"] > 0
        assert 0 <= s["axis_agree"] <= s["n"] and 0 <= s["sign_agree"] <= s["n_axis_agree"]
    assert _finite([rec["mse_true_vs_sign_swap"], rec["mse_true_vs_axis_swap"]])


@pytest.mark.parametrize("probe, argv", [
    (probe_text.main, ["--dataset", "single"]),
    (probe1.main, ["--ceiling-only"]),
    (probe2.main, []),
], ids=["text_sensitivity", "direction_binding", "direction_binding2"])
def test_probes_default_to_the_gpu_and_raise_without_one(probe, argv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe(argv + ["--run", str(tmp_path), *CHAIN])
