"""The e2e harness and the five chains of the port against the JAX drivers.

The callbacks that feed the loops must equal JAX's bit for bit given the
same clip indices, frame indices and speeds: frame composition on the
device (``frames_at``) and the teacher-forced batches (ids gathered at the
speed-subsampled stored frames). The generation metrics (digit tracking,
sprite-NCC action precision, PSNR and SSIM) must equal JAX's on the same
arrays. Then every driver runs whole on the CPU below ``--tiny`` size (a few
clips, 4 frames, one or two epochs): it must end with JAX's phases and
record keys written, and a relaunch with more stage-2 epochs must resume at
the next epoch from the ``last`` checkpoints.
"""

import json

import numpy as np
import pytest
import torch

from mage_tpu_torch.cli import (
    train_cater_e2e,
    train_cater_kl_e2e,
    train_mnist2_e2e,
    train_mnist_e2e,
    train_mnist_kl_e2e,
)
from mage_tpu_torch.data import device_data as dd
from mage_tpu_torch.data.generators import cater_synthetic as cs
from mage_tpu_torch.training import e2e


def _idx(seed, n, m, t_store):
    rng = np.random.RandomState(seed)
    return rng.randint(0, n, m), rng.randint(0, t_store, m), rng.rand(m).astype(np.float32)


def _jax_dev(compact):
    import jax.numpy as jnp

    from mage_tpu.data import device_data as jdd

    return {"bank": jdd.normalize_bank(compact["bank"]),
            **{s: {k: jnp.asarray(v) for k, v in compact[s].items()} for s in ("train", "val")}}


@pytest.mark.parametrize("chain", ["mnist", "mnist2"])
def test_mnist_frames_and_batches_match_jax(chain):
    import jax
    import jax.numpy as jnp

    from mage_tpu.data import device_data as jdd

    if chain == "mnist":
        jmod = pytest.importorskip("train_mnist_e2e")
        compact = dd.build_compact_single_mnist(12, 4, seed=3)
        port, t_store = train_mnist_e2e, dd.SEQ_LENGTH
    else:
        jmod = pytest.importorskip("train_mnist2_e2e")
        compact = dd.build_compact_double_modified(12, 4, seed=3)
        port, t_store = train_mnist2_e2e, train_mnist2_e2e.T_STORED
    jdev, tdev = _jax_dev(compact), train_mnist_e2e.upload(compact, "cpu")
    idx, t, speed = _idx(1, 12, 10, t_store)
    want = np.asarray(jmod.frames_at(jdev, "train", jnp.asarray(idx), jnp.asarray(t)))
    got = port.frames_at(tdev, "train", torch.from_numpy(idx), torch.from_numpy(t))
    np.testing.assert_array_equal(got.numpy(), want)

    # the batch: ids at the speed-subsampled stored frames, as JAX's batch_at
    ids = np.random.RandomState(2).randint(0, 512, (12, t_store, 4, 4)).astype(np.int32)
    text = compact["train"]["text"]
    if chain == "mnist":
        pos = jax.vmap(lambda s: jdd.clip_indices(s, frames_length=16))(jnp.asarray(speed))
        batch = port.batch_from(_Args(16), torch.from_numpy(idx), torch.from_numpy(speed),
                                torch.from_numpy(ids), torch.from_numpy(text))
    else:
        length = compact["train"]["length"]
        pos = jax.vmap(lambda s, ln: jdd.clip_indices_var(s, ln, 16))(
            jnp.asarray(speed), jnp.asarray(length)[idx])
        batch = port.batch_from(_Args(16), torch.from_numpy(idx), torch.from_numpy(speed),
                                torch.from_numpy(ids), torch.from_numpy(text),
                                torch.from_numpy(length))
    np.testing.assert_array_equal(batch["latents"].numpy(),
                                  ids[idx[:, None], np.asarray(pos)])
    np.testing.assert_array_equal(batch["text"].numpy(), text[idx])


class _Args:
    def __init__(self, frames_length, posterior_logvar_shift=0.0):
        self.frames_length = frames_length
        self.posterior_logvar_shift = posterior_logvar_shift


def test_cater_frames_positions_and_batches_match_jax():
    import jax.numpy as jnp

    jce = pytest.importorskip("train_cater_e2e")
    compact = cs.build_compact_cater(6, 2, seed=4, dataset="CATER-GEN-v1",
                                     context_length=32)
    jdev = {"bank": jnp.concatenate([jnp.asarray(compact["bank"][..., :3], jnp.float32)
                                     / 127.5 - 1.0,
                                     jnp.asarray(compact["bank"][..., 3:], jnp.float32)], -1),
            "background": jnp.asarray(compact["background"], jnp.float32) / 127.5 - 1.0,
            "train": {k: jnp.asarray(v) for k, v in compact["train"].items() if k != "meta"}}
    tdev = train_cater_e2e.upload(compact, "cpu")
    idx, t, _ = _idx(5, 6, 8, cs.T_STORE)
    want = np.asarray(jce.frames_at(jdev, "train", jnp.asarray(idx), jnp.asarray(t)))
    got = train_cater_e2e.frames_at(tdev, "train", torch.from_numpy(idx), torch.from_numpy(t))
    np.testing.assert_array_equal(got.numpy(), want)
    # every speed's positions, at a dense grid and the edges of [0, 1)
    speed = np.concatenate([np.linspace(0, 1, 4097, dtype=np.float32)[:-1],
                            np.float32([0.999999, 0.5, 1.0])])
    for length in (4, 10):
        want_pos = np.stack([np.asarray(jce.clip_positions(jnp.float32(s), length))
                             for s in speed[::64]])
        got_pos = train_cater_e2e.clip_positions(torch.from_numpy(speed[::64]), length)
        np.testing.assert_array_equal(got_pos.numpy(), want_pos)
    ids = np.random.RandomState(6).randint(0, 512, (6, cs.T_STORE, 4, 4)).astype(np.int32)
    spd = np.float32([0.0, 0.3, 0.99])
    batch = train_cater_e2e.batch_from(_Args(10), torch.tensor([0, 5, 2]), torch.from_numpy(spd),
                                       torch.from_numpy(ids),
                                       torch.from_numpy(compact["train"]["text"]))
    pos = np.stack([np.asarray(jce.clip_positions(jnp.float32(s), 10)) for s in spd])
    np.testing.assert_array_equal(batch["latents"].numpy(), ids[[0, 5, 2]][np.arange(3)[:, None], pos])


def test_generation_metrics_match_jax():
    jm2 = pytest.importorskip("train_mnist2_e2e")
    jce = pytest.importorskip("train_cater_e2e")
    from mage_tpu.training import e2e as jax_e2e

    # digit tracking on composed clips (generated = GT shifted by a frame)
    compact = dd.build_compact_double_modified(4, 2, seed=7)
    tdev = train_mnist_e2e.upload(compact, "cpu")
    pos = np.stack([np.arange(0, 16)] * 4)
    frames = train_mnist2_e2e.frames_at(
        tdev, "train", torch.arange(4).repeat_interleave(16),
        torch.from_numpy(pos.reshape(-1))).reshape(4, 16, 64, 64).numpy()
    host = {k: v for k, v in compact["train"].items() if k != "text"}
    bank = tdev["bank"].numpy()
    for gen in (frames[:, 1:], frames[:, :-1]):
        assert (train_mnist2_e2e.motion_metrics(gen, host, bank, np.arange(4), pos)
                == jm2.motion_metrics(gen, host, bank, np.arange(4), pos))
    # sprite-NCC action precision on GT renders and on a frozen rollout
    compact = cs.build_compact_cater(1, 4, seed=5)
    cpos = train_cater_e2e.clip_positions(torch.tensor(1.0), 10).numpy()
    bg = cs.floor_background()
    d = compact["val"]
    vids = np.stack([np.stack([cs.render_frame(compact["bank"], bg, d["sid"][m, t],
                                               d["top"][m, t], d["left"][m, t])
                               for t in cpos]) for m in range(4)]).astype(np.float64)
    vids = vids / 127.5 - 1.0
    for v in (vids[:, 1:], np.repeat(vids[:, :1], 9, axis=1)):
        for quad in (False, True):
            assert (train_cater_e2e.precision_metrics(v, d["meta"], compact["bank_index"],
                                                      compact["bank"], quadrant_level=quad)
                    == jce.precision_metrics(v, d["meta"], compact["bank_index"],
                                             compact["bank"], quadrant_level=quad))
    # PSNR and SSIM as the harness reports them
    rng = np.random.RandomState(0)
    a, b = rng.rand(3, 16, 16, 3) * 2 - 1, rng.rand(3, 16, 16, 3) * 2 - 1
    assert e2e._mean_ssim(a, b, 2.0) == jax_e2e._mean_ssim(a, b, 2.0)
    assert e2e._mean_ssim(a[..., :1], b[..., :1], 1.0) == jax_e2e._mean_ssim(
        a[..., :1], b[..., :1], 1.0)
    for mse, rng_ in ((0.01, 1.0), (0.04, 2.0), (0.0, 1.0), (3.7e-5, 2.0)):
        assert e2e.mse_to_psnr(mse, rng_) == jax_e2e.mse_to_psnr(mse, rng_)


def test_materialize_pads_the_last_chunk_with_index_zero(tmp_path):
    calls = []

    def encode_chunk(idx):
        calls.append(idx.tolist())
        return idx.to(torch.float32) * 2.0

    out = e2e.materialize(7, 3, encode_chunk)
    assert calls == [[0, 1, 2], [3, 4, 5], [6, 0, 0]]
    np.testing.assert_array_equal(out.numpy(), 2.0 * np.arange(7))
    np.testing.assert_array_equal(e2e.materialize(6, 3, lambda i: i).numpy(), np.arange(6))
    e2e.log_metrics(str(tmp_path), {"phase": "x", "v": 1})
    e2e.log_metrics(str(tmp_path), {"phase": "y", "v": 2})
    rows = [json.loads(l) for l in (tmp_path / "e2e_metrics.json").read_text().splitlines()]
    assert [r["phase"] for r in rows] == ["x", "y"] and all("time" in r for r in rows)


# the phases and keys each JAX driver writes (mage_tpu/training/e2e.py and
# the root train_*_e2e.py drivers)
STAGE1 = {"phase", "epoch", "train_loss", "val_recon_mse", "val_recon_psnr",
          "codebook_used", "sec_per_epoch"}
STAGE1_FINAL = {"phase", "val_recon_mse", "val_recon_psnr", "val_ssim", "codebook_used"}
KLAE = {"phase", "epoch", "train_recon", "val_recon_mse", "val_recon_psnr", "sec_per_epoch"}
KLAE_FINAL = {"phase", "val_recon_mse", "val_recon_psnr", "val_ssim"}
LATENTS = {"phase", "train_shape", "sec"}
STAGE2 = {"phase", "epoch", "lr", "train_loss", "val_loss", "val_prediction", "sec_per_epoch"}
STAGE2_PLUS = STAGE2 | {"train_kl", "beta"}
GEN = {"phase", "samples", "gen_psnr_vs_gt", "recon_psnr_vs_gt_upper_bound"}
TRACKS = {"digit_tracks", "mean_track_error_px", "motion_correct_frac",
          "initial_direction_acc", "direction_cases", "recon_motion_correct_ceiling",
          "recon_track_error_px_ceiling", "recon_direction_acc_ceiling"}
PRECISION = {"action_precision", "referring_precision", "action_cases", "referring_cases",
             "per_action", "gt_action_precision_ceiling", "gt_referring_precision_ceiling"}
FVD = {"phase", "samples", "fvd_gen_vs_gt", "fvd_recon_vs_gt", "fvd_same_split_floor",
       "fvd_gen_over_floor", "extractor", "feature_dim",
       # the port's one addition: the distances whose root was regularised
       "fvd_regularized"}
SAMPLERS = {"phase", "samples", "cached_psnr_vs_gt", "naive_psnr_vs_gt", "psnr_gap_db",
            "cached_vs_naive_latent_mse", "latent_scale_msq"}
DIVERSITY = {"phase", "samples", "draws", "best_of_k_psnr", "worst_of_k_psnr", "mean_psnr",
             "pairwise_mse", "gt_motion_mse_scale"}
PER_DRAW = {"per_draw_action_precision", "per_draw_referring_precision"}

VQ_SMALL = ["--tiny", "--device", "cpu", "--frames-length", "4", "--chunk", "1",
            "--stage1-epochs", "1", "--batch2", "2"]
KL_SMALL = ["--tiny", "--device", "cpu", "--frames-length", "4", "--chunk", "1",
            "--ae-epochs", "1", "--batch2", "2"]
CHAINS = {
    "mnist": (train_mnist_e2e, VQ_SMALL + ["--num-train", "4", "--num-val", "4"], [
        ("stage1", STAGE1), ("stage1_final", STAGE1_FINAL), ("latents", LATENTS),
        ("stage2", STAGE2), ("generation_val", GEN), ("generation_train", GEN)]),
    "mnist2": (train_mnist2_e2e, VQ_SMALL + ["--num-train", "4", "--num-val", "4"], [
        ("stage1", STAGE1), ("stage1_final", STAGE1_FINAL), ("latents", LATENTS),
        ("stage2", STAGE2), ("generation_val", GEN | TRACKS), ("fvd_val", FVD),
        ("generation_train", GEN | TRACKS), ("fvd_train", FVD)]),
    "mnist_kl": (train_mnist_kl_e2e, KL_SMALL + ["--num-train", "4", "--num-val", "4"], [
        ("klae", KLAE), ("klae_final", KLAE_FINAL), ("moments", LATENTS),
        ("stage2", STAGE2_PLUS), ("samplers_val", SAMPLERS), ("diversity_val", DIVERSITY),
        ("fvd_val", FVD)]),
    "cater": (train_cater_e2e, VQ_SMALL + ["--num-train", "2", "--num-val", "4",
                                           "--dataset", "caterv1"], [
        ("stage1", STAGE1 | {"val_recon_psnr_motion"}), ("stage1_final", STAGE1_FINAL),
        ("latents", LATENTS), ("stage2", STAGE2), ("generation_val", GEN | PRECISION),
        ("fvd_val", FVD)]),
    "cater_kl": (train_cater_kl_e2e, KL_SMALL + ["--num-train", "2", "--num-val", "4"], [
        ("klae", KLAE), ("klae_final", KLAE_FINAL), ("moments", LATENTS),
        ("stage2", STAGE2_PLUS), ("samplers_val", SAMPLERS | {"recon_psnr_vs_gt_upper_bound"}),
        ("diversity_val", DIVERSITY | PER_DRAW), ("generation_val", GEN | PRECISION),
        ("fvd_val", FVD)]),
}


def _records(out):
    return [json.loads(l) for l in (out / "e2e_metrics.json").read_text().splitlines()]


@pytest.mark.parametrize("chain", list(CHAINS))
def test_chain_runs_to_its_end_and_resumes(chain, tmp_path):
    module, argv, phases = CHAINS[chain]
    out = tmp_path / chain
    module.main(argv + ["--out", str(out), "--stage2-epochs", "1"])
    rows = _records(out)
    assert [r["phase"] for r in rows] == [p for p, _ in phases]
    for row, (phase, keys) in zip(rows, phases):
        assert set(row) == keys | {"time"}, (phase, set(row) ^ (keys | {"time"}))
        for k, v in row.items():
            if isinstance(v, float):
                assert np.isfinite(v), (phase, k, v)
    assert rows[[p for p, _ in phases].index("stage2")]["epoch"] == 0
    stage1 = "vqvae" if "stage1" in dict(phases) else "klae"
    for name in ("best", "final", "last"):
        assert (out / stage1 / name).is_file() and (out / "mage" / name).is_file()
    if chain not in ("mnist", "mnist_kl"):
        return
    # a relaunch with one more stage-2 epoch resumes both stages from "last":
    # stage 1 has no epoch left, stage 2 goes on at epoch 1
    module.main(argv + ["--out", str(out), "--stage2-epochs", "2"])
    again = [r for r in _records(out)[len(rows):] if r["phase"] in ("stage1", "klae", "stage2")]
    assert [(r["phase"], r["epoch"]) for r in again] == [("stage2", 1)]
    last = torch.load(out / "mage" / "last", weights_only=True)
    assert last["epoch"] == 1 and last["state"]["step"] == 2 * (4 // 2)
    if chain == "mnist_kl":
        assert last["state"]["pid"].shape == (3,)


@pytest.mark.parametrize("chain", list(CHAINS))
def test_drivers_default_to_cuda_and_raise_without_a_gpu(chain, tmp_path, monkeypatch):
    module = CHAINS[chain][0]
    assert module.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        module.main(["--out", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()  # raised before any data or output


def test_main_mage_kv_quant_flag():
    from mage_tpu_torch.cli import main_mage

    assert main_mage.parse_args([]).kv_quant is None
    assert main_mage.parse_args(["--kv-quant", "int4"]).kv_quant == "int4"
    with pytest.raises(SystemExit):
        main_mage.parse_args(["--kv-quant", "int2"])
