"""The port's device-resident data builders against the JAX package's.

``mage_tpu_torch.data.device_data`` on CPU tensors against
``mage_tpu.data.device_data`` under JAX on the CPU, bit for bit: the numpy
builders' arrays, the normalised bank, every compose function (single,
clip, double with its distractor, synthetic CATER) and both clip-index
functions. Cases include window corners outside the canvas, where JAX's
dynamic slices count a negative start from the end and clamp the start so
the window fits, and the compose of every record the ``.mrs`` generator
writes.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mage_tpu.data import device_data as jdd  # noqa: E402
from mage_tpu.data.generators import cater_synthetic as jcs  # noqa: E402
from mage_tpu_torch.data import device_data as tdd  # noqa: E402
from mage_tpu_torch.data.datasets import speed_subsample_indices  # noqa: E402
from mage_tpu_torch.data.generators import mnist_common as mc  # noqa: E402
from mage_tpu_torch.data.generators import mnist_single  # noqa: E402
from mage_tpu_torch.data.recordio import RecordReader  # noqa: E402


def _t(a):
    return torch.as_tensor(np.array(a))


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.device.type == "cpu" and got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def _assert_compact_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["bank"], want["bank"])
    for split in ("train", "val"):
        assert sorted(got[split]) == sorted(want[split])
        for key, value in want[split].items():
            assert got[split][key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[split][key], value)


@pytest.mark.parametrize("seed", [0, 11])
def test_build_compact_single_mnist_equal(seed):
    _assert_compact_equal(tdd.build_compact_single_mnist(6, 4, seed=seed),
                          jdd.build_compact_single_mnist(6, 4, seed=seed))


@pytest.mark.parametrize("context_length", [32, 20])
def test_build_compact_double_modified_equal(context_length):
    bank = mc.load_digit_bank(None, samples_per_digit=5, seed=11)
    kw = dict(seed=11, bank=bank, context_length=context_length)
    _assert_compact_equal(tdd.build_compact_double_modified(6, 3, **kw),
                          jdd.build_compact_double_modified(6, 3, **kw))


@pytest.fixture(scope="module")
def single():
    compact = tdd.build_compact_single_mnist(5, 2, seed=3)
    return compact, tdd.normalize_bank(compact["bank"]), jdd.normalize_bank(compact["bank"])


def test_normalize_bank_equal(single):
    _, bank_t, bank_j = single
    assert bank_t.dtype == torch.float32
    _equal(bank_t, bank_j)


# (ys, xs) overrides for the first five frames: None keeps the tracks; the
# rest put corners below 0 (counted from the end, then clamped) and past
# the canvas (clamped to 64 - 28)
CORNERS = {"tracks": None,
           "outside": ([-3, 40, 70, 36, -64], [50, -9, 37, -1, 100])}


@pytest.mark.parametrize("case", sorted(CORNERS))
def test_compose_frames_equal(single, case):
    compact, bank_t, bank_j = single
    tr = compact["train"]
    digit = np.repeat(tr["digit"], tdd.SEQ_LENGTH)
    ys, xs = tr["ys"].reshape(-1).copy(), tr["xs"].reshape(-1).copy()
    if CORNERS[case] is not None:
        ys[:5], xs[:5] = CORNERS[case]
    got = tdd.compose_frames(bank_t, _t(digit), _t(ys), _t(xs))
    assert got.shape == (digit.shape[0], 64, 64, 1)
    _equal(got, jdd.compose_frames(bank_j, jnp.asarray(digit), jnp.asarray(ys),
                                   jnp.asarray(xs)))


def test_compose_frames_reproduces_the_generator_records(tmp_path):
    """Every record ``mnist_single.main`` writes for a seed is the compose of
    ``build_compact_single_mnist``'s arrays for that seed, /255 - 0.5."""
    mnist_single.main(["--out", str(tmp_path), "--num-train", "6", "--num-val", "3",
                       "--seed", "2"])
    compact = tdd.build_compact_single_mnist(6, 3, seed=2)
    bank = tdd.normalize_bank(compact["bank"])
    for split, name in (("train", "train"), ("val", "test")):
        c = compact[split]
        frames = tdd.compose_frames(
            bank, _t(np.repeat(c["digit"], tdd.SEQ_LENGTH)), _t(c["ys"].reshape(-1)),
            _t(c["xs"].reshape(-1))).reshape(-1, tdd.SEQ_LENGTH, 64, 64)
        records = RecordReader(tmp_path / f"mnist_single_20f_10k_{name}.mrs")
        assert len(records) == frames.shape[0]
        for i in range(len(records)):
            video, _ = records[i]
            np.testing.assert_array_equal(frames[i].numpy(),
                                          video.astype(np.float32) / 255.0 - 0.5)


def test_compose_clip_equal(single):
    compact, bank_t, bank_j = single
    tr = compact["train"]
    for k in range(4):
        pos = jdd.clip_indices(jnp.float32(0.23 * k), frames_length=10)
        got = tdd.compose_clip(bank_t, _t(tr["digit"][k]), _t(tr["ys"][k]), _t(tr["xs"][k]),
                               _t(pos))
        _equal(got, jdd.compose_clip(bank_j, jnp.asarray(tr["digit"][k]),
                                     jnp.asarray(tr["ys"][k]), jnp.asarray(tr["xs"][k]), pos))


@pytest.mark.parametrize("case", sorted(CORNERS))
def test_compose_frames_double_equal(case):
    images, labels = mc.load_digit_bank(None, samples_per_digit=5, seed=11)
    c = tdd.build_compact_double_modified(5, 2, seed=11, bank=(images, labels))["train"]
    t = tdd.SEQ_LENGTH + 1
    args = [np.repeat(c["d1"], t), c["ys1"].reshape(-1).copy(), c["xs1"].reshape(-1).copy(),
            np.repeat(c["d2"], t), c["ys2"].reshape(-1), c["xs2"].reshape(-1),
            np.repeat(c["bg"], t), np.repeat(c["bg_y"], t).copy(), np.repeat(c["bg_x"], t),
            np.repeat(c["has_bg"], t)]
    if CORNERS[case] is not None:
        args[1][:5], args[2][:5] = CORNERS[case]
        args[7][:5] = CORNERS[case][1]
    got = tdd.compose_frames_double(tdd.normalize_bank(images), *map(_t, args))
    _equal(got, jdd.compose_frames_double(jdd.normalize_bank(images), *map(jnp.asarray, args)))


@pytest.mark.parametrize("case", sorted(CORNERS))
def test_compose_frames_cater_equal(case):
    compact = jcs.build_compact_cater(2, 3, 0, dataset="CATER-GEN-v2", context_length=38)
    norm = compact["bank"][..., :3].astype(np.float32) / 127.5 - 1.0
    bank = np.concatenate([norm, compact["bank"][..., 3:].astype(np.float32)], axis=-1)
    background = compact["background"].astype(np.float32) / 127.5 - 1.0
    v = compact["val"]
    sid, top, left = (v[k].reshape(-1, v[k].shape[-1]).copy() for k in ("sid", "top", "left"))
    if CORNERS[case] is not None:
        top[:5, 0] = [-3, 100, 130, 96, -128]
        left[:5, 1] = [120, -9, 97, -1, 200]
    got = tdd.compose_frames_cater(_t(bank), _t(background), _t(sid), _t(top), _t(left))
    assert got.shape == (sid.shape[0], 128, 128, 3)
    _equal(got, jdd.compose_frames_cater(jnp.asarray(bank), jnp.asarray(background),
                                         jnp.asarray(sid), jnp.asarray(top),
                                         jnp.asarray(left)))


def test_count_thresholds_equal():
    for seq in (8, 20, 21):
        np.testing.assert_array_equal(tdd._count_thresholds(seq), jdd._count_thresholds(seq))


@pytest.mark.parametrize("frames_length,seq_length", [(16, 20), (10, 20), (16, 21)])
def test_clip_indices_equal(frames_length, seq_length):
    """A dense sweep of speeds, batched in the port, one at a time in JAX;
    both equal the dataset's subsampling with repeat-last padding."""
    speeds = np.concatenate([np.linspace(0.0, 0.999, 400),
                             np.random.RandomState(0).rand(400)]).astype(np.float32)
    got = tdd.clip_indices(_t(speeds), frames_length, seq_length)
    want = jax.vmap(lambda s: jdd.clip_indices(s, frames_length, seq_length))(
        jnp.asarray(speeds))
    _equal(got, want)
    for s, row in zip(speeds[::37], got[::37].numpy()):
        ref = speed_subsample_indices(seq_length, [1.0, 2.0], float(s), 1.0)[:frames_length]
        np.testing.assert_array_equal(row, np.pad(ref, (0, frames_length - len(ref)),
                                                  mode="edge"))
    _equal(tdd.clip_indices(torch.tensor(0.3), frames_length, seq_length),
           jdd.clip_indices(jnp.float32(0.3), frames_length, seq_length))


def test_clip_indices_var_equal():
    rng = np.random.RandomState(0)
    lengths = rng.randint(6, 22, 500).astype(np.int32)
    speeds = rng.rand(500).astype(np.float32)
    got = tdd.clip_indices_var(_t(speeds), _t(lengths), 16)
    _equal(got, jax.vmap(lambda s, n: jdd.clip_indices_var(s, n, 16))(
        jnp.asarray(speeds), jnp.asarray(lengths)))
    _equal(tdd.clip_indices_var(torch.tensor(0.5), torch.tensor(21), 16),
           jdd.clip_indices_var(jnp.float32(0.5), jnp.int32(21), 16))
