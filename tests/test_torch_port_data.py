"""The port's data package against the JAX package's, on the CPU.

Same seeds in, same bytes and arrays out: the MNIST generators' ``.mrs``
record stores byte for byte, the synthetic-CATER builders and disk chain,
the tokenizers, the clip transforms under one ``random.Random`` seed, the
datasets' items, and the loader's order, shards and batches (the port's
collated tensors against JAX's numpy arrays). Everything is compared
exactly: the port's data modules are copies and make the same RNG calls.
"""

import json
import random
import threading

import numpy as np
import pytest
import torch

from mage_tpu.data import datasets as jds
from mage_tpu.data import loader as jloader
from mage_tpu.data import tokenizers as jtok
from mage_tpu.data import transforms as jT
from mage_tpu.data.generators import cater_synthetic as jcs
from mage_tpu.data.generators import cater_text_anno as janno
from mage_tpu.data.generators import cater_vqvae_store as jstore
from mage_tpu.data.generators import mnist_double as jdouble
from mage_tpu.data.generators import mnist_double_modified as jmod
from mage_tpu.data.generators import mnist_single as jsingle
from mage_tpu_torch.data import datasets as tds
from mage_tpu_torch.data import loader as tloader
from mage_tpu_torch.data import tokenizers as ttok
from mage_tpu_torch.data import transforms as tT
from mage_tpu_torch.data.generators import cater_synthetic as tcs
from mage_tpu_torch.data.generators import cater_text_anno as tanno
from mage_tpu_torch.data.generators import cater_vqvae_store as tstore
from mage_tpu_torch.data.generators import mnist_double as tdouble
from mage_tpu_torch.data.generators import mnist_double_modified as tmod
from mage_tpu_torch.data.generators import mnist_single as tsingle

GENERATORS = {"single": (jsingle, tsingle, "mnist_single_20f_10k_"),
              "double": (jdouble, tdouble, "mnist_double_20f_10k_"),
              "double_modified": (jmod, tmod, "mnist_double_modified_20f_24k_")}


def _generate(module, out, seed=3, num_train=12, num_val=6):
    module.main(["--out", str(out), "--num-train", str(num_train), "--num-val",
                 str(num_val), "--seed", str(seed)])


@pytest.fixture(scope="module")
def mnist_roots(tmp_path_factory):
    """Single Moving MNIST written once by each package (seed 3)."""
    roots = {}
    for side, module in (("jax", jsingle), ("port", tsingle)):
        out = tmp_path_factory.mktemp(f"mnist_{side}")
        _generate(module, out)
        roots[side] = str(out / "mnist_single_20f_10k_")
    return roots


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_mnist_generator_records_are_byte_identical(tmp_path, name):
    jmodule, tmodule, prefix = GENERATORS[name]
    _generate(jmodule, tmp_path / "jax", seed=5)
    _generate(tmodule, tmp_path / "port", seed=5)
    for split in ("train", "test"):
        jbytes = (tmp_path / "jax" / f"{prefix}{split}.mrs").read_bytes()
        tbytes = (tmp_path / "port" / f"{prefix}{split}.mrs").read_bytes()
        assert len(tbytes) > 0 and tbytes == jbytes


@pytest.mark.parametrize("dataset", ["CATER-GEN-v1", "CATER-GEN-v2"])
def test_build_compact_cater_equal(dataset):
    kw = dict(dataset=dataset, context_length=38)
    want = jcs.build_compact_cater(2, 3, 4, **kw)
    got = tcs.build_compact_cater(2, 3, 4, **kw)
    assert sorted(got) == sorted(want)
    for key in ("bank", "background"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["bank_index"] == want["bank_index"]
    for split in ("train", "val"):
        assert sorted(got[split]) == sorted(want[split])
        for key, value in want[split].items():
            if key == "meta":
                assert json.dumps(got[split][key]) == json.dumps(value)
            else:
                np.testing.assert_array_equal(got[split][key], value)


@pytest.mark.parametrize("vocab,mode,caption", [
    ("MNIST_VOCAB", "whitespace", "the digit 3 is moving up then down ."),
    ("CATERV1_VOCAB", "regex", "the cone is rotating and the snitch is sliding ."),
    ("CATERV2_VOCAB", "regex", "the small gold snitch is sliding to ( 1 , -2 ) ."),
])
def test_tokenizer_encodes_equal(vocab, mode, caption):
    jt = jtok.VocabTokenizer(getattr(jtok, vocab), mode)
    tt = ttok.VocabTokenizer(getattr(ttok, vocab), mode)
    np.testing.assert_array_equal(tt.encode(caption), jt.encode(caption))
    np.testing.assert_array_equal(tt.encode_padded(caption, 40), jt.encode_padded(caption, 40))
    assert tt.decode(tt.encode(caption)) == jt.decode(jt.encode(caption))
    assert ttok.word_tokenize(caption) == jtok.word_tokenize(caption)


TRANSFORMS = {
    "resize": lambda T: T.Resize(48),
    "center_crop": lambda T: T.CenterCrop(40),
    "random_crop": lambda T: T.RandomCrop(40),
    "random_resized_crop": lambda T: T.RandomResizedCrop(64, scale=(0.8, 1.0)),
    "flips": lambda T: T.Compose([T.RandomHorizontalFlip(), T.RandomVerticalFlip()]),
    "rotation": lambda T: T.RandomRotation(10.0),
    "color": lambda T: T.Compose([T.ColorJitter(0.4, 0.4, 0.4), T.RandomGrayscale(0.5)]),
    "blur_invert": lambda T: T.Compose([T.GaussianBlur(), T.ColorInversion()]),
    "mnist_stage1": lambda T: T.Compose([T.RandomResizedCrop(64, scale=(0.8, 1.0)),
                                         T.ToFloat(), T.Normalize([0.5], [1.0])]),
    "cater_stage2": lambda T: T.Compose([T.Resize(128), T.ToFloat(),
                                         T.Normalize([0.5], [0.5])]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
@pytest.mark.parametrize("channels", [1, 3])
def test_transforms_equal_under_one_seed(name, channels):
    clip = np.random.RandomState(0).randint(0, 256, (3, 64, 64, channels)).astype(np.uint8)
    # one Compose, which hands its rng to each stochastic transform
    jt, tt = (t if isinstance(t, T.Compose) else T.Compose([t])
              for T, t in ((jT, TRANSFORMS[name](jT)), (tT, TRANSFORMS[name](tT))))
    jr, tr = random.Random(7), random.Random(7)
    for _ in range(3):  # three draws: the RNG streams stay in step
        want, got = jt(clip, jr), tt(clip, tr)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert jr.random() == tr.random()


def _assert_items_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _assert_items_equal(got[key], want[key])
    elif isinstance(want, str):
        assert got == want
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_moving_mnist_items_equal(mnist_roots):
    for split in ("train", "test"):
        kw = dict(split=split, frames_length=10, sample_speed=[1.0, 2.0],
                  context_length=16, seed=2)
        jd = jds.MovingMnist(mnist_roots["jax"], **kw)
        td = tds.MovingMnist(mnist_roots["port"], **kw)
        assert len(td) == len(jd)
        for i in [0, 3, 1, 3, len(jd) - 1]:  # repeats: the speed stream moves on
            _assert_items_equal(td[i], jd[i])
        for crop in (None, "mnist_stage1"):
            jt = TRANSFORMS[crop](jT) if crop else None
            tt = TRANSFORMS[crop](tT) if crop else None
            j4 = jds.MovingMnist4VQVAE(mnist_roots["jax"], split, jt, seed=4)
            t4 = tds.MovingMnist4VQVAE(mnist_roots["port"], split, tt, seed=4)
            for i in [0, 2, 2, len(j4) - 1]:
                _assert_items_equal(t4[i], j4[i])


def test_speed_subsample_indices_equal():
    rng = np.random.RandomState(1)
    for _ in range(200):
        args = (int(rng.randint(4, 40)), [1.0, float(rng.choice([2.0, 4.0]))],
                float(rng.rand()), float(rng.choice([1.0, 3.0])))
        np.testing.assert_array_equal(tds.speed_subsample_indices(*args),
                                      jds.speed_subsample_indices(*args))


@pytest.fixture(scope="module")
def cater_roots(tmp_path_factory):
    """The synthetic-CATER disk chain (videos, scenes, captions, the
    stage-1 image store) written once by each package."""
    pytest.importorskip("cv2")
    roots = {}
    for side, cs, anno, store in (("jax", jcs, janno, jstore), ("port", tcs, tanno, tstore)):
        root = tmp_path_factory.mktemp(f"cater_{side}") / "CATER-SYN"
        cs.main(["--data-dir", str(root), "--num-videos", "5", "--seed", "0"])
        anno.main(["--data-dir", str(root), "--mode", "explicit",
                   "--dataset", "CATER-GEN-v2", "--max-videos", "5"])
        store.build_store(str(root), "train", "explicit", stride=8)
        roots[side] = root
    return roots


def test_cater_disk_chain_equal(cater_roots):
    jroot, troot = cater_roots["jax"], cater_roots["port"]
    names = sorted(p.relative_to(jroot) for p in jroot.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(troot) for p in troot.rglob("*") if p.is_file())
    for name in names:
        if name.suffix in (".json", ".mrs"):
            assert (troot / name).read_bytes() == (jroot / name).read_bytes(), name


def test_cater_items_equal(cater_roots):
    kw = dict(dataset="caterv2", split="train", frames_length=6,
              sample_speed=[1.0, 2.0], randomness=False, seed=3)
    jd = jds.CATER(data_root=str(cater_roots["jax"]), **kw)
    td = tds.CATER(data_root=str(cater_roots["port"]), **kw)
    assert len(td) == len(jd)
    for i in [0, 1, 1]:
        _assert_items_equal(td[i], jd[i])
    j4 = jds.CATER4VQVAE(str(cater_roots["jax"]), "train",
                         TRANSFORMS["cater_stage2"](jT), seed=1)
    t4 = tds.CATER4VQVAE(str(cater_roots["port"]), "train",
                         TRANSFORMS["cater_stage2"](tT), seed=1)
    assert len(t4) == len(j4)
    for i in [0, len(j4) - 1]:
        _assert_items_equal(t4[i], j4[i])


def _batches_equal(tl, jl):
    got, want = list(tl), list(jl)
    assert len(got) == len(want) == len(tl) == len(jl)
    for tb, jb in zip(got, want):
        if isinstance(jb, dict):
            assert sorted(tb) == sorted(jb)
            pairs = [(tb[k], jb[k]) for k in jb]
        else:
            pairs = [(tb, jb)]
        for t, j in pairs:
            if isinstance(j, list):
                assert t == j
            else:
                assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
                assert t.numpy().dtype == j.dtype
                np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("shuffle,drop_last,shards", [
    (True, True, 1), (True, False, 1), (False, False, 1), (True, False, 3), (True, True, 2)])
def test_loader_order_and_batches_equal(shuffle, drop_last, shards):
    items = [{"x": np.arange(3, dtype=np.float32) + i, "id": f"v{i}",
              "speed": np.float32(i / 10)} for i in range(23)]
    for index in range(shards):
        kw = dict(batch_size=4, shuffle=shuffle, seed=5, drop_last=drop_last,
                  num_shards=shards, shard_index=index)
        jl, tl = jloader.Loader(items, **kw), tloader.Loader(items, **kw)
        for epoch in (0, 1, 2):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            _batches_equal(tl, jl)


def test_loader_batches_of_a_dataset_equal(mnist_roots):
    kw = dict(split="train", frames_length=8, sample_speed=[1.0, 2.0],
              context_length=16, seed=0)
    jd = jds.MovingMnist(mnist_roots["jax"], **kw)
    td = tds.MovingMnist(mnist_roots["port"], **kw)
    jl = jloader.Loader(jd, 4, shuffle=True, seed=1, drop_last=True)
    tl = tloader.PrefetchLoader(tloader.Loader(td, 4, shuffle=True, seed=1, drop_last=True))
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        _batches_equal(tl, jl)
    batch = next(iter(tl))
    assert batch["speed"].dtype == torch.float32
    assert batch["images"].dtype == torch.float32 and batch["text"].dtype == torch.int32


class _Failing:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == 9:
            raise KeyError("item 9 is broken")
        return np.full((2,), i, np.int64)


def test_prefetch_loader_reraises_a_failing_item():
    loader = tloader.PrefetchLoader(tloader.Loader(_Failing(), 4, shuffle=False))
    seen = []
    with pytest.raises(KeyError, match="item 9 is broken"):
        for batch in loader:
            seen.append(batch)
    assert [b[:, 0].tolist() for b in seen] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    # a consumer that stops early leaves no worker behind
    before = threading.active_count()
    batches = iter(tloader.PrefetchLoader(tloader.Loader(list(range(100)), 2)))
    assert next(batches).shape == (2,)
    batches.close()
    assert threading.active_count() == before
