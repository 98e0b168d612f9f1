"""The port's evals against the JAX package's: the metrics copy, I3D and FVD.

I3D: the port's random pytorch-i3d state dict (with BatchNorm statistics
made non-trivial) goes into JAX through JAX's own ``import_i3d_torch``, and
both networks embed the same clip (N=2, T=16, 32 px), f32 on the CPU,
within 1e-4 relative at both endpoints the e2e chains can use. The carrier's
``export_i3d`` must be the inverse of that importer. FVD: the same features
through both packages' ``compute_fvd`` and ``fvd_same_split_floor`` agree to
1e-10.
"""

import numpy as np
import pytest
import torch

from mage_tpu_torch.compat import from_jax
from mage_tpu_torch.evals import fvd, i3d, metrics


def _clip(seed, n=2, t=16, size=32):
    return np.random.RandomState(seed).rand(n, t, size, size, 3).astype(np.float32) * 2 - 1


def _state_dict(seed=3):
    """The port's random weights with every BatchNorm's affine and running
    statistics drawn too, so the comparison reaches them."""
    rng = np.random.RandomState(seed)
    sd = i3d.random_state_dict(seed)
    for key, value in sd.items():
        if key.endswith("bn.weight"):
            sd[key] = torch.from_numpy(rng.uniform(0.5, 1.5, value.shape).astype(np.float32))
        elif key.endswith(("bn.bias", "bn.running_mean")):
            sd[key] = torch.from_numpy(rng.uniform(-0.2, 0.2, value.shape).astype(np.float32))
        elif key.endswith("bn.running_var"):
            sd[key] = torch.from_numpy(rng.uniform(0.5, 2.0, value.shape).astype(np.float32))
    return sd


@pytest.mark.parametrize("endpoint", ["Mixed_3c", "logits"])
def test_i3d_features_match_jax(endpoint):
    import jax
    import jax.numpy as jnp

    from mage_tpu.evals.i3d import I3D as JaxI3D, import_i3d_torch

    sd = _state_dict()
    x = _clip(1)
    want = np.asarray(jax.jit(lambda v, a: JaxI3D(endpoint=endpoint).apply(v, a))(
        import_i3d_torch(sd), jnp.asarray(x)))
    model = i3d.I3D(endpoint=endpoint)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 480 if endpoint == "Mixed_3c" else 400)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert np.abs(want[0] - want[1]).max() > 1e-3 * np.abs(want).max()  # not collapsed


def test_export_i3d_is_the_inverse_of_the_jax_importer():
    import jax

    from mage_tpu.evals.i3d import import_i3d_torch

    sd = {k: v.numpy() for k, v in _state_dict(4).items()}
    variables = jax.tree_util.tree_map(np.asarray, import_i3d_torch(sd))
    exported = from_jax.export_i3d(variables)
    # JAX variables -> pytorch-i3d keys -> JAX variables: the same arrays
    back = import_i3d_torch(exported)
    flat = jax.tree_util.tree_leaves_with_path(variables)
    flat_back = dict((jax.tree_util.keystr(k), v)
                     for k, v in jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back) > 0
    for k, v in flat:
        np.testing.assert_array_equal(np.asarray(flat_back[jax.tree_util.keystr(k)]), v)
    # and the exported dict is the state dict it came from, key for key
    assert set(exported) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(exported[k], v)
    model = from_jax.load(i3d.I3D(), exported)  # strict
    assert set(model.state_dict()) == set(exported)


def test_metrics_copy_equals_jax():
    from mage_tpu.evals import metrics as jax_metrics

    rng = np.random.RandomState(0)
    a, b = rng.rand(4, 8, 8, 3), rng.rand(4, 8, 8, 3)
    assert metrics.psnr(a, b) == jax_metrics.psnr(a, b)
    assert metrics.ssim(a, b, 1.0) == jax_metrics.ssim(a, b, 1.0)
    feats = rng.randn(10, 6)
    for mine, theirs in zip(metrics.gaussian_stats(feats), jax_metrics.gaussian_stats(feats)):
        np.testing.assert_array_equal(mine, theirs)
    stats = metrics.gaussian_stats(feats) + metrics.gaussian_stats(feats[::-1] * 1.5)
    assert metrics.frechet_distance(*stats) == jax_metrics.frechet_distance(*stats)


def test_fvd_and_floor_match_jax_on_the_same_features():
    from mage_tpu.evals import fvd as jax_fvd

    proj = np.random.RandomState(5).randn(4 * 8 * 8 * 3, 12)

    def extractor(videos):  # a fixed random projection of the pixels
        return np.asarray(videos, np.float64).reshape(len(videos), -1) @ proj

    rng = np.random.RandomState(6)
    real = rng.rand(16, 4, 8, 8, 3).astype(np.float32)
    gen = (rng.rand(16, 4, 8, 8, 3) * 0.8 + 0.1).astype(np.float32)
    got = fvd.compute_fvd(real, gen, extractor, batch_size=5)
    want = jax_fvd.compute_fvd(real, gen, extractor, batch_size=5)
    assert got == pytest.approx(want, rel=1e-10, abs=1e-10)
    floor = fvd.fvd_same_split_floor(real, extractor, batch_size=3)
    assert floor == pytest.approx(jax_fvd.fvd_same_split_floor(real, extractor, batch_size=3),
                                  rel=1e-10, abs=1e-10)
    assert floor > 0 and got > 0
    # full-rank covariances (16 clips, 12 dims): the first root, no flag
    assert fvd.compute_fvd(real, gen, extractor, batch_size=5,
                           return_regularized=True) == (got, False)
    assert fvd.fvd_same_split_floor(real, extractor, batch_size=3,
                                    return_regularized=True) == (floor, False)


def test_resolve_extractor_branches(tmp_path):
    ex, prov, dim = fvd.resolve_extractor("MovingMNIST", batch_size=2, device="cpu")
    assert dim == 480 and "seed 42" in prov and "Mixed_3c" in prov
    x = _clip(2, n=3, t=8)
    feats = ex(x)
    assert feats.shape == (3, 480) and feats.dtype == np.float32
    # uint8 clips map to [-1, 1] as the JAX extractor maps them
    u8 = np.round((x + 1) * 127.5).astype(np.uint8)
    np.testing.assert_allclose(ex(u8), ex(u8.astype(np.float32) / 127.5 - 1.0), rtol=0, atol=0)
    # a named checkpoint loads strictly at the logits endpoint
    path = tmp_path / "rgb_test.pt"
    torch.save(i3d.random_state_dict(7, num_classes=10), path)
    ex, prov, dim = fvd.resolve_extractor(batch_size=2, i3d_checkpoint=str(path),
                                          device="cpu")
    assert dim == 10 and "rgb_test.pt" in prov and ex(x).shape == (3, 10)
    with pytest.raises(FileNotFoundError):
        fvd.resolve_extractor(i3d_checkpoint=str(tmp_path / "missing.pt"), device="cpu")
    # a named extractor directory without its provenance refuses to fall back
    with pytest.raises(FileNotFoundError, match="refusing to fall back"):
        fvd.resolve_extractor("CATER-GEN-v2", extractor_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="unknown I3D endpoint"):
        i3d.I3D(endpoint="Mixed_5c")


def test_frechet_distance_regularises_a_non_finite_root(monkeypatch):
    """Where scipy returns a non-finite square root (a singular covariance
    product, fewer clips than feature dims), the distance is taken with
    1e-6 I added to both covariances."""
    from scipy import linalg

    rng = np.random.RandomState(3)
    a, b = rng.randn(4, 8), rng.randn(4, 8) + 0.5  # rank-3 covariances of 8 dims
    (mu1, s1), (mu2, s2) = metrics.gaussian_stats(a), metrics.gaussian_stats(b)
    eye = np.eye(8) * 1e-6
    root = linalg.sqrtm((s1 + eye) @ (s2 + eye)).real
    want = float((mu1 - mu2) @ (mu1 - mu2) + np.trace(s1 + s2 - 2.0 * root))
    real_sqrtm, calls = linalg.sqrtm, []

    def nan_once(m):
        calls.append(m)
        return np.full_like(m, np.nan) if len(calls) == 1 else real_sqrtm(m)

    monkeypatch.setattr(linalg, "sqrtm", nan_once)
    assert metrics.frechet_distance(mu1, s1, mu2, s2) == pytest.approx(want, rel=1e-12)
    assert len(calls) == 2
    # the flag: set where the second root was taken, clear where the first did
    calls.clear()
    dist, regularized = metrics.frechet_distance(mu1, s1, mu2, s2, return_regularized=True)
    assert dist == pytest.approx(want, rel=1e-12) and regularized is True
    dist, regularized = metrics.frechet_distance(mu1, s1, mu2, s2, return_regularized=True)
    assert regularized is False and len(calls) == 3
