"""The Frechet distance's regularised root (ROADMAP C4).

Where ``sqrtm`` of a singular covariance product is non-finite (scipy 1.18
returns nan for fewer clips than feature dims), the port takes the distance
of the Gaussians regularised by 1e-6 I, root and trace alike. Before, only
the root was regularised, so a clip set against itself read about
-2e-6 per feature dimension (-1.66e-3 at 832). Where the first root is
finite the value is the JAX package's, bit for bit.
"""

import numpy as np
import pytest
from scipy import linalg

from mage_tpu.evals import metrics as jax_metrics
from mage_tpu_torch.evals import metrics


@pytest.fixture(autouse=True)
def one_blas_thread():
    """``sqrtm`` of an 832 x 832 product: one BLAS thread, so that test
    workers sharing the host do not oversubscribe it."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(1):
        yield


def _nan_first_root(monkeypatch):
    """``sqrtm`` returns nan on its first call (as scipy 1.18 does for a
    singular product) -> the list of (argument, root) of every call."""
    real_sqrtm, calls = linalg.sqrtm, []

    def nan_once(m):
        root = np.full_like(m, np.nan) if not calls else real_sqrtm(m)
        calls.append((m, root))
        return root

    monkeypatch.setattr(linalg, "sqrtm", nan_once)
    return calls


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_distance_of_a_clip_set_to_itself_is_zero_under_the_regularised_root(
        monkeypatch, seed):
    # 8 clips of 832-d features (Mixed_4f's width) at unit-order scale: the
    # regularised product's condition is about 2e12, and what is left is
    # sqrtm's own error on it
    feats = np.random.RandomState(seed).randn(8, 832) * 0.1
    mu, sigma = metrics.gaussian_stats(feats)
    calls = _nan_first_root(monkeypatch)
    dist, regularized = metrics.frechet_distance(mu, sigma, mu, sigma,
                                                 return_regularized=True)
    assert regularized and len(calls) == 2
    assert abs(dist) <= 1e-5, dist
    # the root alone regularised, as before, on the same root: the bias the
    # fix removes
    eye = np.eye(832) * 1e-6
    product, root = calls[1]
    np.testing.assert_array_equal(product, (sigma + eye) @ (sigma + eye))
    root_only = float(np.trace(2.0 * sigma - 2.0 * root.real))
    assert root_only == pytest.approx(-2e-6 * 832, rel=0.02)


@pytest.mark.parametrize("n", [64, 400])
def test_finite_root_distance_is_the_jax_packages_bit_for_bit(n):
    rng = np.random.RandomState(n)
    a, b = rng.randn(n, 32), rng.randn(n, 32) * 1.3 + 0.2
    (mu1, s1), (mu2, s2) = metrics.gaussian_stats(a), metrics.gaussian_stats(b)
    dist, regularized = metrics.frechet_distance(mu1, s1, mu2, s2,
                                                 return_regularized=True)
    assert not regularized
    assert dist == jax_metrics.frechet_distance(mu1, s1, mu2, s2)
