"""Video quality metrics: PSNR, a global SSIM, and the Frechet distance
between Gaussians with the statistics it takes.

A copy of ``mage_tpu/evals/metrics.py`` (numpy and scipy only), with two
changes to ``frechet_distance`` that leave its value alone wherever the JAX
package's is finite: ``sqrtm`` is called without its deprecated ``disp``,
and a non-finite root (a singular covariance product, which some scipy
versions return as nan) is taken again with 1e-6 I added to both
covariances, and the trace is taken of those too. ``return_regularized=True`` also returns whether that second
root was taken, so that a caller can mark a distance the JAX package would
not have given. The port keeps its own copy so that it imports nothing of the
JAX package.
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 2.0) -> float:
    """Peak signal-to-noise ratio; default range 2.0 for [-1, 1] videos."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(20 * np.log10(data_range) - 10 * np.log10(mse))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 2.0) -> float:
    """Global (non-windowed) SSIM over each frame, averaged — a lightweight
    structural-similarity indicator for regression tracking."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = a.mean(), b.mean()
    var_a, var_b = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(
        ((2 * mu_a * mu_b + c1) * (2 * cov + c2))
        / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    )


def frechet_distance(mu1, sigma1, mu2, sigma2, *, return_regularized: bool = False):
    """Frechet distance between two Gaussians (the FVD/FID core), and with
    ``return_regularized`` whether its root needed the 1e-6 I below.

    FVD additionally needs an I3D video-feature network; plug its features
    into :func:`gaussian_stats` + this function. No pretrained I3D ships in
    offline environments, so FVD runs are gated on a user-provided feature
    extractor (see ``mage_tpu_torch.evals.fvd``)."""
    from scipy import linalg

    diff = np.atleast_1d(mu1 - mu2)
    sigma1 = np.atleast_2d(sigma1)
    sigma2 = np.atleast_2d(sigma2)
    # without ``disp``: scipy 1.17 deprecates it and later versions take no
    # such argument; the square root is the same array either way
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    regularized = not np.isfinite(covmean).all()
    if regularized:
        # a singular product (fewer clips than feature dims), where some
        # scipy versions return nan: both covariances are regularised by
        # 1e-6 I, and the trace below is taken of the same regularised
        # covariances, so the value is the exact Frechet distance of the
        # regularised Gaussians (pytorch-fid regularises the root alone,
        # which biases a small distance by -2e-6 per null direction)
        offset = np.eye(sigma1.shape[0]) * 1e-6
        sigma1, sigma2 = sigma1 + offset, sigma2 + offset
        covmean = linalg.sqrtm(sigma1 @ sigma2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    dist = float(diff @ diff + np.trace(sigma1 + sigma2 - 2.0 * covmean))
    return (dist, regularized) if return_regularized else dist


def gaussian_stats(features: np.ndarray):
    """(N, D) features -> (mu, sigma).

    Robust to degenerate sample counts: np.cov squeezes to 0-d when N == 1
    or D == 1 (and is nan at N == 1, where the unbiased estimator divides
    by zero). A single observation has zero scatter, so sigma is the (D, D)
    zero matrix there; values for every N >= 2, D >= 2 call are unchanged.
    """
    features = np.atleast_2d(np.asarray(features, np.float64))
    mu = features.mean(axis=0)
    if features.shape[0] < 2:
        sigma = np.zeros((features.shape[1], features.shape[1]))
    else:
        sigma = np.atleast_2d(np.cov(features, rowvar=False))
    return mu, sigma
