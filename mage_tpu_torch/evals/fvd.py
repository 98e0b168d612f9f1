"""FVD (Frechet Video Distance).

Port of ``mage_tpu/evals/fvd.py``: batched feature extraction, Gaussian
statistics and the Frechet distance (numpy, as there), the split-half
floor of the real set, and ``resolve_extractor``. The extractor is any
callable (N, T, H, W, 3) uint8/float -> (N, D) features:

    fvd = compute_fvd(real_videos, gen_videos, extractor=my_i3d_fn)

``resolve_extractor`` takes as arguments what the JAX package reads from its
environment (``MAGE_I3D_TORCH`` -> ``i3d_checkpoint``,
``MAGE_FVD_EXTRACTOR`` -> ``extractor_dir``).
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Optional

import numpy as np

from mage_tpu_torch.evals.metrics import frechet_distance, gaussian_stats

RANDOM_INIT_SEED = 42


def extract_features(
    videos: Iterable[np.ndarray],
    extractor: Callable[[np.ndarray], np.ndarray],
    batch_size: int = 16,
) -> np.ndarray:
    videos = np.asarray(videos)
    feats = []
    for start in range(0, len(videos), batch_size):
        feats.append(np.asarray(extractor(videos[start : start + batch_size])))
    return np.concatenate(feats, axis=0)


def compute_fvd(
    real_videos: np.ndarray,
    gen_videos: np.ndarray,
    extractor: Callable[[np.ndarray], np.ndarray],
    batch_size: int = 16,
    *,
    return_regularized: bool = False,
):
    """FVD of ``gen_videos`` against ``real_videos``; with
    ``return_regularized``, (fvd, whether ``frechet_distance`` regularised
    its root)."""
    real = extract_features(real_videos, extractor, batch_size)
    gen = extract_features(gen_videos, extractor, batch_size)
    return frechet_distance(*gaussian_stats(real), *gaussian_stats(gen),
                            return_regularized=return_regularized)


def fvd_same_split_floor(
    real_videos: np.ndarray,
    extractor: Callable[[np.ndarray], np.ndarray],
    batch_size: int = 16,
    seed: int = 0,
    *,
    return_regularized: bool = False,
):
    """Split-half FVD of the real set against itself: the sampling-noise
    floor of the metric at this sample count and extractor. With a
    random-init extractor the absolute scale is arbitrary, so every FVD is
    read against this floor (an FVD within 1-2x of it is indistinguishable
    from real). ``return_regularized`` as in ``compute_fvd``."""
    videos = np.asarray(real_videos)
    idx = np.random.RandomState(seed).permutation(len(videos))
    half = len(videos) // 2
    a = extract_features(videos[idx[:half]], extractor, batch_size)
    b = extract_features(videos[idx[half : 2 * half]], extractor, batch_size)
    return frechet_distance(*gaussian_stats(a), *gaussian_stats(b),
                            return_regularized=return_regularized)


DEFAULT_EXTRACTOR_DIRS = ("runs/fvd_extractor", "runs/fvd_extractor_mnist")


def resolve_extractor(dataset: Optional[str] = None, batch_size: int = 8, *,
                      i3d_checkpoint: Optional[str] = None,
                      extractor_dir: Optional[str] = None, device=None):
    """The FVD feature extractor -> ``(extract_fn, provenance, feature_dim)``,
    in JAX's order of preference:

    1. ``i3d_checkpoint``: a pytorch-i3d Kinetics checkpoint, loaded
       strictly, logits endpoint (400-d); a named file that is missing
       raises;
    2. an action-trained trunk from ``cli.train_fvd_extractor``
       (``i3d.load_trained_extractor``, Mixed_4f, 832-d) whose
       ``provenance.json`` names the family of ``dataset`` (CATER v1 and v2
       are one family): ``extractor_dir`` if given, which must fit (no
       ``provenance.json``, or no ``dataset`` from the caller, raises
       ``FileNotFoundError``; another family raises ``ValueError``), else
       each of ``DEFAULT_EXTRACTOR_DIRS`` (relative to the working
       directory), skipped when it does not fit;
    3. the random-init fallback: I3D weights drawn from a
       ``torch.Generator`` seeded 42, Mixed_3c endpoint (480-d). Its
       features are not the JAX package's (another generator), so FVDs of
       the two packages are comparable only through their floors.

    The provenance string goes beside every FVD."""
    import json

    from mage_tpu_torch.evals import i3d

    if i3d_checkpoint:
        if not os.path.exists(i3d_checkpoint):
            raise FileNotFoundError(f"i3d_checkpoint {i3d_checkpoint!r} does not exist")
        import torch

        state = torch.load(i3d_checkpoint, map_location="cpu", weights_only=True)
        return (i3d.make_extractor(state, batch_size, "logits", device),
                f"pytorch-i3d {os.path.basename(i3d_checkpoint)} (Kinetics), "
                f"endpoint logits", len(state["logits.conv3d.bias"]))

    for path in [extractor_dir] if extractor_dir else DEFAULT_EXTRACTOR_DIRS:
        prov_path = os.path.join(path, "provenance.json")
        if not (os.path.exists(prov_path) and dataset is not None):
            if extractor_dir:  # an explicit request fails loudly, never falls back
                raise FileNotFoundError(
                    f"extractor_dir={extractor_dir!r}: provenance.json missing (or "
                    f"dataset=None at the call site); refusing to fall back to the "
                    f"random-init extractor the caller asked to avoid")
            continue
        with open(prov_path) as fp:
            trained_on = json.load(fp).get("dataset", "")
        # v1 and v2 share the visual world: an extractor trained on either
        # CATER family member transfers to the other
        if trained_on.split("-")[0] != str(dataset).split("-")[0]:
            if extractor_dir:
                raise ValueError(
                    f"extractor_dir={extractor_dir!r}: trained on {trained_on!r} but the "
                    f"eval dataset is {dataset!r}; refusing the family mismatch")
            continue
        try:
            return i3d.load_trained_extractor(path, batch_size, device)
        except FileNotFoundError:
            if extractor_dir:
                raise
            continue

    return (i3d.random_extractor(batch_size, RANDOM_INIT_SEED, device),
            f"random-init torch.Generator seed {RANDOM_INIT_SEED}, endpoint Mixed_3c "
            f"(not the JAX package's random weights; deep random features "
            f"mean-field-collapse, shallow random projections discriminate)",
            i3d.FEATURE_DIMS["Mixed_3c"])
