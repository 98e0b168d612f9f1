"""Training observability: TensorBoard when ``tensorboardX`` is installed,
and an always-on JSONL sink (``metrics.jsonl``).

The port's copy of ``mage_tpu/utils/metrics.py``: scalars per iteration
under the reference's ``train/``/``val/`` tag names, image grids, text.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping

import numpy as np

try:  # tensorboardX is optional; JSONL is the always-available sink.
    from tensorboardX import SummaryWriter as _TBWriter
except ImportError:  # pragma: no cover
    _TBWriter = None


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard and _TBWriter is not None:
            try:
                self._tb = _TBWriter(log_dir=log_dir)
            except OSError:
                self._tb = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(
            json.dumps({"t": time.time(), "step": step, tag: float(value)}) + "\n"
        )
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def add_scalars(self, prefix: str, values: Mapping[str, float], step: int) -> None:
        rec = {"t": time.time(), "step": step}
        for k, v in values.items():
            rec[f"{prefix}{k}"] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(f"{prefix}{k}", float(v), step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def add_text(self, tag: str, text: str, step: int = 0) -> None:
        if self._tb is not None:
            self._tb.add_text(tag, text, step)

    def add_image_grid(
        self,
        tag: str,
        images: np.ndarray,
        step: int,
        nrow: int = 8,
        value_range: tuple[float, float] = (-1.0, 1.0),
    ) -> np.ndarray:
        """``images``: (N, H, W, C) float array; normalized into [0, 1] and
        tiled into a grid (parity with make_grid at train_vqvae.py:156).
        Returns the grid (H', W', C) uint8 and logs it to TB if available."""
        grid = make_grid(images, nrow=nrow, value_range=value_range)
        if self._tb is not None:
            self._tb.add_image(tag, grid.transpose(2, 0, 1), step)
        path = os.path.join(self.log_dir, f"{tag.replace('/', '_')}_{step}.png")
        try:
            from PIL import Image

            Image.fromarray(grid).save(path)
        except (ImportError, OSError):
            pass
        return grid

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def make_grid(
    images: np.ndarray,
    nrow: int = 8,
    pad: int = 2,
    value_range: tuple[float, float] = (-1.0, 1.0),
) -> np.ndarray:
    """Tile (N, H, W, C) into one uint8 image grid."""
    images = np.asarray(images, dtype=np.float32)
    lo, hi = value_range
    images = np.clip((images - lo) / max(hi - lo, 1e-8), 0.0, 1.0)
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c), np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y : y + h, x : x + w] = images[i]
    if c == 1:
        grid = np.repeat(grid, 3, axis=-1)
    return (grid * 255).astype(np.uint8)


class NullWriter:
    """A ``MetricsWriter`` that writes nothing (the ranks of a process group
    other than rank 0)."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None
