"""Checkpoints of training state as ``torch.save`` files.

The port's counterpart of ``mage_tpu/training/checkpoint.py`` (orbax there):
the same names and methods over one file per checkpoint, written to a
temporary file and renamed into place, so a concurrent reader never sees a
truncated checkpoint. The trainer saves ``{"step", "model", "optimizer"}``.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

_TMP = ".tmp"


class Checkpointer:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, name: str, tree: Any) -> str:
        """Atomic save of ``tree`` (tensors, state dicts, Python scalars)."""
        final = self.path(name)
        tmp = final + _TMP
        torch.save(tree, tmp)
        os.replace(tmp, final)
        return final

    def restore(self, name_or_path: str, map_location=None) -> Any:
        """Load a checkpoint by name, or by an absolute path; tensors go to
        ``map_location`` (as saved when None)."""
        p = name_or_path if os.path.isabs(name_or_path) else self.path(name_or_path)
        return torch.load(p, map_location=map_location, weights_only=True)

    def exists(self, name: str) -> bool:
        return os.path.isfile(self.path(name))

    def latest(self, prefix: str) -> Optional[str]:
        """Name of the checkpoint starting with ``prefix`` whose digits after
        the prefix make the largest number."""
        if not os.path.isdir(self.directory):
            return None
        cands = [
            d
            for d in os.listdir(self.directory)
            if d.startswith(prefix) and not d.endswith(_TMP) and os.path.isfile(self.path(d))
        ]
        if not cands:
            return None

        def step_of(name: str) -> int:
            digits = "".join(ch for ch in name[len(prefix):] if ch.isdigit())
            return int(digits) if digits else -1

        return max(cands, key=step_of)
