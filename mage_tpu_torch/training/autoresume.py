"""Mid-stage resume: the whole loop state under one ``last`` checkpoint.

The port's counterpart of ``mage_tpu/training/autoresume.py``: ``save_last``
stores the epoch just finished, the best loss so far and a state dict
(model and optimizer state dicts, the PID state, ...) after an epoch;
``try_restore_last`` loads it at start-up, so a relaunch after a crash loses
at most one save interval.
"""

from __future__ import annotations

import pickle
from typing import Any, Optional, Tuple

from .checkpoint import Checkpointer

TAG = "last"


def save_last(ckpt: Checkpointer, epoch: int, best: float, state: dict) -> None:
    """Persist loop state after ``epoch`` finished."""
    ckpt.save(TAG, {"epoch": int(epoch), "best": float(best), "state": state})


def try_restore_last(ckpt: Checkpointer, map_location=None
                     ) -> Optional[Tuple[int, float, Any]]:
    """``(next_epoch, best, state)`` from a ``save_last`` checkpoint, or
    ``None`` (a fresh start) when there is none or it cannot be read: a
    write cut by a crash must not wedge the relaunch."""
    if not ckpt.exists(TAG):
        return None
    try:
        r = ckpt.restore(TAG, map_location)
    except (OSError, RuntimeError, EOFError, pickle.UnpicklingError) as e:
        print(f"autoresume: ignoring unreadable {ckpt.path(TAG)}: {e}")
        return None
    if not isinstance(r, dict) or not {"epoch", "best", "state"} <= r.keys():
        print(f"autoresume: ignoring malformed {ckpt.path(TAG)}")
        return None
    return int(r["epoch"]) + 1, float(r["best"]), r["state"]
