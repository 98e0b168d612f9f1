"""Per-epoch learning-rate schedules (the port's copy of
``mage_tpu/training/lr.py``): cosine over the total epochs, or milestone
decay by ``lr_gamma`` at each epoch in ``lr_steps``."""

from __future__ import annotations

import math
from typing import Sequence


def epoch_lr(
    base_lr: float,
    epoch: int,
    total_epochs: int,
    cos: bool = True,
    lr_steps: Sequence[int] = (),
    lr_gamma: float = 0.1,
) -> float:
    lr = base_lr
    if cos:
        lr *= 0.5 * (1.0 + math.cos(math.pi * epoch / total_epochs))
    else:
        for milestone in lr_steps:
            lr *= lr_gamma if epoch >= milestone else 1.0
    return lr
