"""Per-iteration wall-clock timing with a moving-window ETA estimate (the
port's copy of ``mage_tpu/utils/timer.py``). It reads the host clock: time
GPU work with it only after a ``torch.cuda.synchronize``."""

from __future__ import annotations

import time
from typing import Optional


class Timer:
    def __init__(
        self,
        start_from: int = 1,
        total_iterations: Optional[int] = None,
        window_size: int = 20,
    ):
        self.current_iter = start_from - 1
        self.total_iters = total_iterations
        self._window_size = window_size
        self._times: list[float] = []
        self._start_time = time.time()

    def tic(self) -> None:
        self._start_time = time.time()

    def toc(self) -> float:
        dt = time.time() - self._start_time
        self._times.append(dt)
        if len(self._times) > self._window_size:
            self._times.pop(0)
        self.current_iter += 1
        return dt

    @property
    def last(self) -> float:
        return self._times[-1] if self._times else 0.0

    @property
    def avg(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    @property
    def eta_sec(self) -> float:
        if not self.total_iters or not self._times:
            return 0.0
        return self.avg * (self.total_iters - self.current_iter)

    @property
    def eta_hhmm(self) -> str:
        if not self.total_iters:
            return "N/A"
        eta = int(self.eta_sec)
        return f"{eta // 3600}h {(eta % 3600) // 60:02d}m"

    @property
    def stats(self) -> str:
        return (
            f"Iter {self.current_iter} | Time: {self.last:.3f} sec | "
            f"ETA: {self.eta_hhmm}"
        )
