"""Step timing of the port (counterpart of ``rainbow_iqn_apex_tpu/utils/
profiling.py`` ``StepTimer``).  Laps are host wall time between calls: the
learn loop never waits for the device here, so a lap measures the loop,
whose floor is the device step once the write-back ring is full."""

from __future__ import annotations

import time
from typing import Dict, Optional


class StepTimer:
    """``timer.lap()`` each step, then ``timer.stats()``."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self._laps = []
        self._units = 0  # SGD steps covered by the recorded laps
        self._count = 0
        self._last: Optional[float] = None

    def lap(self, units: int = 1) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._count += 1
            if self._count > self.warmup:
                self._laps.append(dt)
                self._units += max(int(units), 1)
        self._last = now
        return dt

    def stats(self) -> Dict[str, float]:
        if not self._laps:
            return {"steps": 0}
        laps = sorted(self._laps)
        n = len(laps)
        return {
            "steps": self._units,
            "mean_s": sum(laps) / n,
            "p50_s": laps[n // 2],
            "p90_s": laps[min(int(n * 0.9), n - 1)],
            "p99_s": laps[min(int(n * 0.99), n - 1)],
            "steps_per_sec": self._units / sum(laps),
        }
