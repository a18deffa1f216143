"""Wall-clock timing (reference `src/common/timer.py:3-19`)."""
from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self._t0 = None
        self._elapsed = 0.0

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        """Seconds since tic(); also stored for getTime."""
        if self._t0 is None:
            raise RuntimeError("toc() before tic()")
        self._elapsed = time.perf_counter() - self._t0
        return self._elapsed

    # reference spelling
    def getTime(self) -> float:
        return self._elapsed

    def __str__(self):
        return f"{self._elapsed:.6f}s"
