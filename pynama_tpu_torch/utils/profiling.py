"""Profiling helpers: torch.profiler device traces + per-phase wall timers.

The reference's observability is a datetime Timer plus commented-out
line_profiler hooks (SURVEY §5). Here: a torch.profiler session with CPU
and CUDA activity written as a Chrome trace (viewable in Perfetto or
chrome://tracing), the counterpart of the JAX package's jax.profiler
trace, and phase timers around regions that end in a synchronization.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger("pynama_tpu_torch.profiling")

#: the file device_trace writes inside its log_dir
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed block (CPU activity, and CUDA activity when a
    card is present) and write a Chrome trace to `log_dir`/trace.json."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        logger.info("device trace written to %s", path)


class PhaseTimer:
    """Accumulating named phase timers (blocking: call around complete
    regions that end in a synchronization, e.g. torch.cuda.synchronize)."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"{name:30s} {self.totals[name]*1e3:10.2f} ms "
                         f"x{self.counts[name]}")
        return "\n".join(lines)
