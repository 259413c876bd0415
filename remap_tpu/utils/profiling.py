"""Throughput counters + device tracing hooks.

The reference's only observability is a wall-clock fps counter printed
every N callback invocations (main.cpp:54-110); :class:`PerfCounter`
provides the same step/total-average readout.  ``device_trace`` wraps
``jax.profiler`` for device traces.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional


class PerfCounter:
    """Step/total fps sampling (main.cpp:54-110 semantics)."""

    def __init__(self, name: str, sample_size: int = 100):
        self.name = name
        self.sample_size = sample_size
        self.total = 0
        self.sample = 0
        self.begin: Optional[float] = None
        self.last: Optional[float] = None

    def count(self, n: int = 1) -> None:
        if self.begin is None:
            self.begin = self.last = time.perf_counter()
        self.total += n
        self.sample += n
        if self.sample >= self.sample_size:
            self.report()

    def report(self) -> None:
        if self.begin is None or self.total == 0:
            return
        now = time.perf_counter()
        step_dt = max(now - (self.last or now), 1e-9)
        total_dt = max(now - self.begin, 1e-9)
        print(
            f"[{self.name} # {self.total:5d}] "
            f"step avg: {self.sample / step_dt:7.1f} fps; "
            f"total avg: {self.total / total_dt:7.1f} fps; "
            f"total: {total_dt:6.1f} s"
        )
        self.sample = 0
        self.last = now


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace around a block (view with tensorboard/xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
