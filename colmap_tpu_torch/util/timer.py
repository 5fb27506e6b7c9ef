"""Timers, stage logging, and device profiling.

Port of colmap_tpu/util/timer.py (reference: src/colmap/util/timer.h:36,
util/misc.h:45). `Timer`, `StageTimings` and the headings are the JAX
package's; `trace()` captures a stage with torch.profiler (CPU and CUDA
activities) and writes a Chrome trace, where the JAX package starts the
JAX profiler.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger("colmap_tpu_torch")


class Timer:
    def __init__(self, start: bool = False):
        self._start: Optional[float] = None
        self._pause_at: Optional[float] = None
        self._accum = 0.0
        if start:
            self.start()

    def start(self):
        self._start = time.perf_counter()
        self._pause_at = None

    def pause(self):
        if self._start is not None and self._pause_at is None:
            self._pause_at = time.perf_counter()
            self._accum += self._pause_at - self._start
            self._start = None

    def resume(self):
        if self._start is None:
            self.start()

    def restart(self):
        self._accum = 0.0
        self.start()

    def elapsed_seconds(self) -> float:
        cur = 0.0
        if self._start is not None:
            cur = time.perf_counter() - self._start
        return self._accum + cur

    def elapsed_minutes(self) -> float:
        return self.elapsed_seconds() / 60.0

    def print_seconds(self, label: str = "Elapsed time"):
        logger.info("%s: %.3f [seconds]", label, self.elapsed_seconds())

    def print_minutes(self, label: str = "Elapsed time"):
        logger.info("%s: %.3f [minutes]", label, self.elapsed_minutes())


def print_heading1(text: str):
    logger.info("=" * 78)
    logger.info(text)
    logger.info("=" * 78)


def print_heading2(text: str):
    logger.info("-" * len(text))
    logger.info(text)
    logger.info("-" * len(text))


class StageTimings:
    """Accumulated per-stage wall times (the pipeline's timing struct)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            lines.append(f"  {name}: {self.totals[name]:.3f}s "
                         f"({self.counts[name]}x)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler capture around a pipeline stage: CPU ops, and CUDA
    kernels when a card is present, written to `log_dir/trace.json`
    (Chrome trace format; open it in Perfetto or chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
