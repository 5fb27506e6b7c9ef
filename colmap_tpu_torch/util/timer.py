"""Timers, stage logging, the span recorder, and device profiling.

Port of colmap_tpu/util/timer.py (reference: src/colmap/util/timer.h:36,
util/misc.h:45). `Timer` and the headings are the JAX package's.

Spans: `span(name, **attrs)` times one piece of work in memory. A span's
parent is the innermost span open on its thread, and the outermost span
is a job, whose id every span inside it carries (threads started by
`parallel.mesh.run_shards` inherit the span that started them). The last
65,536 finished spans stay in a ring; `last_job(name)` returns the spans
of the last finished job of that name. Recording is always on; while a
torch.profiler records, each span also opens a profiler range of its
name, so the program's spans show in the trace on the device's clock.

What an operator reads: the seconds that an entry point returns from its
spans (`run_patch_match_stereo(timings=...)`), `StageTimings` (each stage
a span), and the Chrome trace that `trace(log_dir)` writes around any
call, with the spans in it as ranges.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger("colmap_tpu_torch")


# finished spans kept: one dense job records about 2,600
SPAN_RING = 65536


class Span:
    """One timed piece of work: `id`, `parent` (None for a job), `job`,
    `name`, `thread`, `start` and `end` (`time.perf_counter_ns()`) and
    `attrs`. Use it through `SpanRecorder.span`."""

    __slots__ = ("id", "parent", "job", "name", "thread", "start", "end",
                 "attrs", "_recorder", "_range")

    def __init__(self, recorder: "SpanRecorder", name: str, attrs: dict):
        self._recorder = recorder
        self.id = next(recorder._ids)
        self.name = name
        self.attrs = attrs
        self.parent = self.job = self.thread = None
        self.start = self.end = self._range = None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9

    def __enter__(self) -> "Span":
        stack = self._recorder._stack()
        if stack:
            self.parent, self.job = stack[-1].id, stack[-1].job
        else:
            self.job = self.id
        self.thread = threading.get_ident()
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self._recorder._stack().pop()
        self._recorder._ring.append(self)


class SpanRecorder:
    """Spans in memory: a stack of open spans per thread and a ring of the
    last `capacity` finished ones."""

    def __init__(self, capacity: int = SPAN_RING):
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._ring: collections.deque = collections.deque(maxlen=capacity)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def current(self) -> Optional[Span]:
        """The innermost span open on this thread."""
        stack = self._stack()
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def adopt(self, parent: Optional[Span]):
        """On another thread: the spans opened inside, where no span of
        this thread is open, take `parent` as theirs and its job."""
        if parent is None:
            yield
            return
        stack = self._stack()
        stack.append(parent)
        try:
            yield
        finally:
            stack.pop()

    def spans(self) -> List[Span]:
        """The finished spans in the ring, oldest first."""
        return list(self._ring)

    def job_spans(self, job: int) -> List[Span]:
        """The finished spans of job `job`, in the order they ended."""
        return [s for s in self.spans() if s.job == job]

    def last_job(self, name: str) -> List[Span]:
        """The spans of the last finished job named `name` (its root
        last), or [] when the ring holds none."""
        ring = self.spans()
        for s in reversed(ring):
            if s.parent is None and s.name == name:
                return [r for r in ring if r.job == s.id]
        return []


# the process's recorder, which every span of the port goes to
RECORDER = SpanRecorder()
span = RECORDER.span
current_span = RECORDER.current
adopt = RECORDER.adopt
job_spans = RECORDER.job_spans
last_job = RECORDER.last_job


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
    """Accumulated per-stage wall times (the pipeline's timing struct);
    each stage is a span."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        s = span(name)
        try:
            with s:
                yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + s.seconds
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            lines.append(f"  {name}: {self.totals[name]:.3f}s "
                         f"({self.counts[name]}x)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler capture around a pipeline stage: CPU ops, the
    program's spans as ranges, and CUDA kernels when a card is present,
    written to `log_dir/trace.json` (Chrome trace format; open it in
    Perfetto or chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
