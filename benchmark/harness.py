"""The benchmark's core: find a cell's files by name, set it up, run its
window, trace a slice of it, judge its outputs and print the result line.

Everything that belongs to one configuration, cell, traffic kind or metric
lives in a file of its own, found by the name `BENCHMARK.json` gives:

    benchmark/configs/<config>.json    the deployment, its source and cuts
    benchmark/workloads/<cell>.json    config, traffic kind and parameters
    benchmark/traffic/<kind>.py        setup / window / outputs / judge
    benchmark/metrics/<metric>.py      read(run) -> number or None

so a later cell, kind or metric is new files and a new entry in
`BENCHMARK.json`, never an edit here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# modules that may not be loaded in a run: JAX and the JAX package, by
# whole top-level name (the port's name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "colmap_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_file(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "workloads", name + ".json"))


def config_file(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "configs", name + ".json"))


def _load(folder: str, name: str):
    """<folder>/<name>.py under BENCH_DIR, loaded by its path (a metric's
    name may hold dots, which an import statement cannot)."""
    key = f"benchmark.{folder}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = os.path.join(BENCH_DIR, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def traffic_module(kind: str):
    return _load("traffic", kind)


def metric_module(name: str):
    return _load("metrics", name)


def cell_metrics(spec: dict, workload: str) -> Dict[str, List[dict]]:
    """The end-to-end and per-layer metrics that `workload` reports: an
    end-to-end metric where its `workloads` lists the cell or it has none;
    a per-layer metric where its `workloads` lists the cell or, without
    the key, wherever the end-to-end metric it moves is reported."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (workload in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": per}


def forbidden_loaded(modules=None) -> List[str]:
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN_MODULES})


@dataclasses.dataclass
class Check:
    """One number compared with its limit: the run is correct only if
    `value <= limit` (`at_most`) or `value >= limit` (otherwise)."""

    name: str
    value: float
    limit: float
    at_most: bool = True

    @property
    def ok(self) -> bool:
        v = float(self.value)
        if v != v:  # NaN never passes
            return False
        return v <= self.limit if self.at_most else v >= self.limit

    def line(self) -> str:
        op = "<=" if self.at_most else ">="
        return f"{self.name} {self.value!r} {op} {self.limit!r}"


class Tracer:
    """A slice of the window under torch.profiler (CPU and CUDA). The
    traffic calls `start()` and `stop()` around the slice it chooses; with
    tracing off both do nothing. `stop()` reduces the trace to kernel
    intervals and host ops in memory and writes nothing to disk."""

    def __init__(self, enabled: bool, sync: Callable[[], None]):
        self.enabled = enabled
        self.sync = sync
        self.prof = None
        self.t0 = self.t1 = None
        self.done = False
        self.kernels: List[tuple] = []  # (name, start_us, end_us)
        self.device_ops: List[tuple] = []  # kernels, copies and sets
        self.host_ops: List[tuple] = []  # (name, start_us, end_us)
        self.marks: Dict[str, object] = {}  # what the traffic recorded
        self.labels: set = set()  # names of the ranges `label` opened

    @property
    def active(self) -> bool:
        return self.prof is not None

    def start(self) -> None:
        if not self.enabled or self.done or self.active:
            return
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if not self.active:
            return
        from torch.autograd import DeviceType

        self.sync()
        self.t1 = time.perf_counter()
        self.prof.stop()
        for e in self.prof.events():
            tr = e.time_range
            item = (e.name, float(tr.start), float(tr.end))
            if e.device_type == DeviceType.CUDA:
                # a profiler range shows on the device's timeline too
                if getattr(e, "is_user_annotation", False) or \
                        e.name in self.labels:
                    continue
                self.device_ops.append(item)
                low = e.name.lower()
                if not (low.startswith("memcpy") or low.startswith("memset")):
                    self.kernels.append(item)
            else:
                self.host_ops.append(item)
        self.prof = None
        self.done = True

    @property
    def window_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def label(self, owner, attr: str, name) -> Callable[[], None]:
        """In a traced run, wrap `owner.attr` (a function the program
        calls) in a profiler range `name` (or `name(args)`), so the
        breakdown can name the host work in a device gap; returns the
        function that unwraps it."""
        if not self.enabled:
            return lambda: None
        from torch.profiler import record_function

        inner = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            label = name if isinstance(name, str) else name(args)
            self.labels.add(label)
            with record_function(label):
                return inner(*args, **kwargs)

        setattr(owner, attr, wrapped)
        return lambda: setattr(owner, attr, inner)


@dataclasses.dataclass
class Run:
    """What one run knows: its cell, its inputs, and what it measured."""

    workload: str
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    chips: int
    workdir: str  # scratch files of this run (under TMPDIR)
    tracer: Tracer
    state: dict = dataclasses.field(default_factory=dict)
    totals: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    outputs: dict = dataclasses.field(default_factory=dict)

    @property
    def params(self) -> dict:
        return self.cell["params"]

    def span(self, name: str, seconds: float) -> None:
        self.spans[name] = self.spans.get(name, 0.0) + seconds

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n


def union_seconds(intervals) -> float:
    """Length of the union of (start_us, end_us) intervals, in seconds."""
    total, end = 0.0, None
    for s, e in sorted((s, e) for _, s, e in intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def breakdown(tracer: Tracer, k: int = 10) -> dict:
    """The device ops that took most time, and the longest idle gaps of
    the device, each named by the innermost host op running at its
    middle."""
    per: Dict[str, float] = {}
    for name, s, e in tracer.device_ops:
        per[name] = per.get(name, 0.0) + (e - s) / 1e6
    top = sorted(per.items(), key=lambda kv: -kv[1])[:k]
    ops = sorted((s, e) for _, s, e in tracer.device_ops)
    gaps, end = [], None
    t_lo = min((s for _, s, _ in tracer.host_ops), default=None)
    if ops and t_lo is not None:
        end = t_lo
    for s, e in ops:
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    named = []
    for length, a, b in gaps[:k]:
        mid = 0.5 * (a + b)
        inside = [(e - s, n) for n, s, e in tracer.host_ops if s <= mid <= e]
        label = min(inside)[1] if inside else "host (no op)"
        named.append([label, length / 1e6])
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": named}
