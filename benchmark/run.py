"""Run one cell of the port's benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control 1]

The cell's file names its configuration and traffic kind; the traffic
module sets the cell up from the seed (set-up is timed as `setup_s`), runs
its closed loop for `--seconds` (the job in flight at the deadline
finishes inside the window), gathers the outputs, and judges them with the
plain reference under `benchmark/reference/`. With `--trace 1` a slice of
the window runs under torch.profiler and the line carries the per-layer
metrics; with `--trace 0` the end-to-end ones. `--control 1` also judges
the cell's control on the same run and prints its numbers beside
the program's (the benchmark's own runs do not pass it).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (and `breakdown` with
`--trace 1`), and last `checks`: each compared number with its limit,
which also end standard error. Without a CUDA card, or with fewer cards
than the cell asks for, it exits 2 and prints no result; if JAX or the
JAX package is loaded by the time the line is due, it names what it
found on standard error, exits 3 and prints no result.
"""

from __future__ import annotations

import time

PROCESS_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

from benchmark import harness  # noqa: E402

# build and kernel caches at fixed paths inside the checkout, so only the
# first run of a cell there builds (K1 builds under colmap_tpu_torch/_build)
CACHE_DIR = os.path.join(harness.ROOT, ".bench_cache")


def _environment() -> None:
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _devices_used(run) -> list:
    import torch

    if run.device == "cpu":
        return []
    return [torch.device("cuda", k) for k in range(run.chips)]


def _sync(run):
    import torch

    def sync():
        for d in _devices_used(run):
            torch.cuda.synchronize(d)
    return sync


def _device_info(run) -> dict:
    import torch

    if run.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in _devices_used(run))}


def execute(args, device: str = "cuda", params: dict = None,
            spec: dict = None, out=sys.stdout, err=sys.stderr) -> int:
    """One run of the cell; returns the exit code. `device`, `params`
    (merged over the cell's) and `spec` (in place of BENCHMARK.json) let
    a CPU test rehearse a cell at a tiny size."""
    _environment()
    spec = harness.benchmark_spec() if spec is None else spec
    cell = harness.cell_file(args.workload)
    if params:
        cell = dict(cell, params=dict(cell["params"], **params))
    harness.config_file(cell["config"])  # the cell's configuration exists
    chips = int(cell["chips"])

    import torch

    if device != "cpu":
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark measures the card only",
                  file=err)
            return 2
        if torch.cuda.device_count() < chips:
            print(f"the cell needs {chips} cards, "
                  f"{torch.cuda.device_count()} present", file=err)
            return 2
    workdir = tempfile.mkdtemp(prefix=f"bench-{args.workload}-")
    run = harness.Run(workload=args.workload, cell=cell, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device=device, chips=chips, workdir=workdir,
                      tracer=None)
    run.tracer = harness.Tracer(bool(args.trace), _sync(run))
    try:
        traffic = harness.traffic_module(cell["traffic"])
        traffic.setup(run)
        _sync(run)()
        run.totals["setup_s"] = time.perf_counter() - PROCESS_T0
        traffic.window(run)
        run.tracer.stop()
        device_info = _device_info(run)
        traffic.outputs(run)
        checks = traffic.judge(run, control=False)
        control = traffic.judge(run, control=True) if args.control else None
    except Exception:  # noqa: BLE001 - a failed run prints no result
        traceback.print_exc(file=err)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in harness.cell_metrics(spec, args.workload)[kind]:
        value = harness.metric_module(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if args.trace:
        device_info["busy_s"] = harness.union_seconds(run.tracer.device_ops)
        device_info["window_s"] = run.tracer.window_s
    result = {
        "correct": all(c.ok for c in checks),
        "attempted": int(run.totals.get("attempted", 0)),
        "failed": int(run.totals.get("failed", 0)),
        "metrics": metrics,
        "device": device_info,
    }
    if args.trace and run.tracer.done:
        result["breakdown"] = harness.breakdown(run.tracer)
    if control is not None:
        result["control"] = {c.name: {"value": c.value, "limit": c.limit}
                             for c in control}
        for c in control:
            print("control " + c.line(), file=err)
    result["checks"] = {
        c.name: {"value": c.value, "limit": c.limit,
                 "at": "most" if c.at_most else "least"} for c in checks}
    print("totals " + json.dumps(run.totals), file=err)
    print("spans " + json.dumps(run.spans), file=err)
    print("counters " + json.dumps(run.counters), file=err)
    for c in checks:
        print(("ok   " if c.ok else "FAIL ") + c.line(), file=err)
    err.flush()
    # last, once the judge, the control and every metric reader have run
    found = harness.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=err, flush=True)
        return 3
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    return execute(parse(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    sys.exit(main())
