"""The dense cell rehearsed end to end on the CPU at a tiny size: the
result line's schema, the control judged not correct, the timed path
broken underneath each way the cell can break, judged not correct, and
no result once JAX is loaded."""

import io
import json
import math
import sys

import pytest
import torch

from benchmark import harness, run

CELL = "tum_rgbd_fr3.dense"
# the cell at 160x120: the camera scaled with the frame
TINY = dict(frames=3, frame_step=20, width=160, height=120,
            camera=dict(fx=535.4 / 4, fy=539.2 / 4, cx=320.1 / 4,
                        cy=247.6 / 4), texture_res=512, trace_map=1)
SECONDS = 0.5


def _execute(workload=CELL, trace=0, control=0, seed=2 ** 31 + 7,
             spec=None):
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(SECONDS), "--trace",
                      str(trace), "--control", str(control)])
    out, err = io.StringIO(), io.StringIO()
    rc = run.execute(args, device="cpu", params=TINY, out=out, err=err,
                     spec=spec)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.mark.parametrize("workload", [CELL])
def test_a_run_prints_the_result_line_and_its_control_fails(workload):
    rc, res, err = _execute(workload, control=1)
    assert rc == 0, err
    assert list(res)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    assert res["correct"] is True, err
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    spec = harness.benchmark_spec()
    want = {m["name"] for m in
            harness.cell_metrics(spec, workload)["end_to_end"]}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    # each compared number ends standard error beside its limit
    tail = err.strip().splitlines()[-len(res["checks"]):]
    for line, name in zip(tail, res["checks"]):
        assert name in line and line.startswith("ok")
    # the control: one precision lower, not correct
    ctl = [harness.Check(n, v["value"], v["limit"],
                         at_most=res["checks"][n]["at"] == "most")
           for n, v in res["control"].items()]
    assert not all(c.ok for c in ctl), res["control"]


def test_a_traced_run_reports_the_layers():
    rc, res, err = _execute(trace=1)
    assert rc == 0, err
    assert "busy_s" in res["device"] and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU the profiler sees no device ops, so the device's readers
    # find nothing to read; the launch count reads the traced solve's kernels
    assert "patch_match_roofline" not in res["metrics"]


def _dense_faults(monkeypatch, fault):
    from colmap_tpu_torch.mvs import patch_match as pm

    inner = pm.patch_match
    calls = []

    def broken(draws, problem, opts, *a, **k):
        depth, normal, cost = inner(draws, problem, opts, *a, **k)
        calls.append(1)
        if fault == "half_left_out" and len(calls) % 2:
            depth = depth * 0
        elif fault == "altered":
            depth = depth * 1.25
        elif fault == "normals_altered":  # turned 40 degrees about x
            c, s = math.cos(math.radians(40)), math.sin(math.radians(40))
            rot = torch.tensor([[1.0, 0, 0], [0, c, -s], [0, s, c]])
            normal = normal @ rot.T
        return depth, normal, cost
    monkeypatch.setattr(pm, "patch_match", broken)


FAULTS = ["half_left_out", "altered", "normals_altered"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _dense_faults(monkeypatch, fault)
    rc, res, err = _execute()
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


def test_a_run_that_loads_jax_after_the_window_prints_no_result(
        tmp_path, monkeypatch):
    """A metric reader that brings in `jax` once the judge has run: the
    run exits non-zero with no result line, and names what it found."""
    import shutil

    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "metrics" / "loads_jax.py").write_text(
        "import sys, types\n"
        "def read(run):\n"
        "    sys.modules['jax'] = types.ModuleType('jax')\n"
        "    return 1.0\n")
    monkeypatch.setattr(harness, "BENCH_DIR", str(bench))
    spec = json.loads(json.dumps(harness.benchmark_spec()))
    spec["end_to_end"].append({"name": "loads_jax", "unit": "n",
                               "better": "lower", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": [CELL]})
    try:
        rc, res, err = _execute(spec=spec)
    finally:
        sys.modules.pop("jax", None)
    assert rc != 0 and res is None
    assert "forbidden modules loaded: ['jax']" in err
