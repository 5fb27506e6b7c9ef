"""The port's span recorder (`util/timer.py`) and the spans of its dense
path, on the CPU.

- spans nest: a span's parent is the innermost open span on its thread,
  a job is the outermost span and every span inside carries its id; a
  thread that adopts a span puts its spans in that span's job; the ring
  keeps the newest spans up to its capacity;
- with no profiler recording no profiler range is opened; under
  torch.profiler each span is a host range that encloses its ops, and
  its record and its range agree within 50 us or 5%;
- the solver's spans cover its body (one `patch_match` span around it;
  inside, precompute, init, one propagation and one refinement per
  half-iteration, filter; one cost span per kernel launch, in init and
  in each half-iteration: 37 at the defaults);
- `run_patch_match_stereo` on one device and on a 2-shard CPU mesh: every
  `dense.solve` span's parent chain reaches its job root, and `timings`
  equals the spans' seconds and counts; the workspace load holds one
  `dense.read_model`, `dense.build_model` and `dense.read_images` each;
- the span metrics' readers on a job recorded by hand, the launch-share
  reader on a made-up trace, and the dense cell at
  benchmark/tests/test_cells_cpu.py's tiny size with `--trace 1` (in a
  process of its own, since this one has JAX loaded): the three span
  metrics, and not the launch share.
"""

import collections
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from colmap_tpu_torch.controllers import dense_reconstruction as dense
from colmap_tpu_torch.mvs import patch_match as pm
from colmap_tpu_torch.scene import reconstruction_io
from colmap_tpu_torch.scene import synthetic_images as synth
from colmap_tpu_torch.util import timer
from tests.test_torch_dense import _gt_reconstruction

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAN_METRICS = ("dense.host_ms_per_map", "patch_match.solve_ms.photometric",
                "patch_match.solve_ms.geometric")


def test_spans_nest_into_jobs():
    rec = timer.SpanRecorder()
    with rec.span("job", run=1) as job:
        with rec.span("a") as a:
            with rec.span("b", k=2) as b:
                assert rec.current() is b
        with rec.span("c") as c:
            pass
    with rec.span("job") as job2:
        pass
    assert rec.current() is None
    assert (job.parent, a.parent, b.parent, c.parent) == (
        None, job.id, a.id, job.id)
    assert {s.job for s in (job, a, b, c)} == {job.id}
    assert job2.job == job2.id != job.id
    assert [s.name for s in rec.job_spans(job.id)] == ["b", "a", "c", "job"]
    assert rec.last_job("job") == [job2]
    assert rec.last_job("a") == []  # not a job: it has a parent
    assert b.attrs == {"k": 2} and job.attrs == {"run": 1}
    assert job.thread == threading.get_ident()
    assert job.start <= a.start <= b.start <= b.end <= a.end <= c.start
    assert c.end <= job.end and job.seconds > 0


def test_a_failing_span_is_recorded_and_closed():
    rec = timer.SpanRecorder()
    with pytest.raises(ValueError):
        with rec.span("job"):
            with rec.span("inner"):
                raise ValueError("x")
    assert [s.name for s in rec.spans()] == ["inner", "job"]
    assert rec.current() is None


def test_the_ring_keeps_the_newest_spans():
    rec = timer.SpanRecorder(capacity=16)
    for k in range(40):
        with rec.span("s", k=k):
            pass
    kept = rec.spans()
    assert len(kept) == 16
    assert [s.attrs["k"] for s in kept] == list(range(24, 40))
    assert timer.RECORDER._ring.maxlen == timer.SPAN_RING == 65536


def test_an_adopting_thread_records_into_the_job():
    rec = timer.SpanRecorder()
    seen = {}

    def work(parent, k):
        with rec.adopt(parent):
            with rec.span("shard", k=k) as s:
                with rec.span("inner"):
                    pass
            seen[k] = s
        assert rec.current() is None

    with rec.span("job") as job:
        with rec.span("pass") as p:
            threads = [threading.Thread(target=work, args=(rec.current(), k))
                       for k in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
    for k in range(3):
        assert seen[k].parent == p.id and seen[k].job == job.id
        assert seen[k].thread != job.thread
    names = collections.Counter(s.name for s in rec.job_spans(job.id))
    assert names == {"shard": 3, "inner": 3, "pass": 1, "job": 1}


def test_no_profiler_range_without_a_profiler(monkeypatch):
    opened = []
    real = autograd_profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(autograd_profiler, "record_function", counting)
    for _ in range(5):
        with timer.span("quiet"):
            pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.span("loud.outer"):
            with timer.span("loud.inner"):
                pass
    assert opened == ["loud.outer", "loud.inner"]


def test_spans_are_profiler_ranges_that_enclose_their_ops():
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.span("trace.outer") as outer:
            x + 1
            time.sleep(0.003)
            with timer.span("trace.inner") as inner:
                time.sleep(0.002)
                x * 2
            time.sleep(0.001)
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(
            (e.time_range.start, e.time_range.end))
    (o_s, o_e), = events["trace.outer"]
    (i_s, i_e), = events["trace.inner"]
    assert o_s <= i_s <= i_e <= o_e
    (add_s, add_e), = events["aten::add"]
    (mul_s, mul_e), = events["aten::mul"]
    assert o_s <= add_s <= add_e <= i_s
    assert i_s <= mul_s <= mul_e <= i_e
    for span, (s, e) in ((outer, (o_s, o_e)), (inner, (i_s, i_e))):
        mine = span.seconds * 1e6
        assert abs(mine - (e - s)) <= max(50.0, 0.05 * mine), (mine, e - s)
    # the inner span starts where its range starts, measured from the outer
    mine = (inner.start - outer.start) / 1e3
    assert abs(mine - (i_s - o_s)) <= max(50.0, 0.05 * mine)


def test_stage_timings_are_spans():
    st = timer.StageTimings()
    with timer.span("pipeline") as job:
        with st.stage("load"):
            time.sleep(0.001)
    (load,) = [s for s in timer.job_spans(job.id) if s.name == "load"]
    assert load.parent == job.id
    assert st.totals["load"] == load.seconds and st.counts["load"] == 1


def _problem(h=24, w=32, sources=3):
    g = torch.Generator()
    g.manual_seed(0)
    K = torch.tensor([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]])
    return pm.PatchMatchProblem(
        ref_image=torch.rand(h, w, generator=g),
        src_images=torch.rand(sources, h, w, generator=g),
        K_ref=K, K_src=K.expand(sources, 3, 3).clone(),
        R_rel=torch.eye(3).expand(sources, 3, 3).clone(),
        t_rel=torch.tensor([[0.1, 0.0, 0.0]] * sources),
        depth_min=torch.tensor(1.0), depth_max=torch.tensor(5.0))


def test_the_solvers_spans_cover_its_body():
    problem = _problem()
    g = torch.Generator()
    g.manual_seed(3)
    with timer.span("solve") as solve:
        pm.patch_match(pm.GeneratorDraws(g, (24, 32)), problem,
                       pm.PatchMatchOptions())
    spans = timer.job_spans(solve.id)
    names = collections.Counter(s.name for s in spans)
    # one cost span (one launch on the card) at init and in each of the
    # 10 propagation and 6 refinement half-iterations
    assert names == {"patch_match.cost": 17, "patch_match.propagation": 10,
                     "patch_match.refinement": 6,
                     "patch_match.precompute": 1, "patch_match.init": 1,
                     "patch_match.filter": 1, "patch_match": 1, "solve": 1}
    (body,) = [s for s in spans if s.parent == solve.id]
    assert body.name == "patch_match"
    assert body.end - body.start >= 0.95 * (solve.end - solve.start)
    top = sorted((s for s in spans if s.parent == body.id),
                 key=lambda s: s.start)
    assert [s.name for s in top] == (
        ["patch_match.precompute", "patch_match.init"]
        + ["patch_match.propagation"] * 10
        + ["patch_match.refinement"] * 6 + ["patch_match.filter"])
    assert [s.attrs["iteration"] for s in top[2:12]] == list(range(10))
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "patch_match.cost":
            assert by_id[s.parent].name in ("patch_match.init",
                                            "patch_match.propagation",
                                            "patch_match.refinement")
    covered = sum(s.end - s.start for s in top)
    assert covered >= 0.95 * (solve.end - solve.start)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    o = synth.RoomDatasetOptions(num_images=3, width=80, height=60,
                                 focal=70.0, seed=2)
    room = synth.render_room_dataset(o, return_depth=True) + (o,)
    ws = str(tmp_path_factory.mktemp("tracing_ws"))
    synth.write_dataset(os.path.join(ws, "images"), room[0])
    for sub in ("sparse", "stereo/depth_maps", "stereo/normal_maps"):
        os.makedirs(os.path.join(ws, sub), exist_ok=True)
    reconstruction_io.write_model(_gt_reconstruction(room),
                                  os.path.join(ws, "sparse"), ext=".bin")
    return ws


@pytest.mark.parametrize("num_devices", [1, 2])
def test_dense_job_spans_and_timings(workspace, num_devices):
    timings = {}
    depths = dense.run_patch_match_stereo(
        workspace, dense.PatchMatchStereoOptions(
            patch_match=pm.PatchMatchOptions(num_iterations=1,
                                             num_refinement_iterations=1),
            max_num_src_images=2, num_devices=num_devices),
        device="cpu", timings=timings)
    spans = timer.last_job("dense.patch_match_stereo")
    job = spans[-1]
    assert job.name == "dense.patch_match_stereo" and job.parent is None
    assert all(s.job == job.id for s in spans)
    by_id = {s.id: s for s in spans}
    solves = [s for s in spans if s.name == "dense.solve"]
    assert len(solves) == 2 * len(depths) == 6
    for s in solves:
        chain = [s]
        while chain[-1].parent is not None:
            chain.append(by_id[chain[-1].parent])
        assert chain[1].name == "dense.pass"
        assert chain[1].attrs["pass"] == s.attrs["pass"]
        assert chain[-1] is job
        assert s.attrs["sources"] == 2
        if num_devices == 2:
            assert s.thread != job.thread
    names = collections.Counter(s.name for s in spans)
    assert names["dense.upload"] == names["dense.fetch"] == 6
    assert names["dense.load_workspace"] == names["dense.write_maps"] == 1
    assert names["patch_match.cost"] == 6 * (1 + 2 + 2)
    seconds = collections.defaultdict(float)
    for s in spans:
        if s.name == "dense.pass":
            seconds[s.attrs["pass"]] += s.seconds
    for kind in ("photometric", "geometric"):
        assert timings[kind] == seconds[kind]
        assert timings[kind] >= max(s.seconds for s in solves
                                    if s.attrs["pass"] == kind)
    assert timings["maps"] == len(depths) == sum(
        s.attrs["pass"] == "photometric" for s in solves)
    (load,) = [s for s in spans if s.name == "dense.load_workspace"]
    (write,) = [s for s in spans if s.name == "dense.write_maps"]
    assert (timings["load"], timings["write"]) == (load.seconds,
                                                   write.seconds)


def _run_small_job(workspace, timings):
    return dense.run_patch_match_stereo(
        workspace, dense.PatchMatchStereoOptions(
            patch_match=pm.PatchMatchOptions(num_iterations=1,
                                             num_refinement_iterations=1),
            max_num_src_images=2),
        device="cpu", timings=timings)


def test_dense_timings_inside_a_callers_span(workspace):
    timings = {}
    with timer.span("pipeline") as outer:
        depths = _run_small_job(workspace, timings)
    spans = timer.job_spans(outer.id)
    (job,) = [s for s in spans if s.name == "dense.patch_match_stereo"]
    assert job.parent == outer.id
    for kind in ("photometric", "geometric"):
        (p,) = [s for s in spans
                if s.name == "dense.pass" and s.attrs["pass"] == kind]
        assert timings[kind] == p.seconds
    (load,) = [s for s in spans if s.name == "dense.load_workspace"]
    (write,) = [s for s in spans if s.name == "dense.write_maps"]
    assert (timings["load"], timings["write"]) == (load.seconds,
                                                   write.seconds)
    assert timings["maps"] == len(depths) == 3


def test_the_workspace_load_has_its_parts(workspace):
    _run_small_job(workspace, {})
    spans = timer.last_job("dense.patch_match_stereo")
    (load,) = [s for s in spans if s.name == "dense.load_workspace"]
    parts = sorted((s for s in spans if s.parent == load.id),
                   key=lambda s: s.start)
    assert [s.name for s in parts] == ["dense.read_model", "dense.build_model",
                                       "dense.read_images"]
    names = collections.Counter(s.name for s in spans)
    assert all(names[s.name] == 1 for s in parts)
    assert load.start <= parts[0].start
    assert all(a.end <= b.start for a, b in zip(parts, parts[1:]))
    assert parts[-1].end <= load.end
    assert all(s.seconds > 0 for s in parts)


def test_dense_timings_when_the_job_overflows_the_ring(workspace,
                                                       monkeypatch):
    monkeypatch.setattr(timer.RECORDER, "_ring",
                        collections.deque(maxlen=16))
    timings = {}
    t0 = time.perf_counter()
    depths = _run_small_job(workspace, timings)
    wall = time.perf_counter() - t0
    ring = timer.RECORDER.spans()
    assert len(ring) == 16 and ring[-1].name == "dense.patch_match_stereo"
    assert not any(s.name == "dense.load_workspace"
                   or s.attrs.get("pass") == "photometric" for s in ring)
    assert timings["maps"] == len(depths) == 3
    assert set(timings) == {"photometric", "geometric", "maps", "load",
                            "write"}
    parts = [timings[k] for k in ("load", "photometric", "geometric",
                                  "write")]
    assert min(parts) > 0 and sum(parts) <= wall


def _record_job(solve_ms):
    """A dense job recorded by hand: its solves sleep `solve_ms`."""
    with timer.span("dense.patch_match_stereo"):
        time.sleep(0.004)
        for kind, times in solve_ms.items():
            with timer.span("dense.pass", **{"pass": kind}):
                for ms in times:
                    with timer.span("dense.solve", **{"pass": kind}):
                        time.sleep(ms / 1e3)
    return timer.last_job("dense.patch_match_stereo")


def test_the_span_metrics_read_the_last_job():
    run = harness.Run("tum_rgbd_fr3.dense", {}, 1, 1.0, True, "cpu", 1, "",
                      harness.Tracer(False, lambda: None))
    _record_job({"photometric": [80.0], "geometric": [80.0]})
    spans = _record_job({"photometric": [2.0, 80.0, 3.0],
                         "geometric": [5.0, 4.0]})
    job = spans[-1]
    solves = [s for s in spans if s.name == "dense.solve"]
    got = {m: harness.metric_module(m).read(run) for m in SPAN_METRICS}
    assert got["dense.host_ms_per_map"] == pytest.approx(
        1e3 * (job.seconds - sum(s.seconds for s in solves)) / 5)
    assert got["dense.host_ms_per_map"] >= 4.0 / 5
    for kind in ("photometric", "geometric"):
        assert got[f"patch_match.solve_ms.{kind}"] == pytest.approx(
            statistics.median(1e3 * s.seconds for s in solves
                              if s.attrs["pass"] == kind))
    # the median, of the last job: not its slow solve, nor the job before
    assert 3.0 <= got["patch_match.solve_ms.photometric"] < 40.0
    assert 4.0 <= got["patch_match.solve_ms.geometric"] < 40.0


def test_host_ms_per_map_takes_overlapping_solves_once():
    run = harness.Run("tum_rgbd_fr3.dense", {}, 1, 1.0, True, "cpu", 1, "",
                      harness.Tracer(False, lambda: None))

    both = threading.Barrier(2)

    def shard(parent):
        with timer.adopt(parent):
            for _ in range(2):
                with timer.span("dense.solve", **{"pass": "photometric"}):
                    both.wait()  # the two shards' solves overlap
                    time.sleep(0.03)

    with timer.span("dense.patch_match_stereo"):
        time.sleep(0.004)
        with timer.span("dense.pass", **{"pass": "photometric"}) as p:
            threads = [threading.Thread(target=shard, args=(p,))
                       for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
    spans = timer.last_job("dense.patch_match_stereo")
    job = spans[-1]
    solves = sorted(((s.start, s.end) for s in spans
                     if s.name == "dense.solve"))
    assert len(solves) == 4
    merged = [list(solves[0])]
    for lo, hi in solves[1:]:
        if lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    solving = sum(hi - lo for lo, hi in merged)
    assert solving < sum(hi - lo for lo, hi in solves)
    got = harness.metric_module("dense.host_ms_per_map").read(run)
    assert got == pytest.approx(1e-6 * (job.end - job.start - solving) / 4)
    assert got >= 4.0 / 4


def test_the_launch_share_reader_on_a_made_up_trace():
    read = harness.metric_module("patch_match.cost_launch_share").read
    run = harness.Run("tum_rgbd_fr3.dense", {}, 1, 1.0, True, "cuda", 1, "",
                      harness.Tracer(True, lambda: None))
    tr = run.tracer
    assert read(run) is None  # nothing traced
    tr.done = True
    tr.host_ops = [("patch_match.precompute", 0.0, 10.0),
                   ("cudaLaunchKernel", 1.0, 2.0),
                   ("patch_match.propagation", 10.0, 100.0),
                   ("patch_match.cost", 20.0, 40.0),
                   ("aten::mul", 21.0, 23.0),
                   ("cudaLaunchKernel", 21.5, 22.0),
                   ("cudaLaunchKernelExC", 30.0, 31.0),
                   ("cuLaunchKernel", 40.0, 41.0),  # starts at the end
                   ("cudaMemcpyAsync", 45.0, 46.0),
                   ("cudaLaunchKernel", 50.0, 51.0),
                   ("patch_match.cost", 60.0, 80.0),
                   ("cuLaunchKernelEx", 70.0, 71.0),
                   ("cudaLaunchKernel", 90.0, 91.0)]
    # 7 launches, 4 inside a cost range
    assert read(run) == pytest.approx(100.0 * 4 / 7)
    tr.host_ops = [x for x in tr.host_ops if "Launch" not in x[0]]
    assert read(run) is None  # no launches: the CPU's trace
    tr.host_ops = [("cudaLaunchKernel", 1.0, 2.0)]
    assert read(run) is None  # no cost ranges: a program without the span


def test_a_traced_cpu_run_of_the_dense_cell_reports_the_span_metrics():
    code = (
        "import io, json, sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark import run\n"
        "from benchmark.tests.test_cells_cpu import CELL, TINY\n"
        "args = run.parse(['--workload', CELL, '--seed', str(2 ** 31 + 9),\n"
        "                  '--seconds', '0.5', '--trace', '1'])\n"
        "out = io.StringIO()\n"
        "rc = run.execute(args, device='cpu', params=TINY, out=out)\n"
        "print(out.getvalue().strip().splitlines()[-1] if rc == 0 else '')\n"
        "sys.exit(rc)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    metrics = line["metrics"]
    for name in SPAN_METRICS:
        assert metrics[name]["value"] > 0 and metrics[name]["unit"] == "ms/map"
    assert "patch_match.cost_launch_share" not in metrics
    # one job of 3 maps a pass: each solve takes longer than the host's
    # share of a map
    assert metrics["patch_match.solve_ms.photometric"]["value"] > \
        metrics["dense.host_ms_per_map"]["value"]
    assert np.isfinite([m["value"] for m in metrics.values()]).all()
