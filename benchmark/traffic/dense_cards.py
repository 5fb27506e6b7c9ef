"""Traffic kind `dense_cards`: the `dense` kind's back-to-back
`colmap patch_match_stereo` runs, round robin over the cell's cards, traced
from the main thread.

The job, the closed loop and the outputs are `traffic/dense.py`'s: one
user waits on each `run_patch_match_stereo` (photometric pass, then
geometric pass, `num_devices` = `chips`), and the job in flight at
`--seconds` finishes inside the window. What differs:

- the warm-up job has one frame for every card, so each card has its
  context, its allocator and the cost kernel loaded before the window;
- with `--trace 1` the profiler starts and stops on the main thread, around
  the controller's call that runs the first job's photometric pass on its
  shard threads (`run_shards`): every card's part of that pass, every
  solve of it in `marks["pm_solves"]`, and each device op with its card
  (`CardTracer.card_ops`); the seconds the profiler took to reduce the
  slice go to the totals as `trace_reduce_s`;
- the judge reads the geometric maps as the last job wrote them, by
  image name (`stereo/{depth,normal}_maps/<name>.geometric.bin`), so a map
  lost or filed under another frame at a card's fetch, at the merge of
  the cards' maps or at the write counts against it; each job's map files
  are removed before it starts, so none is left from an earlier job. The
  photometric maps, which a job neither returns nor writes, are the
  solver's, as in `dense`;
- the judge adds, per pass, the worst frame's median depth error
  (`reference/dense_cards.py`), which finds a lost card or two frames'
  maps swapped where the pooled medians do not.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np

from benchmark import harness
from benchmark.reference import dense_cards as reference
from benchmark.traffic import dense


class CardTracer(harness.Tracer):
    """The harness's tracer that also keeps each device op's card:
    `card_ops` holds (card, name, start_us, end_us)."""

    def __init__(self, enabled, sync):
        super().__init__(enabled, sync)
        self.card_ops = []
        self.reduce_s = None

    def stop(self) -> None:
        prof = self.prof
        if prof is None:
            return
        t0 = time.perf_counter()
        super().stop()
        from torch.autograd import DeviceType

        for e in prof.events():
            if e.device_type != DeviceType.CUDA or \
                    getattr(e, "is_user_annotation", False) or \
                    e.name in self.labels:
                continue
            tr = e.time_range
            self.card_ops.append((int(e.device_index), e.name,
                                  float(tr.start), float(tr.end)))
        self.reduce_s = time.perf_counter() - t0


class _Solves(dense._Solves):
    """`dense._Solves` that also records each solve's shape while
    `recording` is a list (the solves of the traced slice)."""

    recording = None

    def __call__(self, draws, problem, opts, *args, **kwargs):
        out = super().__call__(draws, problem, opts, *args, **kwargs)
        if self.recording is not None:
            H, W = problem.ref_image.shape
            self.recording.append(dict(
                width=int(W), height=int(H),
                sources=int(problem.src_images.shape[0]),
                geometric=bool(opts.geom_consistency),
                window_radius=opts.window_radius,
                window_step=opts.window_step,
                num_iterations=opts.num_iterations,
                num_perturbations=opts.num_perturbations,
                num_refinement_iterations=opts.num_refinement_iterations))
        return out


class _TracedPass:
    """Wraps the controller's `run_shards`, which it calls on the main
    thread once a pass: in a traced run, the first call runs under the
    profiler."""

    def __init__(self, run, solves):
        from colmap_tpu_torch.controllers import dense_reconstruction as dr

        self.dr, self.inner = dr, dr.run_shards
        self.run, self.solves = run, solves
        self.armed = run.trace
        dr.run_shards = self

    def __call__(self, mesh, fn):
        if not self.armed:
            return self.inner(mesh, fn)
        self.armed = False
        tracer = self.run.tracer
        self.solves.recording = []
        tracer.start()
        try:
            return self.inner(mesh, fn)
        finally:
            tracer.stop()
            tracer.marks["pm_solves"] = self.solves.recording
            self.solves.recording = None
            self.run.totals["trace_reduce_s"] = tracer.reduce_s

    def remove(self):
        self.dr.run_shards = self.inner


def setup(run) -> None:
    from colmap_tpu_torch.controllers.dense_reconstruction import (
        run_patch_match_stereo)

    # the readers of the `dense` kind's end-to-end metrics
    # (metrics/dense_mpix_per_s.py) look for that kind by name: this kind
    # runs the same loop and leaves the same totals
    run.cell = dict(run.cell, traffic="dense")
    run.tracer = CardTracer(run.tracer.enabled, run.tracer.sync)
    p = run.params
    frames = [k * p["frame_step"] for k in range(p["frames"])]
    ws = os.path.join(run.workdir, "workspace")
    truth = dense._build(ws, p, frames, run)
    run.state.update(ws=ws, truth=truth)
    # one frame a card: the problems go round robin over the shards
    warm = os.path.join(run.workdir, "warmup")
    dense._build(warm, p, frames[:max(run.chips, 2)], run)
    run_patch_match_stereo(warm, dense._stereo_options(
        p, run.chips, num_iterations=1, num_refinement_iterations=0),
        device=run.device)
    shutil.rmtree(warm)
    run.state["solves"] = _Solves(run)


def _clear_maps(ws: str) -> None:
    """Removes the depth and normal map files of the workspace."""
    for kind in ("depth_maps", "normal_maps"):
        folder = os.path.join(ws, "stereo", kind)
        for name in os.listdir(folder):
            os.remove(os.path.join(folder, name))


def _read_mat(path: str) -> np.ndarray:
    """A map file as COLMAP writes it: the header `width&height&channels&`,
    then each channel's plane of little-endian float32, row by row."""
    with open(path, "rb") as f:
        w, h, c, data = f.read().split(b"&", 3)
    planes = np.frombuffer(data, "<f4").reshape(int(c), int(h), int(w))
    return planes[0] if int(c) == 1 else np.moveaxis(planes, 0, -1)


def written_maps(ws: str, names) -> dict:
    """{frame name: (depth, normal)} of the geometric maps in the
    workspace, read back by name; a frame without both files is left
    out."""
    out = {}
    for name in names:
        paths = [os.path.join(ws, "stereo", kind, f"{name}.geometric.bin")
                 for kind in ("depth_maps", "normal_maps")]
        if all(os.path.exists(q) for q in paths):
            out[name] = tuple(_read_mat(q) for q in paths)
    return out


class _FreshMaps:
    """Wraps the controller's `run_patch_match_stereo` so that each job
    starts without map files."""

    def __init__(self):
        from colmap_tpu_torch.controllers import dense_reconstruction as dr

        self.dr, self.inner = dr, dr.run_patch_match_stereo
        dr.run_patch_match_stereo = self

    def __call__(self, workspace_path, *args, **kwargs):
        _clear_maps(workspace_path)
        return self.inner(workspace_path, *args, **kwargs)

    def remove(self):
        self.dr.run_patch_match_stereo = self.inner


def window(run) -> None:
    import torch

    traced = _TracedPass(run, run.state["solves"])
    fresh = _FreshMaps()
    try:
        dense.window(run)
    finally:
        fresh.remove()
        traced.remove()
    if run.device != "cpu":
        run.totals["peak_bytes_by_card"] = [
            torch.cuda.max_memory_allocated(k) for k in range(run.chips)]


def outputs(run) -> None:
    dense.outputs(run)
    run.outputs["maps"]["geometric"] = written_maps(
        run.state["ws"], run.state["truth"]["names"])


def _control_maps(run):
    """The control's maps, taken as the cell's own: the photometric
    pass's from the solver, the geometric pass's from the files."""
    _clear_maps(run.state["ws"])
    maps = dense._control_maps(run)
    maps["geometric"] = written_maps(run.state["ws"],
                                     run.state["truth"]["names"])
    return maps


def judge(run, control: bool = False):
    from benchmark.harness import Check

    limits = run.cell["limits"]
    maps = _control_maps(run) if control else run.outputs["maps"]
    p = run.params
    got = reference.judge(maps, run.state["truth"], p["window_radius"],
                          p["texture_sd"])
    # a limit is a number the reading may not pass, or {"at_least": x}
    return [Check(name, got[name], limit["at_least"], at_most=False)
            if isinstance(limit, dict) else Check(name, got[name], limit)
            for name, limit in limits.items()]
