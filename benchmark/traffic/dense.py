"""Traffic kind `dense`: back-to-back `colmap patch_match_stereo` runs on an
undistorted workspace.

Set-up renders the cell's keyframes on the device from the seed, through
the configuration's calibration, and lays out the workspace with the true
sparse model
(`inputs/workspace.py`), then warms the shapes with one small job (the
first two frames at the cell's size, one iteration). The window runs
`run_patch_match_stereo` (photometric pass, then geometric pass, on
`chips` cards) again and again on the same workspace; one user waiting on
each: a closed loop; the job in flight at `--seconds` finishes inside the
window.

A wrapper around the port's `patch_match` keeps each solve's depth and
normal maps (the judge reads the last job's, both passes) and, with `--trace 1`, runs
solve `trace_map` of the first job under the profiler with its size,
sources and pass recorded.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time

import numpy as np
import torch

from benchmark.inputs import render, workspace
from benchmark.reference import dense as reference


def _orbit(p: dict) -> render.Orbit:
    return render.Orbit(num_images=p["orbit_frames"], width=p["width"],
                        height=p["height"], texture_res=p["texture_res"])


def _build(folder: str, p: dict, frames, run) -> dict:
    """The workspace of `frames`, drawn from the run's seed."""
    c = p["camera"]
    K = np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]],
                  [0, 0, 1.0]])
    return workspace.build(folder, _orbit(p), frames, run.seed, run.device,
                           K=K, texture_cells=p["texture_cells"],
                           texture_weights=p["texture_weights"])


def _stereo_options(p: dict, chips: int, **patch_match):
    from colmap_tpu_torch.controllers.dense_reconstruction import (
        PatchMatchStereoOptions)
    from colmap_tpu_torch.mvs.patch_match import PatchMatchOptions

    return PatchMatchStereoOptions(
        patch_match=PatchMatchOptions(**patch_match),
        max_num_src_images=p["max_num_src_images"], num_devices=chips)


class _Solves:
    """Wraps the port's `patch_match`: keeps each solve's pass, reference
    image, depth and normal maps (the image tells, after the window, which
    frame a map belongs to), and runs solve `trace_at` of a traced job
    under the tracer."""

    def __init__(self, run):
        from colmap_tpu_torch.mvs import patch_match as pm

        self.pm, self.inner, self.run = pm, pm.patch_match, run
        self.trace_at = None
        self.reset()
        pm.patch_match = self

    def reset(self):
        self.solves = []

    def __call__(self, draws, problem, opts, *args, **kwargs):
        kind = "geometric" if opts.geom_consistency else "photometric"
        traced = len(self.solves) == self.trace_at
        if traced:
            self.run.tracer.start()
        out = self.inner(draws, problem, opts, *args, **kwargs)
        if traced:
            self.run.tracer.stop()
            H, W = problem.ref_image.shape
            self.run.tracer.marks["pm_solves"] = [dict(
                width=int(W), height=int(H),
                sources=int(problem.src_images.shape[0]),
                geometric=kind == "geometric",
                window_radius=opts.window_radius,
                window_step=opts.window_step,
                num_iterations=opts.num_iterations,
                num_perturbations=opts.num_perturbations,
                num_refinement_iterations=opts.num_refinement_iterations)]
        self.solves.append((kind, problem.ref_image, out[0], out[1]))
        return out

    def remove(self):
        self.pm.patch_match = self.inner

    def maps(self, truth) -> dict:
        """{pass: {frame name: (depth, normal)}} on the host, each solve
        named by the frame whose intensities its reference image has (at a
        fixed sample of 4,096 pixels)."""
        n, H, W = truth["images"].shape
        pick = np.random.default_rng(0).integers(0, H * W, 4096)
        frames = truth["images"].reshape(n, -1)[:, pick] / 255.0
        out = {"photometric": {}, "geometric": {}}
        for kind, ref, depth, normal in self.solves:
            got = ref.reshape(-1)[torch.as_tensor(pick, device=ref.device)]
            k = int(np.argmin(np.abs(frames - got.cpu().numpy()).sum(1)))
            out[kind][truth["names"][k]] = (depth.cpu().numpy(),
                                            normal.cpu().numpy())
        return out


def setup(run) -> None:
    from colmap_tpu_torch.controllers.dense_reconstruction import (
        run_patch_match_stereo)

    p = run.params
    frames = [k * p["frame_step"] for k in range(p["frames"])]
    ws = os.path.join(run.workdir, "workspace")
    truth = _build(ws, p, frames, run)
    run.state.update(ws=ws, truth=truth)
    warm = os.path.join(run.workdir, "warmup")
    _build(warm, p, frames[:2], run)
    run_patch_match_stereo(warm, _stereo_options(
        p, run.chips, num_iterations=1, num_refinement_iterations=0),
        device=run.device)
    shutil.rmtree(warm)
    run.state["solves"] = _Solves(run)


def window(run) -> None:
    from colmap_tpu_torch.controllers.dense_reconstruction import (
        run_patch_match_stereo)

    p = run.params
    solves = run.state["solves"]
    options = _stereo_options(p, run.chips)
    jobs, mpix, timings = 0, 0.0, {}
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    try:
        while True:
            solves.reset()
            solves.trace_at = p["trace_map"] if run.trace and jobs == 0 \
                else None
            depths = run_patch_match_stereo(run.state["ws"], options,
                                            device=run.device,
                                            timings=timings)
            for k in ("photometric", "geometric"):
                run.span(k, timings[k])
            run.tracer.sync()
            jobs += 1
            mpix += sum(d.size for d in depths.values()) / 1e6
            c = time.perf_counter()
            if c >= deadline:
                break
    finally:
        solves.remove()
    run.totals.update(window_s=c - t0, attempted=jobs, failed=0, mpix=mpix,
                      maps=len(depths))


def outputs(run) -> None:
    run.outputs["maps"] = run.state["solves"].maps(run.state["truth"])
    run.state["solves"].reset()
    if run.device != "cpu":
        torch.cuda.empty_cache()


def _control_maps(run):
    """The control: the program's own path with the cell's control
    options (`control_patch_match`), on the same workspace."""
    from colmap_tpu_torch.controllers.dense_reconstruction import (
        run_patch_match_stereo)

    p = run.params
    solves = _Solves(run)
    try:
        run_patch_match_stereo(run.state["ws"], _stereo_options(
            p, run.chips, **p["control_patch_match"]), device=run.device)
    finally:
        solves.remove()
    return solves.maps(run.state["truth"])


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
