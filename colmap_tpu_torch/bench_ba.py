"""Time the port's bundle adjustment on one GPU.

    python -m colmap_tpu_torch.bench_ba [--poses 500 --points 50000 ...]

Builds the synthetic problem of the JAX package's bench (bench.py:74-90,
__graft_entry__._build_problem: poses on a circle, each point seen by
`obs_per_point` consecutive cameras, SIMPLE_RADIAL, noisy start) with the
same numpy draws, then runs the fixed-cost solve the bench runs
(max_iterations=10, cg_iterations=20, function_tolerance=0,
cg_tolerance=0: no early exit, so no host synchronization), one warm-up and
`--reps` timed solves, and one solve under torch.profiler. Prints one JSON
line: LM iterations/s, the solve's seconds, its cost before and after, the
least time the CG's Jacobian reads could take, and, from the profiled
solve, its wall and kernel milliseconds and its top five kernels.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from colmap_tpu_torch.estimators import bundle_adjustment as ba
from colmap_tpu_torch.geometry import rigid3, rotation as rot
from colmap_tpu_torch.sensor import models as cm

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published, at a 700 W power limit


def build_problem(num_poses=64, num_points=2048, obs_per_point=4, seed=0,
                  device="cuda"):
    """The JAX package's __graft_entry__._build_problem on the port: the
    same numpy draws, so the same problem for the same arguments. Returns
    (problem, options) with options for one LM iteration of 20 CG steps."""
    rng = np.random.default_rng(seed)
    model_id = int(cm.CameraModelId.SIMPLE_RADIAL)
    params = cm.pad_params([1000.0, 512.0, 384.0, 0.01])
    points = rng.uniform(-1, 1, (num_points, 3)).astype(np.float32)

    rots = []
    centers = []
    for i in range(num_poses):
        ang = 2 * np.pi * i / num_poses
        center = np.array([4 * np.cos(ang), 0.3 * np.sin(3 * ang),
                           4 * np.sin(ang)])
        z = -center / np.linalg.norm(center)
        up = np.array([0.0, -1.0, 0.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        rots.append(np.stack([x, y, z], axis=1).T)
        centers.append(center)
    R = torch.as_tensor(np.stack(rots), dtype=torch.float32)
    t = -np.einsum("pij,pj->pi", np.stack(rots), np.stack(centers))
    poses = torch.cat([rot.rotmat_to_quat(R),
                       torch.as_tensor(t, dtype=torch.float32)], 1)

    # each point observed by `obs_per_point` consecutive cameras
    obs_pose, obs_pt = [], []
    for m in range(num_points):
        start = rng.integers(0, num_poses)
        for k in range(obs_per_point):
            obs_pose.append((start + k) % num_poses)
            obs_pt.append(m)
    obs_pose = np.array(obs_pose, np.int64)
    obs_pt = np.array(obs_pt, np.int64)

    pc = rigid3.apply(poses[obs_pose], torch.as_tensor(points)[obs_pt])
    z_ok = (pc[:, 2] > 0.2).numpy()
    uv = pc[:, :2] / torch.clamp(pc[:, 2:], min=0.2)
    xy = cm.img_from_cam(model_id, torch.as_tensor(params), uv).numpy()

    noisy_poses = rigid3.exp_update(poses, torch.as_tensor(
        rng.normal(0, 0.005, (num_poses, 6)).astype(np.float32))).numpy()
    noisy_points = points + rng.normal(0, 0.01, points.shape).astype(
        np.float32)
    problem = ba.make_problem(
        noisy_poses, params[None], noisy_points, obs_pose,
        np.zeros_like(obs_pose), obs_pt, xy.astype(np.float32),
        obs_weight=z_ok.astype(np.float32), fix_first_pose_and_gauge=True,
        device=device)
    options = ba.BAOptions(max_iterations=1, cg_iterations=20,
                           camera_model_id=model_id)
    return problem, options


def cg_bytes_bound_ms(problem: ba.BAProblem, options: ba.BAOptions) -> float:
    """Least ms for one solve's CG: every Schur matvec reads each
    observation's weighted Jacobian blocks (2 x (6 + 3), + 12 with
    intrinsics, f32) at least once, at the HBM rate."""
    per_obs = 2 * (9 + (12 if options.refine_intrinsics else 0)) * 4
    n = problem.obs_xy.shape[0]
    matvecs = options.max_iterations * options.cg_iterations
    return matvecs * n * per_obs / HBM_BYTES_PER_S * 1e3


def time_solves(problem, options, reps: int):
    """Seconds of `reps` solves after one warm-up (host clock around work
    that ends in a synchronize)."""
    ba.solve(problem, options)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state = ba.solve(problem, options)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out, state


def top_device_ops(fn, k: int = 5):
    """Profile one call of fn under torch.profiler. Returns ([(kernel name,
    device ms, launches)] of the k kernels with the most device time, the
    device ms of all kernels, the call's wall ms, the number of kernel
    launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only: the host ops that launched them carry the
    # same time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    kernels.sort(key=lambda e: -dev_us(e))
    total = sum(dev_us(e) for e in kernels) / 1e3
    return ([(e.key, dev_us(e) / 1e3, e.count) for e in kernels[:k]], total,
            wall_ms, sum(e.count for e in kernels))


def run(num_poses=500, num_points=50_000, obs_per_point=6, seed=7, reps=3,
        device="cuda"):
    """The JAX bench's BA cell on the port; returns a dict of results."""
    problem, _ = build_problem(num_poses, num_points, obs_per_point, seed,
                               device)
    options = ba.BAOptions(max_iterations=10, cg_iterations=20,
                           function_tolerance=0.0, cg_tolerance=0.0,
                           refine_intrinsics=False)
    cost0 = float(ba.compute_cost(problem, options))
    secs, state = time_solves(problem, options, reps)
    ops, dev_ms, wall_ms, _ = top_device_ops(
        lambda: ba.solve(problem, options))
    best = min(secs)
    return dict(
        poses=num_poses, points=num_points,
        observations=int(problem.obs_xy.shape[0]),
        lm_iterations=state.iteration, cg_steps=state.cg_steps,
        syncs=state.syncs, solve_s=secs, lm_iters_per_s=state.iteration / best,
        cost_before=cost0, cost_after=float(state.cost),
        cg_bytes_bound_ms=cg_bytes_bound_ms(problem, options),
        profiled_device_ms=dev_ms, profiled_wall_ms=wall_ms,
        top_device_ops=[dict(name=n, ms=ms, calls=c) for n, ms, c in ops])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--poses", type=int, default=500)
    ap.add_argument("--points", type=int, default=50_000)
    ap.add_argument("--obs-per-point", type=int, default=6)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_ba needs a CUDA device")
    out = run(args.poses, args.points, args.obs_per_point, args.seed,
              args.reps)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
