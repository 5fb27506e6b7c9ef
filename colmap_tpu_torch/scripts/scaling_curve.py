"""Relative device-scaling curve for the distributed product paths.

Port of the JAX package's scripts/scaling_curve.py. Measures BA LM
iterations/s (the pose-sharded distributed solver) and matcher pairs/s
(the pair axis sharded over the mesh) at mesh sizes 1/2/4/8, on the JAX
script's problems: a BA of 96 poses / 8000 points / 48000 observations
(the JAX bench's `_build_problem` draws, here `bench_ba.build_problem`),
5 LM x 15 CG with no early exit, and 16 pairs of 1024 x 1024 random
descriptors.

    python -m colmap_tpu_torch.scripts.scaling_curve [--device cuda] \\
        [--out scaling.json]

On `cuda` a mesh holds at most one shard per card (`make_mesh`), so the
sizes above the card count are cut, and the report says so under
`mesh_sizes`; on `cpu` a mesh of n shards is n threads on the host, as
JAX's virtual CPU mesh is n host-platform devices. Each curve point also
holds the final BA cost (every size solves the same problem), the share of
the step's wall time its shards spent inside collectives (host clock,
waiting for the other shards included; the matcher has no collective: the
host gathers its rows), and on a card the matcher kernel's launches per
shard thread. Writes the report to --out and prints it as the last line.
"""

import argparse
import datetime
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from colmap_tpu_torch import scripts
from colmap_tpu_torch.bench_ba import build_problem
from colmap_tpu_torch.estimators import bundle_adjustment as ba
from colmap_tpu_torch.features import hopper_matcher
from colmap_tpu_torch.parallel import distributed_ba
from colmap_tpu_torch.parallel import mesh as mesh_mod
from colmap_tpu_torch.parallel import sharded_matching as sm

MESH_SIZES = (1, 2, 4, 8)
# the JAX script's problems: _build_problem(96, 8000, 6, seed=7) and
# 16 pairs of 1024 descriptors (rng seed 0)
BA_PROBLEM = dict(num_poses=96, num_points=8000, obs_per_point=6, seed=7)
MATCHER_PAIRS, MATCHER_N = 16, 1024
REPS = 3


class _TimedGroup:
    """A shard's group whose collectives add their host seconds (waiting
    for the other shards included) to `seconds`."""

    def __init__(self, group):
        self._group = group
        self.seconds = 0.0

    def __getattr__(self, name):
        return getattr(self._group, name)

    def _timed(self, collective, x):
        t0 = time.perf_counter()
        try:
            return collective(x)
        finally:
            self.seconds += time.perf_counter() - t0

    def all_reduce_sum(self, x):
        return self._timed(self._group.all_reduce_sum, x)

    def all_gather(self, x):
        return self._timed(self._group.all_gather, x)


def solve_timed(problem, options, mesh):
    """`distributed_ba.solve_distributed`'s LM on `mesh`, one shard each
    (one shard: `ba.solve`): (final cost, the shards' mean host seconds
    inside collectives)."""
    if mesh.size == 1:
        return float(ba.solve(problem, options).cost), 0.0
    parts = distributed_ba.shard_problem_by_pose(problem, mesh.size)

    def shard(group):
        timed = _TimedGroup(group)
        p = ba.BAProblem(*(t.to(group.device)
                           for t in parts.shards[group.rank]))
        state = ba.run_lm(ba.init_state(p, options, timed), options, timed)
        return float(state.cost), timed.seconds

    out = mesh_mod.run_shards(mesh, shard)
    return out[0][0], float(np.mean([sec for _, sec in out]))


def bench_ba_at(mesh, problem, options, reps: int) -> dict:
    """LM iterations/s of `options.max_iterations` fixed iterations on
    `mesh` (median of `reps` after a warm-up), the final cost and the
    collectives' share of the step."""
    solve_timed(problem, options, mesh)  # warm
    ts, shares = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        cost, collective_s = solve_timed(problem, options, mesh)
        ts.append(time.perf_counter() - t0)
        shares.append(collective_s / ts[-1])
    dt = float(np.median(ts))
    return {"iters_per_s": options.max_iterations / dt, "cost": cost,
            "collective_share": float(np.median(shares))}


def bench_matcher_at(mesh, d1, d2, v1, v2, reps: int) -> dict:
    """Pairs/s of the sharded matcher on `mesh` (median of `reps` after a
    warm-up), its matches and its kernel launches per shard thread."""
    B = d1.shape[0]
    hopper_matcher.launches_by_thread.clear()
    out = sm.match_pair_blocks_sharded(mesh, d1, d2, v1, v2)  # warm
    if out.shape[0] != B:
        raise RuntimeError(f"the sharded matcher returned {out.shape[0]} "
                           f"rows for {B} pairs")
    launches = [hopper_matcher.launches_by_thread.get(f"shard-{k}", 0)
                for k in range(mesh.size)]
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sm.match_pair_blocks_sharded(mesh, d1, d2, v1, v2)
        ts.append(time.perf_counter() - t0)
    return {"pairs_per_s": B / float(np.median(ts)), "matches": out,
            "launches_per_shard": launches}


def mesh_sizes(device, sizes):
    """(meshes that ran, {size: why it was cut}): on a card a size above
    the card count is cut, never shrunk in silence."""
    ran, cut = [], {}
    for n in sizes:
        mesh = mesh_mod.make_mesh(n, device)
        if mesh.size == n:
            ran.append(mesh)
        else:
            cut[str(n)] = (f"{torch.cuda.device_count()} card(s) present: "
                           f"make_mesh({n}) holds {mesh.size} shard(s)")
    return ran, cut


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "colmap_tpu_torch_scaling.json"))
    scripts.add_device_argument(p)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    device_keys = scripts.open_device(args.device)
    meshes, cut = mesh_sizes(args.device, MESH_SIZES)

    problem, _ = build_problem(device=args.device, **BA_PROBLEM)
    options = ba.BAOptions(max_iterations=5, cg_iterations=15,
                           function_tolerance=0.0, cg_tolerance=0.0,
                           refine_intrinsics=False)
    n_obs = int(problem.obs_xy.shape[0])
    flops_per_lm = options.cg_iterations * 2 * (2 * n_obs * 2 * (6 + 3 + 4))

    rng = np.random.default_rng(0)
    B, N = MATCHER_PAIRS, MATCHER_N
    d1 = rng.integers(0, 255, (B, N, 128)).astype(np.uint8)
    d2 = rng.integers(0, 255, (B, N, 128)).astype(np.uint8)
    v1 = np.ones((B, N), bool)
    v2 = np.ones((B, N), bool)

    on_card = torch.device(args.device).type == "cuda"
    report = {
        "self_reported": True,
        "produced_by": scripts.command_line(
            "colmap_tpu_torch.scripts.scaling_curve", argv),
        "timestamp_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "host_physical_cores": os.cpu_count(),
        "note": ("one shard per card: the sizes above the card count are "
                 "cut (mesh_sizes)" if on_card else
                 "CPU mesh: n shards are n host threads sharing the host's "
                 "cores, so the curve holds the distributed programs and "
                 "their collective overhead, not a device speedup"),
        "mesh_sizes": {"ran": [m.size for m in meshes], "cut": cut},
        "ba": {"problem": f"{problem.poses.shape[0]} poses / "
                          f"{problem.points.shape[0]} points / {n_obs} obs",
               "unit": "LM iters/s (fixed 5 LM x 15 CG)",
               "curve": {}},
        "matcher": {"problem": f"{B} pairs x {N}^2 descriptors",
                    "unit": "pairs/s",
                    "curve": {}},
    }
    report.update(device_keys)

    base_ba = None
    for mesh in meshes:
        n = mesh.size
        r = bench_ba_at(mesh, problem, options, REPS)
        base_ba = base_ba or r["iters_per_s"]
        report["ba"]["curve"][str(n)] = {
            "iters_per_s": round(r["iters_per_s"], 3),
            "rel_vs_1dev": round(r["iters_per_s"] / base_ba, 3),
            "flops_per_device_per_iter": int(flops_per_lm / n),
            "cost": r["cost"],
            "collective_share": r["collective_share"],
        }
        print(f"ba n={n}: {r['iters_per_s']:.3f} iters/s, cost "
              f"{r['cost']:.6f}, collectives {r['collective_share']:.3f} "
              "of the step", flush=True)

    base_m = None
    for mesh in meshes:
        n = mesh.size
        r = bench_matcher_at(mesh, d1, d2, v1, v2, REPS)
        base_m = base_m or r["pairs_per_s"]
        report["matcher"]["curve"][str(n)] = {
            "pairs_per_s": round(r["pairs_per_s"], 2),
            "rel_vs_1dev": round(r["pairs_per_s"] / base_m, 3),
            "collective_share": 0.0,
        }
        if on_card:
            report["matcher"]["curve"][str(n)]["k1_launches_per_shard"] = \
                r["launches_per_shard"]
        print(f"matcher n={n}: {r['pairs_per_s']:.2f} pairs/s", flush=True)
    report.update(scripts.peak_memory(args.device))

    with open(args.out, "w") as fp:
        json.dump(report, fp, indent=2)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
