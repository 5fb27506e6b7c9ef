"""Distributed bundle adjustment: pose-sharded LM over a device mesh.

Port of colmap_tpu/parallel/distributed_ba.py, pose-sharded regime. Each
shard owns a contiguous block of P_local = ceil(P / n) poses (the last
block padded with frozen identity poses) and exactly the observations of
those poses, with LOCAL pose indices; cameras and points are replicated.
Every shard runs the port's LM (estimators/bundle_adjustment.py) on its
block, one host thread per shard (parallel/mesh.run_shards): the
pose blocks (Hpp, gp, the SCHUR_JACOBI preconditioner, the CG pose
updates) stay on their shard, while the point and camera reductions, the
CG dot products and the cost are summed over the shards, in shard order on
the first shard's device, so every shard sees the same bits and takes the
same LM and CG branches.

The port solves BA with segment sums and no pose-major gather layouts, so
its shards need neither the JAX version's power-of-two observation padding
nor its layout widths: each shard's observation slice has its own length.
JAX's observation-sharded fallback (`shard_problem`) runs only when those
layouts would exceed their memory caps, which the port has no layouts to
reach, so it is not ported.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from colmap_tpu_torch.estimators import bundle_adjustment as ba
from colmap_tpu_torch.parallel.mesh import Mesh, make_mesh, run_shards


class PoseShards(NamedTuple):
    """A problem split by pose block (`shard_problem_by_pose`)."""

    shards: List[ba.BAProblem]  # one per shard, local pose indices
    P_local: int  # poses per shard
    obs_shard: torch.Tensor  # (N,) int64, each observation's shard
    obs_local_pose: torch.Tensor  # (N,) int64, its local pose index


def shard_problem_by_pose(problem: ba.BAProblem, n_shards: int) -> PoseShards:
    """JAX's pose partition: contiguous blocks of P_local = ceil(P / n)
    poses, padded to n * P_local with frozen identity poses; each
    observation goes to its pose's shard, in the caller's order, with a
    local pose index. Cameras and points are replicated into every shard.
    The shards stay on the problem's device."""
    poses, pose_mask = problem.poses, problem.pose_mask
    P = poses.shape[0]
    P_local = -(-P // n_shards)
    pad = n_shards * P_local - P
    if pad:
        ident = torch.zeros((pad, 7), dtype=poses.dtype, device=poses.device)
        ident[:, 0] = 1.0  # identity quaternion
        poses = torch.cat([poses, ident])
        pose_mask = torch.cat([pose_mask, torch.zeros(
            (pad, 6), dtype=pose_mask.dtype, device=pose_mask.device)])
    obs_shard = problem.obs_pose_idx // P_local
    obs_local = problem.obs_pose_idx % P_local
    shards = []
    for k in range(n_shards):
        sel = torch.nonzero(obs_shard == k).reshape(-1)
        blk = slice(k * P_local, (k + 1) * P_local)
        shards.append(problem._replace(
            poses=poses[blk], pose_mask=pose_mask[blk],
            obs_pose_idx=obs_local[sel], obs_cam_idx=problem.obs_cam_idx[sel],
            obs_point_idx=problem.obs_point_idx[sel],
            obs_xy=problem.obs_xy[sel], obs_weight=problem.obs_weight[sel]))
    return PoseShards(shards, P_local, obs_shard, obs_local)


def _to(problem: ba.BAProblem, device) -> ba.BAProblem:
    return ba.BAProblem(*(t.to(device) for t in problem))


def solve_distributed(problem: ba.BAProblem, options: ba.BAOptions,
                      mesh: Optional[Mesh] = None) -> ba.LMState:
    """Run LM sharded by pose over the mesh (default: one shard per local
    card on the problem's device type). Returns the state in the caller's
    terms, on the problem's device: the original pose count, the caller's
    observation arrays and masks (global indices, original order), and the
    first shard's counters (LM iterations, CG steps, host syncs: the same
    on every shard). One shard is `ba.solve`."""
    if mesh is None:
        mesh = make_mesh(device=problem.poses.device.type)
    if mesh.size == 1:
        return ba.solve(problem, options)
    P = problem.poses.shape[0]
    parts = shard_problem_by_pose(problem, mesh.size)

    def shard(group):
        p = _to(parts.shards[group.rank], group.device)
        return ba.run_lm(ba.init_state(p, options, group), options, group)

    states = run_shards(mesh, shard)
    home = problem.poses.device
    first = states[0]
    poses = torch.cat([s.problem.poses.to(home) for s in states])[:P]
    return first._replace(
        problem=problem._replace(
            poses=poses, cam_params=first.problem.cam_params.to(home),
            points=first.problem.points.to(home)),
        lam=first.lam.to(home), cost=first.cost.to(home),
        rel_change=first.rel_change.to(home))
