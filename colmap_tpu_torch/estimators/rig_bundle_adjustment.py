"""Rig-constrained bundle adjustment.

Port of colmap_tpu/estimators/rig_bundle_adjustment.py (reference:
estimators/bundle_adjustment.h:201 RigBundleAdjuster): the images of a rig
snapshot share one rig pose, and each camera has its rig extrinsics, so
cam_from_world = cam_from_rig * rig_from_world.

The JAX solver is a matrix-free Levenberg-Marquardt over the stacked blocks
(snapshot rig poses, cam_from_rig extrinsics, points) whose CG takes J v
from jvp. The port runs the same iteration (30 LM iterations, CG to 1e-5
relative, lambda x 0.3 / x 5) through optim/matrix_free_lm.py: each LM
iteration forms one 2x15 Jacobian per observation (rig pose 6,
cam_from_rig 6, point 3) with torch.func.vmap of torch.func.jacrev, and CG
applies J and J^T as gathers, batched matvecs and segment sums, with no
host read in either loop. JAX's CG has no preconditioner and converges
slowly: on an 80-image rig capture (33k observations) 30 x 30 of its steps
leave 0.730 px RMS where the noise floor is ~0.61 px. The port
preconditions CG by the block Jacobi inverse (6x6 per rig pose and
camera, 3x3 per point; 0.619 px there) unless `block_jacobi=False`,
which the parity tests run.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from colmap_tpu_torch.geometry import rigid3
from colmap_tpu_torch.optim import matrix_free_lm as mflm
from colmap_tpu_torch.sensor import models as camera_models


class RigBAProblem(NamedTuple):
    rig_poses: torch.Tensor  # (S, 7) rig_from_world per snapshot
    cams_from_rig: torch.Tensor  # (C, 7)
    cam_params: torch.Tensor  # (C, 12)
    points: torch.Tensor  # (M, 3)
    obs_snapshot_idx: torch.Tensor  # (N,) int64
    obs_rigcam_idx: torch.Tensor  # (N,) int64
    obs_point_idx: torch.Tensor  # (N,) int64
    obs_xy: torch.Tensor  # (N, 2)
    obs_weight: torch.Tensor  # (N,)
    rig_pose_mask: torch.Tensor  # (S, 6)
    rig_cam_mask: torch.Tensor  # (C, 6)
    point_mask: torch.Tensor  # (M, 3)


@dataclasses.dataclass(frozen=True)
class RigBAOptions:
    max_iterations: int = 30
    cg_iterations: int = 30
    initial_lambda: float = 1e-4
    camera_model_id: int = int(camera_models.CameraModelId.SIMPLE_PINHOLE)
    refine_relative_poses: bool = True  # reference RigBundleAdjuster option
    # precondition CG by the block Jacobi inverse; False is the JAX
    # package's unpreconditioned CG, which stalls at real sizes (PERF.md)
    block_jacobi: bool = True


def _obs_residual(rig_pose, cam_from_rig, cam_params, point, xy, weight,
                  model_id: int):
    """Weighted reprojection residuals (..., 2); observations behind the
    camera get the constant 1e2 * weight."""
    pc = rigid3.apply(rigid3.compose(cam_from_rig, rig_pose), point)
    z = pc[..., 2]
    z_safe = torch.where(torch.abs(z) > 1e-8, z, torch.full_like(z, 1e-8))
    uv = pc[..., :2] / z_safe[..., None]
    proj = camera_models.img_from_cam(model_id, cam_params, uv)
    r = (proj - xy) * weight[..., None]
    return torch.where((z > 1e-8)[..., None], r,
                       1e2 * weight[..., None].expand(r.shape))


def _residuals(problem: RigBAProblem, rig_poses, cams_from_rig, points,
               model_id: int) -> torch.Tensor:
    """(N, 2) residuals of every observation at the given parameters."""
    return _obs_residual(rig_poses[problem.obs_snapshot_idx],
                         cams_from_rig[problem.obs_rigcam_idx],
                         problem.cam_params[problem.obs_rigcam_idx],
                         points[problem.obs_point_idx], problem.obs_xy,
                         problem.obs_weight, model_id)


def _jacobian_terms(problem: RigBAProblem, rig_poses, cams_from_rig, points,
                    cam_mask, model_id: int):
    """The per-observation 2x6, 2x6 and 2x3 Jacobian blocks, masked."""
    s, c, m = (problem.obs_snapshot_idx, problem.obs_rigcam_idx,
               problem.obs_point_idx)
    dt, dev = points.dtype, points.device
    z6 = torch.zeros(6, dtype=dt, device=dev)
    z3 = torch.zeros(3, dtype=dt, device=dev)

    def single(d_rig, d_cam, d_pt, rig, cam, params, X, xy, w):
        return _obs_residual(rigid3.exp_update(rig, d_rig),
                             rigid3.exp_update(cam, d_cam), params, X + d_pt,
                             xy, w, model_id)

    J_rig, J_cam, J_pt = torch.func.vmap(
        lambda *a: torch.func.jacrev(single, argnums=(0, 1, 2))(
            z6, z6, z3, *a))(rig_poses[s], cams_from_rig[c],
                             problem.cam_params[c], points[m],
                             problem.obs_xy, problem.obs_weight)
    return [
        mflm.Term(J_rig * problem.rig_pose_mask[s][:, None, :], s, 0, 0),
        mflm.Term(J_cam * cam_mask[c][:, None, :], c, 1, 0),
        mflm.Term(J_pt * problem.point_mask[m][:, None, :], m, 2, 0),
    ]


def solve_rig(problem: RigBAProblem, options: RigBAOptions = RigBAOptions(),
              stats: Optional[dict] = None):
    """Run LM on the problem's device; returns (the problem with updated
    rig poses, extrinsics and points, the final cost). A dict `stats`
    receives the LM iterations, the CG steps taken and the host syncs."""
    model_id = options.camera_model_id
    cam_mask = problem.rig_cam_mask
    if not options.refine_relative_poses:
        cam_mask = torch.zeros_like(cam_mask)
    masks = (problem.rig_pose_mask, cam_mask, problem.point_mask)

    def residuals(params):
        return [_residuals(problem, *params, model_id)]

    def jacobian(params):
        return _jacobian_terms(problem, *params, cam_mask, model_id)

    def retract(params, delta):
        rig, cams, pts = params
        d_rig, d_cam, d_pt = (d * mk for d, mk in zip(delta, masks))
        return (rigid3.exp_update(rig, d_rig), rigid3.exp_update(cams, d_cam),
                pts + d_pt)

    params0 = (problem.rig_poses, problem.cams_from_rig, problem.points)
    res = mflm.solve(params0, residuals, jacobian, retract,
                     [m.shape for m in masks], options.max_iterations,
                     options.cg_iterations, options.initial_lambda,
                     options.block_jacobi)
    if stats is not None:
        stats.update(lm_iterations=res.lm_iterations,
                     cg_steps=int(res.cg_steps), syncs=res.syncs)
    rig, cams, pts = res.params
    return problem._replace(rig_poses=rig, cams_from_rig=cams,
                            points=pts), res.cost


def problem_from_numpy(fields: dict, device) -> RigBAProblem:
    """The port's RigBAProblem from a JAX RigBAProblem's fields as numpy
    arrays (e.g. `{k: np.asarray(v) for k, v in p._asdict().items()}`)."""
    return RigBAProblem(**{
        name: torch.as_tensor(np.array(fields[name]), device=device).to(
            torch.int64 if name.startswith("obs_") and name.endswith("_idx")
            else torch.float32)
        for name in RigBAProblem._fields})


def make_rig_problem(rig_poses, cams_from_rig, cam_params, points,
                     obs_snapshot_idx, obs_rigcam_idx, obs_point_idx,
                     obs_xy, obs_weight=None, fix_first_snapshot: bool = True,
                     device="cuda") -> RigBAProblem:
    """A float32 RigBAProblem on `device` from numpy arrays. The gauge: the
    first snapshot's rig pose (when `fix_first_snapshot`) and the
    reference camera's extrinsics (rig camera 0) stay fixed."""
    S, C, M = len(rig_poses), len(cams_from_rig), len(points)
    if obs_weight is None:
        obs_weight = np.ones(len(obs_xy), np.float32)
    rig_pose_mask = np.ones((S, 6), np.float32)
    if fix_first_snapshot:
        rig_pose_mask[0] = 0.0
    rig_cam_mask = np.ones((C, 6), np.float32)
    rig_cam_mask[0] = 0.0
    return problem_from_numpy(dict(
        rig_poses=rig_poses, cams_from_rig=cams_from_rig,
        cam_params=cam_params, points=points,
        obs_snapshot_idx=obs_snapshot_idx, obs_rigcam_idx=obs_rigcam_idx,
        obs_point_idx=obs_point_idx, obs_xy=obs_xy, obs_weight=obs_weight,
        rig_pose_mask=rig_pose_mask, rig_cam_mask=rig_cam_mask,
        point_mask=np.ones((M, 3), np.float32)), device)
