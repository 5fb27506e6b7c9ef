"""Position-prior-constrained bundle adjustment.

Port of colmap_tpu/estimators/pose_prior_ba.py (reference:
estimators/bundle_adjustment.h:260 PosePriorBundleAdjuster): per-image
position-prior residuals (the PositionPriorError cost functor,
estimators/cost_functions.h) keep the model registered to the prior frame
(GPS / ENU) during BA. Two residual groups over poses and points:
reprojection, and projection centres against their priors, weighted
1 / sigma per axis and robustified by a Cauchy loss of scale
`prior_loss_scale`.

The JAX solver is a matrix-free LM whose CG takes J v from jvp; the port
runs the same iteration through optim/matrix_free_lm.py with the Jacobian
as per-row blocks from torch.func.vmap of torch.func.jacrev: 2x9 per
reprojection (pose 6, point 3) and 3x6 per prior. CG stays
unpreconditioned, as in JAX: the block Jacobi inverse that the rig
adjuster uses slows the whole-model moves that only the priors drive
(tests/test_torch_prior_ba.py's shifted model stays 0.15 off with it).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from colmap_tpu_torch.geometry import rigid3
from colmap_tpu_torch.optim import matrix_free_lm as mflm
from colmap_tpu_torch.sensor import models as camera_models


class PriorBAProblem(NamedTuple):
    poses: torch.Tensor  # (P, 7) cam_from_world
    cam_params: torch.Tensor  # (C, 12)
    points: torch.Tensor  # (M, 3)
    obs_pose_idx: torch.Tensor  # (N,) int64
    obs_cam_idx: torch.Tensor  # (N,) int64
    obs_point_idx: torch.Tensor  # (N,) int64
    obs_xy: torch.Tensor  # (N, 2)
    obs_weight: torch.Tensor  # (N,)
    prior_positions: torch.Tensor  # (P, 3) projection-centre priors (world)
    prior_weight: torch.Tensor  # (P, 3) 1/sigma per axis; 0 = no prior
    pose_mask: torch.Tensor  # (P, 6)
    point_mask: torch.Tensor  # (M, 3)


@dataclasses.dataclass(frozen=True)
class PriorBAOptions:
    max_iterations: int = 30
    cg_iterations: int = 40
    initial_lambda: float = 1e-4
    camera_model_id: int = int(camera_models.CameraModelId.SIMPLE_PINHOLE)
    prior_loss_scale: float = 1.0  # Cauchy scale on prior residuals (units)


def _obs_reproj(pose, cam_params, point, xy, weight, model_id: int):
    pc = rigid3.apply(pose, point)
    z = pc[..., 2]
    z_safe = torch.where(torch.abs(z) > 1e-8, z, torch.full_like(z, 1e-8))
    uv = pc[..., :2] / z_safe[..., None]
    proj = camera_models.img_from_cam(model_id, cam_params, uv)
    r = (proj - xy) * weight[..., None]
    return torch.where((z > 1e-8)[..., None], r,
                       1e2 * weight[..., None].expand(r.shape))


def _reproj_residuals(problem: PriorBAProblem, poses, points, model_id: int):
    """(N, 2) weighted reprojection residuals."""
    return _obs_reproj(poses[problem.obs_pose_idx],
                       problem.cam_params[problem.obs_cam_idx],
                       points[problem.obs_point_idx], problem.obs_xy,
                       problem.obs_weight, model_id)


def _prior_residual(pose, prior_position, prior_weight, scale: float):
    r = (rigid3.projection_center(pose) - prior_position) * prior_weight
    r2 = torch.sum(r * r, -1, keepdim=True)
    return r * torch.rsqrt(1.0 + r2 / (scale * scale))


def _prior_residuals(problem: PriorBAProblem, poses, scale: float):
    """(P, 3) Cauchy-weighted projection-centre residuals."""
    return _prior_residual(poses, problem.prior_positions,
                           problem.prior_weight, scale)


def solve_prior_ba(problem: PriorBAProblem,
                   options: PriorBAOptions = PriorBAOptions(),
                   stats: Optional[dict] = None):
    """Run LM on the problem's device; returns (the problem with updated
    poses and points, the final cost). A dict `stats` receives the LM
    iterations, the CG steps taken and the host syncs."""
    model_id = options.camera_model_id
    scale = options.prior_loss_scale
    pi, mi = problem.obs_pose_idx, problem.obs_point_idx
    P = problem.poses.shape[0]
    all_poses = torch.arange(P, device=pi.device)
    dt, dev = problem.points.dtype, problem.points.device
    z6 = torch.zeros(6, dtype=dt, device=dev)
    z3 = torch.zeros(3, dtype=dt, device=dev)

    def residuals(params):
        poses, pts = params
        return [_reproj_residuals(problem, poses, pts, model_id),
                _prior_residuals(problem, poses, scale)]

    def reproj(d_pose, d_pt, pose, params, X, xy, w):
        return _obs_reproj(rigid3.exp_update(pose, d_pose), params, X + d_pt,
                           xy, w, model_id)

    def prior(d_pose, pose, pos, w):
        return _prior_residual(rigid3.exp_update(pose, d_pose), pos, w, scale)

    def jacobian(params):
        poses, pts = params
        Jp, Jx = torch.func.vmap(
            lambda *a: torch.func.jacrev(reproj, argnums=(0, 1))(z6, z3, *a))(
                poses[pi], problem.cam_params[problem.obs_cam_idx], pts[mi],
                problem.obs_xy, problem.obs_weight)
        Jq = torch.func.vmap(
            lambda *a: torch.func.jacrev(prior)(z6, *a))(
                poses, problem.prior_positions, problem.prior_weight)
        return [
            mflm.Term(Jp * problem.pose_mask[pi][:, None, :], pi, 0, 0),
            mflm.Term(Jx * problem.point_mask[mi][:, None, :], mi, 1, 0),
            mflm.Term(Jq * problem.pose_mask[:, None, :], all_poses, 0, 1),
        ]

    def retract(params, delta):
        poses, pts = params
        return (rigid3.exp_update(poses, delta[0] * problem.pose_mask),
                pts + delta[1] * problem.point_mask)

    res = mflm.solve((problem.poses, problem.points), residuals, jacobian,
                     retract, [problem.pose_mask.shape,
                               problem.point_mask.shape],
                     options.max_iterations, options.cg_iterations,
                     options.initial_lambda)
    if stats is not None:
        stats.update(lm_iterations=res.lm_iterations,
                     cg_steps=int(res.cg_steps), syncs=res.syncs)
    poses, pts = res.params
    return problem._replace(poses=poses, points=pts), res.cost


def problem_from_numpy(fields: dict, device) -> PriorBAProblem:
    """The port's PriorBAProblem from a JAX PriorBAProblem's fields as
    numpy arrays (e.g. `{k: np.asarray(v) for k, v in p._asdict().items()}`)."""
    return PriorBAProblem(**{
        name: torch.as_tensor(np.array(fields[name]), device=device).to(
            torch.int64 if name.startswith("obs_") and name.endswith("_idx")
            else torch.float32)
        for name in PriorBAProblem._fields})


def refine_with_priors(rec, priors: dict, sigma: float = 1.0,
                       options: Optional[PriorBAOptions] = None,
                       device="cuda", stats: Optional[dict] = None):
    """Run prior-constrained BA on a Reconstruction in place on `device`.

    priors: image_id -> 3-vector position (world / ENU frame of the model).
    Every pose is free: the priors fix the gauge (reference:
    PosePriorBundleAdjuster::Solve)."""
    reg = rec.registered_image_ids()
    if len(reg) < 2 or not rec.points3D:
        return rec
    img_index = {iid: k for k, iid in enumerate(reg)}
    pids = sorted(rec.points3D.keys())
    pid_index = {pid: k for k, pid in enumerate(pids)}
    cams = sorted(rec.cameras.keys())
    cam_index = {cid: k for k, cid in enumerate(cams)}
    obs_pose, obs_cam, obs_pt, obs_xy = [], [], [], []
    for pid in pids:
        for (iid, f) in rec.points3D[pid].track:
            if iid not in img_index:
                continue
            obs_pose.append(img_index[iid])
            obs_cam.append(cam_index[rec.images[iid].camera_id])
            obs_pt.append(pid_index[pid])
            obs_xy.append(rec.images[iid].xys[f])

    prior_pos = np.zeros((len(reg), 3), np.float32)
    prior_w = np.zeros((len(reg), 3), np.float32)
    for iid, pos in priors.items():
        if iid in img_index:
            prior_pos[img_index[iid]] = np.asarray(pos, np.float32)
            prior_w[img_index[iid]] = 1.0 / sigma

    model_id = rec.cameras[cams[0]].model_id
    opts = options or PriorBAOptions(camera_model_id=int(model_id))
    problem = problem_from_numpy(dict(
        poses=np.stack([rec.images[i].cam_from_world for i in reg]),
        cam_params=np.stack([rec.cameras[c].padded_params() for c in cams]),
        points=np.stack([rec.points3D[p].xyz for p in pids]),
        obs_pose_idx=np.array(obs_pose), obs_cam_idx=np.array(obs_cam),
        obs_point_idx=np.array(obs_pt), obs_xy=np.stack(obs_xy),
        obs_weight=np.ones(len(obs_xy), np.float32),
        prior_positions=prior_pos, prior_weight=prior_w,
        pose_mask=np.ones((len(reg), 6), np.float32),
        point_mask=np.ones((len(pids), 3), np.float32)), device)
    solved, _ = solve_prior_ba(problem, opts, stats=stats)
    new_poses = solved.poses.cpu().numpy().astype(np.float64)
    new_points = solved.points.cpu().numpy().astype(np.float64)
    for iid, k in img_index.items():
        rec.images[iid].cam_from_world = new_poses[k]
    for pid, k in pid_index.items():
        rec.points3D[pid].xyz = new_points[k]
    return rec
