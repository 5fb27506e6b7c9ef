"""Generalized (multi-camera rig) absolute and relative pose estimation.

Port of colmap_tpu/estimators/generalized_pose.py (reference:
estimators/generalized_absolute_pose.h GP3P, generalized_pose.h,
generalized_relative_pose.h GR6P). The JAX design, kept here:

  * absolute pose: per-camera P3P hypotheses lifted to the rig frame (a
    triple from camera c gives rig_from_world = inv(cam_from_rig_c) *
    cam_from_world_c; triples that mix cameras are masked invalid), scored
    against all observations of all rig cameras, with a Gauss-Newton
    refinement of the rig pose over all cameras as the LO step;
  * relative pose: same-camera 5-point essential hypotheses lifted to
    rig2_from_rig1, scored by the generalized epipolar (line-to-line)
    residual, refined by Gauss-Newton on that residual, whose cross-camera
    observations fix the metric scale.

The port runs the port's batched RANSAC (optim/ransac.py): the inputs may
carry a leading batch axis of independent problems (e.g. the snapshots of
a rig), and the draws come from a torch.Generator. The Gauss-Newton
Jacobians are per observation, from torch.func.vmap of torch.func.jacrev
(the JAX package takes them from forward-mode autodiff).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from colmap_tpu_torch.estimators import absolute_pose as ap
from colmap_tpu_torch.estimators import essential_matrix as em
from colmap_tpu_torch.estimators.utils import solve
from colmap_tpu_torch.geometry import essential as ess
from colmap_tpu_torch.geometry import rigid3, rotation as rot
from colmap_tpu_torch.optim.ransac import RansacOptions, ransac


class GeneralizedPoseResult(NamedTuple):
    rig_from_world: torch.Tensor  # (..., 7)
    num_inliers: torch.Tensor  # (...)
    inlier_mask: torch.Tensor  # (..., N)
    success: torch.Tensor  # (...)


def _rig_residuals(rig_pose, data):
    """Squared reprojection error in normalized coords per observation:
    rig_pose (..., 7) against data = (points3d (..., N, 3), uv (..., N, 2),
    cams_from_rig per observation (..., N, 7)) -> (..., N)."""
    points3d, uv, cams = data[:3]
    pc = rigid3.apply(cams, rigid3.apply(rig_pose[..., None, :], points3d))
    z = pc[..., 2]
    behind = z < 1e-6
    z_safe = torch.where(behind, torch.ones_like(z), z)
    r2 = torch.sum((pc[..., :2] / z_safe[..., None] - uv) ** 2, dim=-1)
    return torch.where(behind, torch.full_like(r2, 1e6), r2)


def _gn(pose, residual, data, num_iters: int, lm_lambda: float = 1e-4):
    """Damped Gauss-Newton on the SE3 tangent of poses (B, 7), `num_iters`
    steps, each kept only if it lowers the cost. residual(pose (7,),
    observation tensors...) is one observation's residual vector; `data`
    holds the (B, N, ...) observation tensors."""
    dt, dev = pose.dtype, pose.device
    eye = torch.eye(6, dtype=dt, device=dev)
    zero = torch.zeros(6, dtype=dt, device=dev)
    obs = (None,) + (0,) * len(data)
    res = torch.func.vmap(torch.func.vmap(residual, in_dims=obs))
    jac = torch.func.vmap(torch.func.vmap(
        lambda p, *a: torch.func.jacrev(
            lambda d: residual(rigid3.exp_update(p, d), *a))(zero),
        in_dims=obs))
    for _ in range(num_iters):
        r = res(pose, *data)
        B = r.shape[0]
        r = r.reshape(B, -1)
        J = jac(pose, *data).reshape(B, -1, 6)
        JtJ = J.transpose(-1, -2) @ J
        H = (JtJ + lm_lambda * torch.diag_embed(
            torch.diagonal(JtJ, dim1=-2, dim2=-1)) + 1e-8 * eye)
        delta = -solve(H, torch.einsum("bki,bk->bi", J, r)[..., None])[..., 0]
        new_pose = rigid3.exp_update(pose, delta)
        better = (torch.sum(res(new_pose, *data).reshape(B, -1) ** 2, -1)
                  < torch.sum(r ** 2, -1))
        pose = torch.where(better[:, None], new_pose, pose)
    return pose


def _reprojection(rig_pose, point, uv, cam, weight):
    """One observation's weighted residual (2,) in normalized coords."""
    pc = rigid3.apply(cam, rigid3.apply(rig_pose, point))
    z = torch.where(pc[..., 2] > 1e-6, pc[..., 2],
                    torch.full_like(pc[..., 2], 1e-6))
    return (pc[..., :2] / z[..., None] - uv) * weight[..., None]


def _batched(*tensors):
    """Add a leading batch axis when the first tensor has none."""
    if tensors[0].dim() == 2:
        return True, tuple(t[None] for t in tensors)
    return False, tensors


def _result(res, unbatched: bool) -> GeneralizedPoseResult:
    out = GeneralizedPoseResult(rig_from_world=res.model,
                                num_inliers=res.num_inliers,
                                inlier_mask=res.inlier_mask,
                                success=res.success)
    return GeneralizedPoseResult(*(t[0] for t in out)) if unbatched else out


def estimate_generalized_absolute_pose(
    generator: torch.Generator,
    points3d: torch.Tensor,  # (..., N, 3) world
    uv: torch.Tensor,  # (..., N, 2) normalized coords in the OBSERVING camera
    cam_idx: torch.Tensor,  # (..., N) int rig camera index per observation
    cams_from_rig: torch.Tensor,  # (C, 7)
    valid: torch.Tensor,  # (..., N) bool
    options: Optional[RansacOptions] = None,
) -> GeneralizedPoseResult:
    """RANSAC generalized absolute pose (rig registration) of one problem
    or of a batch of problems along the leading axis."""
    opts = options or RansacOptions(num_samples=1024, lo_iterations=2)
    unbatched, (points3d, uv, cam_idx, valid) = _batched(
        points3d, uv, cam_idx, valid)
    cam_idx = cam_idx.to(torch.int64)
    cams_per_obs = cams_from_rig[cam_idx]  # (B, N, 7)
    rigs_from_cams = rigid3.inverse(cams_from_rig)  # (C, 7)

    def solver(p3, uv3, cams3, camidx3):
        # P3P in the camera of the sample's first observation; triples that
        # mix cameras are masked invalid
        poses, ok = ap.solve_p3p(p3, uv3)  # (B, S, 4, 7)
        same_cam = ((camidx3[..., 0] == camidx3[..., 1])
                    & (camidx3[..., 0] == camidx3[..., 2]))
        rig_from_cam = rigs_from_cams[camidx3[..., 0]]
        return (rigid3.compose(rig_from_cam[..., None, :], poses),
                ok & same_cam[..., None])

    def refit(model, data, weights):
        p, u, c, _ = data
        new = _gn(model, _reprojection, (p, u, c, weights), num_iters=5)
        return new, torch.isfinite(new).all(-1)

    res = ransac(generator, solver, _rig_residuals, refit,
                 (points3d, uv, cams_per_obs, cam_idx), valid, 3, opts)
    return _result(res, unbatched)


def _h1(uv):
    return torch.cat([uv, torch.ones_like(uv[..., :1])], -1)


def _gen_epipolar(rig_pose, r1, r2, cfr1, cfr2):
    """Squared generalized epipolar error: the distance between the two
    observation rays in the rig-1 frame (their angular separation when
    they are near parallel). rig_pose (..., 7) is rig2_from_rig1 and
    broadcasts against the observations' (..., N, ...)."""
    def to_rig(cfr, d):  # x_rig = R^T (x_cam - t)
        return (rot.quat_rotate(rot.quat_conjugate(rigid3.quat(cfr)), d),
                rigid3.projection_center(cfr))

    d1r, o1 = to_rig(cfr1, _h1(r1))
    d2r, o2 = to_rig(cfr2, _h1(r2))
    inv_pose = rigid3.inverse(rig_pose)
    d2w = rot.quat_rotate(rigid3.quat(inv_pose), d2r)
    o2w = rigid3.apply(inv_pose, o2)
    cr = torch.linalg.cross(d1r, d2w, dim=-1)
    denom = torch.linalg.norm(cr, dim=-1)
    dist = (torch.abs(torch.sum((o2w - o1) * cr, -1))
            / torch.clamp(denom, min=1e-9))
    sep = denom / (torch.linalg.norm(d1r, dim=-1)
                   * torch.linalg.norm(d2w, dim=-1))
    r = torch.where(denom > 1e-6, dist, sep)
    return r * r


def estimate_generalized_relative_pose(
    generator: torch.Generator,
    rays1: torch.Tensor,  # (..., N, 2) normalized coords, rig position 1
    rays2: torch.Tensor,  # (..., N, 2) same feature seen from position 2
    cam_idx1: torch.Tensor,  # (..., N) rig camera index at position 1
    cam_idx2: torch.Tensor,  # (..., N) rig camera index at position 2
    cams_from_rig: torch.Tensor,  # (C, 7)
    valid: torch.Tensor,  # (..., N) bool
    options: Optional[RansacOptions] = None,
) -> GeneralizedPoseResult:
    """Relative pose rig2_from_rig1 between two rig positions, of one
    problem or a batch; `rig_from_world` of the result holds it."""
    opts = options or RansacOptions(num_samples=2048, lo_iterations=2)
    unbatched, (rays1, rays2, cam_idx1, cam_idx2, valid) = _batched(
        rays1, rays2, cam_idx1, cam_idx2, valid)
    rigs_from_cams = rigid3.inverse(cams_from_rig)
    cfr1 = cams_from_rig[cam_idx1.to(torch.int64)]  # (B, N, 7)
    cfr2 = cams_from_rig[cam_idx2.to(torch.int64)]
    ci1 = cam_idx1.to(torch.int64)
    ci2 = cam_idx2.to(torch.int64)

    def residual_fn(model, data):
        r1, r2, c1, c2 = data[:4]
        return _gen_epipolar(model[..., None, :], r1, r2, c1, c2)

    def solver(r1s, r2s, c1s, c2s, i1s, i2s):
        # 5-point essential on the sample, which must see one camera on
        # each side; cam2_from_cam1 lifts to rig2_from_rig1
        models, ok = em.solve_5pt(r1s, r2s)  # (B, S, 10, 3, 3)
        same = torch.all((i1s == i1s[..., :1]) & (i2s == i2s[..., :1]), -1)
        n = models.shape[-3]
        expand = (lambda t: t[..., None, :, :].expand(
            t.shape[:-2] + (n,) + t.shape[-2:]))
        pose, _, _ = ess.pose_from_essential_matrix(
            models, expand(r1s), expand(r2s))
        lifted = rigid3.compose(
            rigs_from_cams[i2s[..., 0]][..., None, :],
            rigid3.compose(pose, c1s[..., 0, None, :]))
        return lifted, ok & same[..., None]

    def refit(model, data, weights):
        r1, r2, c1, c2 = data[:4]

        def residual(p, a, b, ca, cb, w):
            return (torch.sqrt(_gen_epipolar(p, a, b, ca, cb) + 1e-12)
                    * w)[None]

        new = _gn(model, residual, (r1, r2, c1, c2, weights), num_iters=6)
        return new, torch.isfinite(new).all(-1)

    res = ransac(generator, solver, residual_fn, refit,
                 (rays1, rays2, cfr1, cfr2, ci1, ci2), valid, 5, opts)
    return _result(res, unbatched)
