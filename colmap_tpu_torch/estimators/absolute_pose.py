"""Absolute (calibrated) camera pose: P3P, EPnP and Gauss-Newton
refinement, batched over leading axes.

Port of colmap_tpu/estimators/absolute_pose.py (reference:
estimators/absolute_pose.h:34, estimators/pose.h:156). Grunert's
resultant-based P3P assembles its quartic coefficients elementwise, so
thousands of P3P problems solve at once; the pose refinement is a fixed
number of damped Gauss-Newton steps on the SE3 tangent whose Jacobians come
from reverse-mode autodiff of one observation's residual (torch.func.jacrev,
vmapped over the observations and the problems).
Where the JAX functions take one problem and are vmapped, these take any
number of leading batch axes.
"""

from __future__ import annotations

import dataclasses

import torch

from colmap_tpu_torch.estimators.utils import eigh, solve, svd
from colmap_tpu_torch.geometry import rigid3, rotation as rot
from colmap_tpu_torch.math.polynomial import find_roots_durand_kerner
from colmap_tpu_torch.optim.ransac import RansacOptions, ransac


def _kabsch(src: torch.Tensor, dst: torch.Tensor, weights=None):
    """Rigid transform (R, t) with dst ~= R src + t, (..., N, 3) sets."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    wsum = torch.sum(weights, dim=-1, keepdim=True) + 1e-12
    cs = torch.sum(src * weights[..., None], dim=-2) / wsum
    cd = torch.sum(dst * weights[..., None], dim=-2) / wsum
    s = src - cs[..., None, :]
    d = dst - cd[..., None, :]
    H = torch.einsum("...ni,...nj,...n->...ij", s, d, weights)
    U, _, Vt = svd(H)
    Ut = U.transpose(-1, -2)
    det = torch.linalg.det(Vt.transpose(-1, -2) @ Ut)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = torch.einsum("...ji,...j,...jk->...ik", Vt, D, Ut)
    t = cd - torch.einsum("...ij,...j->...i", R, cs)
    return R, t


def _conv(p, q):
    """Product of ascending-coefficient polynomials given as lists."""
    out = [None] * (len(p) + len(q) - 1)
    for i, a in enumerate(p):
        for j, b in enumerate(q):
            out[i + j] = a * b if out[i + j] is None else out[i + j] + a * b
    return out


def _eval_asc(p, x):
    out = torch.zeros_like(x)
    for c in reversed(p):
        out = out * x + c[..., None]
    return out


def solve_p3p(points3d: torch.Tensor, uv: torch.Tensor):
    """Grunert P3P. points3d (..., 3, 3) world points; uv (..., 3, 2)
    normalized image coords. Returns (poses (..., 4, 7) cam_from_world,
    valid (..., 4))."""
    f = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)  # unit rays
    P1, P2, P3 = points3d[..., 0, :], points3d[..., 1, :], points3d[..., 2, :]
    a2 = torch.sum((P2 - P3) ** 2, dim=-1)
    b2 = torch.sum((P1 - P3) ** 2, dim=-1)
    c2 = torch.sum((P1 - P2) ** 2, dim=-1)
    ca = torch.sum(f[..., 1, :] * f[..., 2, :], dim=-1)  # cos(alpha)
    cb = torch.sum(f[..., 0, :] * f[..., 2, :], dim=-1)
    cg = torch.sum(f[..., 0, :] * f[..., 1, :], dim=-1)
    b2_safe = torch.where(b2 > 1e-12, b2, torch.full_like(b2, 1e-12))
    A = a2 / b2_safe
    B = c2 / b2_safe

    # u = N(v) / D(v), ascending coefficients:
    #   N(v) = (A - B)(1 + v^2 - 2 v cb) + 1 - v^2,  D(v) = 2 (cg - v ca)
    N = [(A - B) + 1.0, -2.0 * (A - B) * cb, (A - B) - 1.0]
    D = [2.0 * cg, -2.0 * ca]
    # second equation times D^2: N^2 - 2 cg N D + (1 - B(1 + v^2 - 2 v cb)) D^2
    Q = [1.0 - B, 2.0 * B * cb, -B]
    NN, ND, QDD = _conv(N, N), _conv(N, D), _conv(Q, _conv(D, D))
    ND = ND + [torch.zeros_like(A)]
    quartic = [NN[k] - 2.0 * cg * ND[k] + QDD[k] for k in range(5)]

    roots = find_roots_durand_kerner(torch.stack(quartic[::-1], dim=-1),
                                     num_iters=50)  # (..., 4)
    v = roots.real.to(points3d.dtype)
    is_real = torch.abs(roots.imag) <= 1e-4 * (1.0 + torch.abs(v))

    Dv = _eval_asc(D, v)
    Dv_safe = torch.where(torch.abs(Dv) > 1e-12, Dv, torch.full_like(Dv, 1e-12))
    u = _eval_asc(N, v) / Dv_safe

    denom = torch.clamp(1.0 + v * v - 2.0 * v * cb[..., None], min=1e-12)
    s1 = torch.sqrt(b2[..., None] / denom)
    s2 = u * s1
    s3 = v * s1
    valid = is_real & (s1 > 0) & (s2 > 0) & (s3 > 0)

    # camera-frame points, then absolute orientation world -> camera
    s = torch.stack([s1, s2, s3], dim=-1)  # (..., 4 roots, 3 depths)
    pc = s[..., :, :, None] * f[..., None, :, :]  # (..., 4, 3, 3)
    pw = points3d[..., None, :, :].expand(pc.shape)
    R, t = _kabsch(pw, pc)
    poses = rigid3.make(rot.rotmat_to_quat(R), t)
    valid = valid & torch.isfinite(poses).all(dim=-1)
    return poses, valid


def reprojection_residuals(pose: torch.Tensor, data: tuple) -> torch.Tensor:
    """Squared reprojection error in normalized camera coords.

    pose (..., 7) against data = (points3d (..., N, 3), uv (..., N, 2))
    whose leading axes broadcast with the pose's; returns (..., N). Points
    behind the camera get a large finite residual."""
    points3d, uv = data
    pc = rigid3.apply(pose[..., None, :], points3d)
    z = pc[..., 2]
    behind = z < 1e-6
    z_safe = torch.where(behind, torch.ones_like(z), z)
    proj = pc[..., :2] / z_safe[..., None]
    r2 = torch.sum((proj - uv) ** 2, dim=-1)
    return torch.where(behind, torch.full_like(r2, 1e6), r2)


def _obs_residual(delta, pose, points3d, uv, weights):
    """Weighted residuals (..., 2) of observations at exp_update(pose,
    delta)."""
    pc = rigid3.apply(rigid3.exp_update(pose, delta), points3d)
    z = torch.where(pc[..., 2] > 1e-6, pc[..., 2],
                    torch.full_like(pc[..., 2], 1e-6))
    proj = pc[..., :2] / z[..., None]
    return (proj - uv) * weights[..., None]


def _weighted_residual(delta, pose, points3d, uv, weights):
    """One problem's (2N,) weighted residual at exp_update(pose, delta)."""
    return _obs_residual(delta, pose, points3d, uv, weights).reshape(-1)


# per observation a 2x6 Jacobian (each residual pair depends on its own
# point only), vmapped over the observations, then over the problems
_obs_jac = torch.func.vmap(torch.func.vmap(
    torch.func.jacrev(_obs_residual), in_dims=(None, None, 0, 0, 0)))


def _residual_and_jac(d, p, x, uv, w):
    """(B, 2N) weighted residuals and their (B, 2N, 6) Jacobian."""
    J = _obs_jac(d, p, x, uv, w)
    return (torch.func.vmap(_weighted_residual)(d, p, x, uv, w),
            J.reshape(J.shape[0], -1, 6))


def gn_refine_pose(pose: torch.Tensor, points3d: torch.Tensor,
                   uv: torch.Tensor, weights: torch.Tensor,
                   num_iters: int = 10, lm_lambda: float = 1e-4):
    """Damped Gauss-Newton pose refinement on the SE3 tangent (6 dof),
    `num_iters` steps, each kept only if it lowers the weighted cost.
    pose (..., 7), points3d (..., N, 3), uv (..., N, 2), weights (..., N)."""
    lead = pose.shape[:-1]
    n = points3d.shape[-2]
    pose = pose.reshape(-1, 7)
    points3d = points3d.expand(lead + (n, 3)).reshape(-1, n, 3)
    uv = uv.expand(lead + (n, 2)).reshape(-1, n, 2)
    weights = weights.expand(lead + (n,)).reshape(-1, n)
    eye = torch.eye(6, dtype=pose.dtype, device=pose.device)
    delta0 = torch.zeros(pose.shape[:-1] + (6,), dtype=pose.dtype,
                         device=pose.device)
    for _ in range(num_iters):
        r, J = _residual_and_jac(delta0, pose, points3d, uv, weights)
        JtJ = J.transpose(-1, -2) @ J
        Jtr = torch.einsum("bki,bk->bi", J, r)
        H = (JtJ + lm_lambda * torch.diag_embed(
            torch.diagonal(JtJ, dim1=-2, dim2=-1)) + 1e-8 * eye)
        delta = -solve(H, Jtr[..., None])[..., 0]
        new_pose = rigid3.exp_update(pose, delta)
        r_new = torch.func.vmap(_weighted_residual)(
            delta, pose, points3d, uv, weights)
        better = torch.sum(r_new ** 2, -1) < torch.sum(r ** 2, -1)
        pose = torch.where(better[:, None], new_pose, pose)
    return pose.reshape(lead + (7,))


def refit(pose: torch.Tensor, data: tuple, weights: torch.Tensor):
    """LO-RANSAC non-minimal step: GN refine from the current best pose."""
    points3d, uv = data
    new_pose = gn_refine_pose(pose, points3d, uv, weights, num_iters=5)
    return new_pose, torch.isfinite(new_pose).all(dim=-1)


residuals = reprojection_residuals


# ---------------------------------------------------------------------------
# EPnP (n-point, non-minimal)
# ---------------------------------------------------------------------------


def solve_epnp(points3d: torch.Tensor, uv: torch.Tensor,
               weights: torch.Tensor | None = None):
    """EPnP n-point absolute pose (reference: EPnPEstimator). points3d
    (..., N, 3) world, uv (..., N, 2) normalized coords. Control points by
    weighted PCA, the M-matrix null vector (N=1 beta case), scale from
    inter-control-point distances, Kabsch, then a short GN polish.
    Returns (pose (..., 7), valid (...))."""
    n = points3d.shape[-2]
    dtype, dev = points3d.dtype, points3d.device
    if weights is None:
        weights = torch.ones(points3d.shape[:-1], dtype=dtype, device=dev)
    wsum = torch.clamp(torch.sum(weights, -1), min=1e-9)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    # control points: centroid + principal axes
    c0 = torch.sum(points3d * weights[..., None], -2) / wsum[..., None]
    centered = (points3d - c0[..., None, :]) * torch.sqrt(weights)[..., None]
    cov = centered.transpose(-1, -2) @ centered / wsum[..., None, None]
    evals, evecs = eigh(cov)
    axes = (evecs.transpose(-1, -2)
            * torch.sqrt(torch.clamp(evals, min=1e-12))[..., :, None])
    ctrl_w = torch.cat([c0[..., None, :], c0[..., None, :] + axes], -2)

    # barycentric coordinates
    beta = solve(axes.transpose(-1, -2) + 1e-12 * eye3,
                 (points3d - c0[..., None, :]).transpose(-1, -2)
                 ).transpose(-1, -2)  # (..., N, 3)
    alphas = torch.cat([1.0 - torch.sum(beta, -1, keepdim=True), beta], -1)

    # M matrix (..., 2N, 12) for normalized coords
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    zeros = torch.zeros_like(alphas)
    rx = torch.stack([alphas, zeros, -alphas * u], -1)  # (..., N, 4, 3)
    ry = torch.stack([zeros, alphas, -alphas * v], -1)
    lead = points3d.shape[:-2]
    M = torch.cat([rx.reshape(lead + (n, 12)), ry.reshape(lead + (n, 12))],
                  -2)
    M = M * torch.cat([weights, weights], -1)[..., None]
    _, evecs2 = eigh(M.transpose(-1, -2) @ M)
    vker = evecs2[..., :, 0].reshape(lead + (4, 3))  # up to scale

    def pdists(c):
        d = c[..., :, None, :] - c[..., None, :, :]
        return torch.sqrt(torch.sum(d * d, -1) + 1e-12)

    dw, dc = pdists(ctrl_w), pdists(vker)
    scale = (torch.sum(dw * dc, (-1, -2))
             / torch.clamp(torch.sum(dc * dc, (-1, -2)), min=1e-12))
    ctrl_c = vker * scale[..., None, None]
    # the sign that puts the points in front of the camera
    pts_c = alphas @ ctrl_c
    sign = torch.where(
        torch.sum(torch.sign(pts_c[..., 2]) * weights, -1) >= 0, 1.0, -1.0)
    ctrl_c = ctrl_c * sign[..., None, None]

    R, t = _kabsch(ctrl_w, ctrl_c)
    pose = rigid3.make(rot.rotmat_to_quat(R), t)
    pose = gn_refine_pose(pose, points3d, uv, weights, num_iters=8)
    r2 = reprojection_residuals(pose, (points3d, uv))
    valid = (torch.isfinite(pose).all(-1)
             & (torch.sum(torch.where(weights > 0, r2, torch.zeros_like(r2)),
                          -1) < 1e6))
    return pose, valid


def epnp_refit(pose: torch.Tensor, data: tuple, weights: torch.Tensor):
    """LO-RANSAC refit via EPnP (initialization-free non-minimal solver)."""
    del pose
    points3d, uv = data
    return solve_epnp(points3d, uv, weights)


# ---------------------------------------------------------------------------
# Absolute pose with focal-length search
# ---------------------------------------------------------------------------


def estimate_pose_with_focal_search(
    generator: torch.Generator, points3d: torch.Tensor,
    rays_prior: torch.Tensor, valid: torch.Tensor,
    max_error_normalized: float, min_focal_ratio: float = 0.5,
    max_focal_ratio: float = 2.0, num_focal_samples: int = 9,
    ransac_options: RansacOptions | None = None,
):
    """P3P RANSAC over a grid of focal-length factors, all factors as one
    batch of RANSAC problems (reference: EstimateAbsolutePose's focal
    search). rays_prior (N, 2) are normalized with the prior focal; each
    factor f rescales them by 1 / f. Returns (pose (7,), focal_factor,
    num_inliers, inlier_mask (N,))."""
    opts = ransac_options or RansacOptions(num_samples=512, lo_iterations=2)
    opts = dataclasses.replace(opts, max_error=1.0)  # residuals pre-scaled
    dtype, dev = points3d.dtype, points3d.device
    factors = torch.exp(torch.linspace(
        float(torch.log(torch.tensor(min_focal_ratio))),
        float(torch.log(torch.tensor(max_focal_ratio))),
        num_focal_samples, dtype=torch.float64)).to(dtype=dtype, device=dev)
    F, n = num_focal_samples, points3d.shape[0]
    uv = rays_prior[None] / factors[:, None, None]
    scale = 1.0 / torch.clamp(max_error_normalized / factors, min=1e-12) ** 2

    def scaled_res(model, data):
        r = reprojection_residuals(model, data)
        return r * scale.reshape((-1,) + (1,) * (r.dim() - 1))

    res = ransac(generator, solve_p3p, scaled_res, refit,
                 (points3d[None].expand(F, n, 3), uv),
                 valid[None].expand(F, n), 3, opts)
    best = int(torch.argmax(res.score))
    return (res.model[best], factors[best], res.num_inliers[best],
            res.inlier_mask[best])
