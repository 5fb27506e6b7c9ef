"""Bundle adjustment: batched Levenberg-Marquardt with a matrix-free
Schur-complement PCG solver.

Port of colmap_tpu/estimators/bundle_adjustment.py (reference: the ceres
stack of estimators/bundle_adjustment.h:15-197):

  * the problem is a flat tableau of observations (pose_idx, cam_idx,
    point_idx, xy, weight);
  * per-observation 2x21 Jacobians (6 pose tangent + 12 intrinsics + 3
    point) come from reverse-mode autodiff, vmapped over the observations
    (torch.func.vmap of torch.func.jacrev over the same _project_residual:
    two cotangents per observation, and no process-wide state, so threads
    may call it at once);
  * the camera system is reduced by the Schur complement matrix-free:
    S u = A u - W Hpp^-1 W^T u from per-observation contractions and
    segment sums (index_add_); point blocks (3x3) invert in closed form;
  * preconditioned CG with the SCHUR_JACOBI block preconditioner (6x6 per
    pose, 12x12 per camera) solves the reduced system;
  * robust losses (trivial / huber / cauchy / soft_l1) by IRLS reweighting.

Only the JAX package's segment-sum path is ported: its pose-major gather
layouts exist because TPU scatter-adds are slow, and its packed buffers and
pow2 shape buckets because of host transfers and compile caches.

The LM loop and the truncated CG are Python loops whose stopping tests read
one device scalar each (a host synchronization); `LMState.syncs` counts
them. On CUDA, index_add_ on floats sums in no fixed order, so results
match the CPU within a tolerance, not bit for bit.

Gauge handling: per-dof float masks on poses, intrinsics and points; frozen
dofs have their Jacobian columns zeroed and their updates masked.

`compute_cost`, `lm_step`, `run_lm` and `init_state` take an optional
shard group (JAX: `axis_name`); with one, the problem is one shard of a
pose-sharded solve (parallel/distributed_ba.py). Without one (`None`, one
device) the body is the single-device path.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from colmap_tpu_torch.geometry import rigid3
from colmap_tpu_torch.sensor import models as camera_models


class BAProblem(NamedTuple):
    """The BA tableau, all tensors on one device."""

    poses: torch.Tensor  # (P, 7) cam_from_world
    cam_params: torch.Tensor  # (C, 12) padded intrinsics
    points: torch.Tensor  # (M, 3)
    obs_pose_idx: torch.Tensor  # (N,) int64
    obs_cam_idx: torch.Tensor  # (N,) int64
    obs_point_idx: torch.Tensor  # (N,) int64
    obs_xy: torch.Tensor  # (N, 2)
    obs_weight: torch.Tensor  # (N,) float; 0 = padding
    pose_mask: torch.Tensor  # (P, 6) float; 0 = frozen dof
    cam_mask: torch.Tensor  # (C, 12) float
    point_mask: torch.Tensor  # (M, 3) float


@dataclasses.dataclass(frozen=True)
class BAOptions:
    max_iterations: int = 50
    cg_iterations: int = 30
    # when False, the intrinsics Jacobians and updates are skipped
    refine_intrinsics: bool = True
    loss: str = "trivial"  # trivial | huber | cauchy | soft_l1
    loss_scale: float = 1.0  # in pixels
    initial_lambda: float = 1e-4
    min_lambda: float = 1e-10
    max_lambda: float = 1e6
    # stop once an accepted step lowers the cost by less than this relative
    # amount, once lambda saturates, or once the cost is below it; <= 0 runs
    # max_iterations (the fixed-cost bench mode)
    function_tolerance: float = 1e-6
    # truncated CG: stop once r^T M^-1 r drops below cg_tolerance^2 times
    # its start value; <= 0 runs cg_iterations
    cg_tolerance: float = 0.1
    # camera model id shared by the problem
    camera_model_id: int = int(camera_models.CameraModelId.SIMPLE_RADIAL)


# ---------------------------------------------------------------------------
# residuals + jacobians
# ---------------------------------------------------------------------------


def _project_residual(pose, cam, point, xy, model_id: int):
    pc = rigid3.apply(pose, point)
    z = pc[..., 2]
    z_safe = torch.where(torch.abs(z) > 1e-8, z, torch.full_like(z, 1e-8))
    uv = pc[..., :2] / z_safe[..., None]
    r = camera_models.img_from_cam(model_id, cam, uv) - xy
    # observations behind the camera get a constant, gradient-free residual
    return torch.where(z[..., None] > 1e-8, r, torch.full_like(r, 1e3))


def _obs_residual_and_jac(problem: BAProblem, model_id: int,
                          with_cam: bool = True):
    """Per-observation residuals (N, 2) and Jacobians with respect to the
    local parameters: Jp (N, 2, 6), Jc (N, 2, 12), Jx (N, 2, 3).
    with_cam=False skips the 12 intrinsics tangents and returns Jc = 0."""
    poses = problem.poses[problem.obs_pose_idx]
    cams = problem.cam_params[problem.obs_cam_idx]
    points = problem.points[problem.obs_point_idx]

    def single(dp, dc, dx, pose, cam, point, xy):
        return _project_residual(rigid3.exp_update(pose, dp), cam + dc,
                                 point + dx, xy, model_id)

    r = _project_residual(poses, cams, points, problem.obs_xy, model_id)
    if r.shape[0] == 0:  # a shard without observations: vmap needs a batch
        def empty(k):
            return torch.zeros((0, 2, k), dtype=r.dtype, device=r.device)

        return r, empty(6), empty(12), empty(3)
    argnums = (0, 1, 2) if with_cam else (0, 2)
    z6 = torch.zeros(6, dtype=poses.dtype, device=poses.device)
    z12 = torch.zeros(12, dtype=poses.dtype, device=poses.device)
    z3 = torch.zeros(3, dtype=poses.dtype, device=poses.device)
    jac = torch.func.vmap(
        lambda pose, cam, point, xy: torch.func.jacrev(
            single, argnums=argnums)(z6, z12, z3, pose, cam, point, xy)
    )(poses, cams, points, problem.obs_xy)
    if with_cam:
        Jp, Jc, Jx = jac
    else:
        Jp, Jx = jac
        Jc = torch.zeros(poses.shape[:1] + (2, 12), dtype=poses.dtype,
                         device=poses.device)
    return r, Jp, Jc, Jx


def _robust_weight(r2: torch.Tensor, loss: str, scale: float) -> torch.Tensor:
    """IRLS weight rho'(r2) for squared residual norms r2."""
    s2 = scale * scale
    if loss == "trivial":
        return torch.ones_like(r2)
    if loss == "huber":
        return torch.where(r2 <= s2, torch.ones_like(r2),
                           torch.sqrt(s2 / torch.clamp(r2, min=1e-12)))
    if loss == "cauchy":
        return 1.0 / (1.0 + r2 / s2)
    if loss == "soft_l1":
        return 1.0 / torch.sqrt(1.0 + r2 / s2)
    raise ValueError(f"unknown loss {loss}")


def _robust_cost(r2: torch.Tensor, loss: str, scale: float) -> torch.Tensor:
    s2 = scale * scale
    if loss == "trivial":
        return r2
    if loss == "huber":
        r = torch.sqrt(torch.clamp(r2, min=1e-20))
        return torch.where(r2 <= s2, r2, 2.0 * scale * r - s2)
    if loss == "cauchy":
        return s2 * torch.log1p(r2 / s2)
    if loss == "soft_l1":
        return 2.0 * s2 * (torch.sqrt(1.0 + r2 / s2) - 1.0)
    raise ValueError(f"unknown loss {loss}")


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over the shards of `group` (a parallel.mesh.ShardGroup);
    `x` itself when there is none."""
    return x if group is None else group.all_reduce_sum(x)


def compute_cost(problem: BAProblem, options: BAOptions,
                 group=None) -> torch.Tensor:
    """Total robust cost 0.5 * sum rho(||r||^2), a device scalar (summed
    over the shards of `group`, when given)."""
    r = _project_residual(problem.poses[problem.obs_pose_idx],
                          problem.cam_params[problem.obs_cam_idx],
                          problem.points[problem.obs_point_idx],
                          problem.obs_xy, options.camera_model_id)
    r2 = torch.sum(r * r, dim=-1) * problem.obs_weight
    return _sum(
        0.5 * torch.sum(_robust_cost(r2, options.loss, options.loss_scale)),
        group)


# ---------------------------------------------------------------------------
# the LM step
# ---------------------------------------------------------------------------


def _inv3x3_sym(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched symmetric 3x3 inverse (adjugate)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    idet = 1.0 / torch.where(torch.abs(det) > 1e-20, det,
                             torch.full_like(det, 1e-20))
    row0 = torch.stack([co00, co01, co02], -1)
    row1 = torch.stack([co01, co11, co12], -1)
    row2 = torch.stack([co02, co12, co22], -1)
    return torch.stack([row0, row1, row2], -2) * idet[..., None, None]


def _segsum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Segment sum of x (N, ...) by idx (N,) into (n, ...)."""
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype,
                       device=x.device).index_add_(0, idx, x)


class LMState(NamedTuple):
    problem: BAProblem
    lam: torch.Tensor
    cost: torch.Tensor
    iteration: int
    # |trial_cost - cost| / cost of the last ACCEPTED step; inf after a
    # rejected step (function_tolerance is tested on accepted steps only)
    rel_change: torch.Tensor
    cg_steps: int = 0  # CG iterations run, over all LM steps
    syncs: int = 0  # device scalars read by the host to stop a loop


def lm_step(state: LMState, options: BAOptions, group=None) -> LMState:
    """One damped LM iteration. Returns the updated LMState.

    With a `group` (parallel.mesh.ShardGroup) the problem is this shard's
    pose block and its observations (local pose indices), with the cameras
    and points replicated: point and camera reductions, the Schur matvec's
    point and camera sums, the CG dot products and the cost are summed over
    the shards, the pose blocks stay local (parallel/distributed_ba.py)."""
    problem = state.problem
    P = problem.poses.shape[0]
    C = problem.cam_params.shape[0]
    M = problem.points.shape[0]
    pidx, cidx, xidx = (problem.obs_pose_idx, problem.obs_cam_idx,
                        problem.obs_point_idx)

    # without intrinsics Jc is 0, so the camera part of the right-hand side
    # and of every CG vector is exactly 0: all camera terms are skipped
    use_cam = options.refine_intrinsics
    r, Jp, Jc, Jx = _obs_residual_and_jac(problem, options.camera_model_id,
                                          with_cam=use_cam)

    # robust IRLS scaling + observation weights + frozen-dof column masks
    r2 = torch.sum(r * r, dim=-1)
    w = _robust_weight(r2, options.loss, options.loss_scale) \
        * problem.obs_weight
    sw = torch.sqrt(torch.clamp(w, min=0.0))[:, None]
    r = r * sw
    Jp = Jp * sw[..., None] * problem.pose_mask[pidx][:, None, :]
    Jx = Jx * sw[..., None] * problem.point_mask[xidx][:, None, :]
    if use_cam:
        Jc = Jc * sw[..., None] * problem.cam_mask[cidx][:, None, :]

    lam = state.lam
    dt, dev = Jx.dtype, Jx.device
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    # ---- block reductions (N-major, segment sums) -------------------------
    Hxx = _sum(
        _segsum(torch.einsum("nki,nkj->nij", Jx, Jx), xidx, M), group)
    gx = _sum(_segsum(torch.einsum("nki,nk->ni", Jx, r), xidx, M), group)
    Hpp = _segsum(torch.einsum("nki,nkj->nij", Jp, Jp), pidx, P)
    gp = _segsum(torch.einsum("nki,nk->ni", Jp, r), pidx, P)

    dHxx = torch.clamp(torch.diagonal(Hxx, dim1=-2, dim2=-1), min=1e-6)
    Hxx_inv = _inv3x3_sym(Hxx + lam * dHxx[..., None] * eye3 + 1e-8 * eye3)
    dHpp = torch.clamp(torch.diagonal(Hpp, dim1=-2, dim2=-1), min=1e-6)
    # SCHUR_JACOBI: S[p,p] = Hpp[p] - sum W Hxx^-1 W^T
    W = torch.einsum("nki,nkj->nij", Jp, Jx)  # (N, 6, 3)
    WV = torch.einsum("nij,njk->nik", W, Hxx_inv[xidx])
    S_self = _segsum(torch.einsum("nik,njk->nij", WV, W), pidx, P)
    Hpp_prec = Hpp - S_self + lam * dHpp[..., None] * eye6 + 1e-8 * eye6
    # inv_ex: no error check, so no host synchronization
    Hpp_prec_inv = torch.linalg.inv_ex(Hpp_prec)[0]
    if use_cam:
        Hcc = _sum(
            _segsum(torch.einsum("nki,nkj->nij", Jc, Jc), cidx, C), group)
        gc = _sum(
            _segsum(torch.einsum("nki,nk->ni", Jc, r), cidx, C), group)
        dHcc = torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1), min=1e-6)
        eye12 = torch.eye(12, dtype=dt, device=dev)
        Hcc_prec_inv = torch.linalg.inv_ex(
            Hcc + lam * dHcc[..., None] * eye12 + 1e-8 * eye12)[0]

    # CG vectors are tuples of blocks: (poses,) or (poses, cameras)
    def S_matvec(u):
        a = torch.einsum("nki,ni->nk", Jp, u[0][pidx])  # (N, 2)
        if use_cam:
            a = a + torch.einsum("nki,ni->nk", Jc, u[1][cidx])
        v = _sum(_segsum(torch.einsum("nki,nk->ni", Jx, a), xidx, M),
                 group)  # (M, 3)
        wv = torch.einsum("mij,mj->mi", Hxx_inv, v)
        b = a - torch.einsum("nki,ni->nk", Jx, wv[xidx])
        out_pose = _segsum(torch.einsum("nki,nk->ni", Jp, b), pidx, P) \
            + lam * dHpp * u[0] + 1e-8 * u[0]
        if not use_cam:
            return (out_pose,)
        out_cam = _sum(
            _segsum(torch.einsum("nki,nk->ni", Jc, b), cidx, C), group) \
            + lam * dHcc * u[1] + 1e-8 * u[1]
        return out_pose, out_cam

    # reduced RHS: -g_cam + W Hxx^-1 g_x
    hg = torch.einsum("mij,mj->mi", Hxx_inv, gx)
    t = torch.einsum("nki,ni->nk", Jx, hg[xidx])  # (N, 2)
    rhs = (-gp + _segsum(torch.einsum("nki,nk->ni", Jp, t), pidx, P),)
    if use_cam:
        rhs += (-gc + _sum(
            _segsum(torch.einsum("nki,nk->ni", Jc, t), cidx, C), group),)

    def precond(u):
        z_pose = torch.einsum("pij,pj->pi", Hpp_prec_inv, u[0])
        if not use_cam:
            return (z_pose,)
        return z_pose, torch.einsum("cij,cj->ci", Hcc_prec_inv, u[1])

    def dot(a, b):
        out = torch.sum(a[0] * b[0])
        # the camera blocks are replicated: only the first shard adds them
        if use_cam and (group is None or group.rank == 0):
            out = out + torch.sum(a[1] * b[1])
        return _sum(out, group)

    def axpy(alpha, a, b):
        return tuple(bi + alpha * ai for ai, bi in zip(a, b))

    def safe(x):
        return torch.where(torch.abs(x) > 1e-20, x, torch.full_like(x, 1e-20))

    # ---- PCG --------------------------------------------------------------
    x = tuple(torch.zeros_like(b) for b in rhs)
    rr = rhs
    z = precond(rr)
    p = z
    rz = dot(rr, z)
    thresh = (options.cg_tolerance ** 2) * rz
    syncs = state.syncs
    i = 0
    while i < options.cg_iterations:
        if options.cg_tolerance > 0:
            syncs += 1
            if not bool(rz > thresh):
                break
        Ap = S_matvec(p)
        alpha = rz / safe(dot(p, Ap))
        x = axpy(alpha, p, x)
        rr = axpy(-alpha, Ap, rr)
        z = precond(rr)
        rz_new = dot(rr, z)
        beta = rz_new / safe(rz)
        p = axpy(beta, p, z)
        rz = rz_new
        i += 1
    du_pose = x[0]

    # ---- back-substitute point updates ------------------------------------
    a = torch.einsum("nki,ni->nk", Jp, du_pose[pidx])
    if use_cam:
        a = a + torch.einsum("nki,ni->nk", Jc, x[1][cidx])
    rhs_x = -gx - _sum(
        _segsum(torch.einsum("nki,nk->ni", Jx, a), xidx, M), group)
    dx = torch.einsum("mij,mj->mi", Hxx_inv, rhs_x)

    # frozen dofs stay put even with numerical noise
    du_pose = du_pose * problem.pose_mask
    dx = dx * problem.point_mask

    # ---- trial state + accept/reject ---------------------------------------
    trial = problem._replace(poses=rigid3.exp_update(problem.poses, du_pose),
                             points=problem.points + dx)
    if use_cam:
        trial = trial._replace(
            cam_params=problem.cam_params + x[1] * problem.cam_mask)
    new_cost = compute_cost(trial, options, group)
    cur_cost = state.cost
    accept = new_cost < cur_cost
    lam_new = torch.where(
        accept, torch.clamp(lam * 0.3333, min=options.min_lambda),
        torch.clamp(lam * 4.0, max=options.max_lambda))
    next_problem = problem._replace(
        poses=torch.where(accept, trial.poses, problem.poses),
        cam_params=torch.where(accept, trial.cam_params, problem.cam_params),
        points=torch.where(accept, trial.points, problem.points))
    rel = torch.abs(cur_cost - new_cost) / torch.clamp(cur_cost, min=1e-20)
    return LMState(
        problem=next_problem,
        lam=lam_new,
        cost=torch.where(accept, new_cost, cur_cost),
        iteration=state.iteration + 1,
        rel_change=torch.where(accept, rel, torch.full_like(rel, np.inf)),
        cg_steps=state.cg_steps + i,
        syncs=syncs,
    )


def run_lm(state: LMState, options: BAOptions, group=None) -> LMState:
    """The LM iteration loop. With function_tolerance > 0 it stops on an
    accepted step whose relative cost change is below the tolerance, on
    lambda saturation, or once the cost is below the tolerance (each test
    is one host synchronization); otherwise it runs max_iterations. With a
    `group`, every shard runs it on its own block (see lm_step); the tests
    read reduced values, so every shard stops at the same step."""
    tol = options.function_tolerance
    while state.iteration < options.max_iterations:
        if tol > 0:
            stuck = state.lam >= options.max_lambda * 0.999
            converged = (state.rel_change < tol) | stuck | (state.cost < tol)
            state = state._replace(syncs=state.syncs + 1)
            if bool(converged):
                break
        state = lm_step(state, options, group)
    return state


def init_state(problem: BAProblem, options: BAOptions,
               group=None) -> LMState:
    cost0 = compute_cost(problem, options, group)
    return LMState(
        problem=problem,
        lam=torch.tensor(options.initial_lambda, dtype=problem.poses.dtype,
                         device=problem.poses.device),
        cost=cost0,
        iteration=0,
        rel_change=torch.full_like(cost0, np.inf),
    )


def solve(problem: BAProblem, options: BAOptions) -> LMState:
    """Run up to `options.max_iterations` LM iterations on the problem's
    device."""
    return run_lm(init_state(problem, options), options)


# ---------------------------------------------------------------------------
# Problem construction (host side)
# ---------------------------------------------------------------------------


def problem_from_numpy(fields: dict, device) -> BAProblem:
    """The port's BAProblem from a JAX BAProblem's fields as numpy arrays
    (e.g. `{k: np.asarray(v) for k, v in jax_problem._asdict().items()}`);
    fields the port has no use for (the gather layouts) are ignored."""
    out = {}
    for name in BAProblem._fields:
        a = np.array(fields[name])
        dtype = torch.int64 if name.startswith("obs_") and name.endswith(
            "_idx") else torch.float32
        out[name] = torch.as_tensor(a, device=device).to(dtype)
    return BAProblem(**out)


def make_problem(
    poses,
    cam_params,
    points,
    obs_pose_idx,
    obs_cam_idx,
    obs_point_idx,
    obs_xy,
    obs_weight=None,
    fix_poses=(),
    fix_first_pose_and_gauge: bool = False,
    refine_intrinsics: bool = False,
    refine_extra_params: bool = False,
    refine_principal_point: bool = False,
    camera_model_ids=None,
    device="cuda",
) -> BAProblem:
    """Build a float32 BAProblem on `device` from numpy arrays, with
    COLMAP-like gauge defaults.

    `fix_first_pose_and_gauge` reproduces the reference's global-BA gauge:
    the first pose is fully fixed and the second pose's tx is fixed.
    """
    P, C, M = len(poses), len(cam_params), len(points)
    if obs_weight is None:
        obs_weight = np.ones(len(obs_xy), np.float32)
    pose_mask = np.ones((P, 6), np.float32)
    for i in fix_poses:
        pose_mask[i] = 0.0
    if fix_first_pose_and_gauge and P >= 2:
        pose_mask[0] = 0.0
        pose_mask[1, 3] = 0.0  # tx of the second pose
    cam_mask = np.zeros((C, 12), np.float32)
    if camera_model_ids is not None:
        # reference BA defaults: refine focal (+ extra params when asked),
        # keep the principal point fixed unless asked
        if refine_intrinsics:
            for c in range(C):
                cam_mask[c] = camera_models.refine_mask(
                    int(camera_model_ids[c]), focal=True,
                    principal_point=refine_principal_point,
                    extra=refine_extra_params)
    else:
        if refine_intrinsics:
            cam_mask[:, :4] = 1.0
        if refine_extra_params:
            cam_mask[:, 4:] = 1.0
    return problem_from_numpy(dict(
        poses=poses, cam_params=cam_params, points=points,
        obs_pose_idx=obs_pose_idx, obs_cam_idx=obs_cam_idx,
        obs_point_idx=obs_point_idx, obs_xy=obs_xy, obs_weight=obs_weight,
        pose_mask=pose_mask, cam_mask=cam_mask,
        point_mask=np.ones((M, 3), np.float32)), device)
