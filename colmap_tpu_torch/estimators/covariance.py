"""Pose and point covariances of a bundle adjustment solution.

Port of colmap_tpu/estimators/covariance.py (reference:
src/colmap/estimators/covariance.h:17): the pose covariances come from the
inverse of the reduced camera system (the points eliminated from the BA
Hessian by the Schur complement), the point covariances by
back-substitution; unit-variance pixel noise is assumed.

The JAX package loops in Python over points and poses on the host. The
port runs batched float64 torch on the problem's device: the Jacobians
come from the BA solver's own `_obs_residual_and_jac`; the 3x3 point
blocks invert in one batched call (a block whose condition number reaches
1e12 contributes nothing, as in JAX); the Schur complement
Hpp - sum_m W_m V_m^-1 W_m^T accumulates over chunks of points with W_m
dense over the poses; the free part of the reduced system is inverted
densely (6P x 6P, as in JAX).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from colmap_tpu_torch.estimators import bundle_adjustment as ba

# elements of one chunk's dense (points, 3, 6P) pose coupling
_CHUNK_ELEMS = 1 << 24


@dataclasses.dataclass
class CovarianceOptions:
    damping: float = 1e-8  # gauge / conditioning regularizer
    compute_point_covariances: bool = False


@dataclasses.dataclass
class BACovariance:
    pose_covs: Dict[int, np.ndarray]  # pose index -> (6, 6), tangent space
    point_covs: Dict[int, np.ndarray]  # point index -> (3, 3)


def _weighted_jacobians(problem: ba.BAProblem, model_id: int):
    """Float64 Jp (N, 2, 6) and Jx (N, 2, 3), scaled by the observation
    weights and with frozen dofs' columns zeroed."""
    _, Jp, _, Jx = ba._obs_residual_and_jac(problem, model_id,
                                            with_cam=False)
    w = problem.obs_weight.double()[:, None, None]
    Jp = Jp.double() * w * problem.pose_mask.double()[
        problem.obs_pose_idx][:, None, :]
    Jx = Jx.double() * w * problem.point_mask.double()[
        problem.obs_point_idx][:, None, :]
    return Jp, Jx


def _coupling(A, pose_idx, rows, R: int, P: int):
    """(R, 3, 6P): per point row, the sum of its observations' A^T (3x6)
    blocks placed at their poses."""
    W = torch.zeros((R, P, 3, 6), dtype=A.dtype, device=A.device)
    W.index_put_((rows, pose_idx), A.transpose(-1, -2), accumulate=True)
    return W.permute(0, 2, 1, 3).reshape(R, 3, 6 * P)


def estimate_ba_covariance(problem: ba.BAProblem,
                           options: CovarianceOptions = CovarianceOptions(),
                           camera_model_id: Optional[int] = None
                           ) -> BACovariance:
    """Covariances of the free pose and point parameters at the current
    BA solution, assuming unit-variance pixel noise."""
    model_id = camera_model_id if camera_model_id is not None else \
        int(ba.camera_models.CameraModelId.SIMPLE_RADIAL)
    Jp, Jx = _weighted_jacobians(problem, model_id)
    dev = Jp.device
    pose_idx, point_idx = problem.obs_pose_idx, problem.obs_point_idx
    pose_mask = problem.pose_mask.double()
    P, M = pose_mask.shape[0], problem.point_mask.shape[0]
    eye3 = torch.eye(3, dtype=torch.float64, device=dev)

    Hpp = ba._segsum(torch.einsum("nri,nrj->nij", Jp, Jp), pose_idx, P)
    V = ba._segsum(torch.einsum("nri,nrj->nij", Jx, Jx), point_idx, M)
    A = torch.einsum("nri,nrj->nij", Jp, Jx)  # (N, 6, 3)
    Vm = V + options.damping * eye3
    Vinv = torch.where((torch.linalg.cond(Vm) < 1e12)[:, None, None],
                       torch.linalg.inv_ex(Vm)[0], torch.zeros_like(Vm))

    # reduced camera system, chunked over points
    S = torch.block_diag(*Hpp)
    order = torch.argsort(point_idx, stable=True)
    counts = torch.bincount(point_idx, minlength=M)
    offsets = [0] + torch.cumsum(counts, 0).tolist()
    chunk = max(1, _CHUNK_ELEMS // max(1, 18 * P))
    chunks = []
    for m0 in range(0, M, chunk):
        m1 = min(M, m0 + chunk)
        obs = order[offsets[m0]:offsets[m1]]
        W = _coupling(A[obs], pose_idx[obs], point_idx[obs] - m0, m1 - m0,
                      P)
        S = S - torch.einsum("mai,mab,mbj->ij", W, Vinv[m0:m1], W)
        chunks.append((m0, m1, W))

    free = pose_mask.reshape(-1) > 0
    Sf = S[free][:, free] + options.damping * torch.eye(
        int(free.sum()), dtype=torch.float64, device=dev)
    Sinv_f, info = torch.linalg.inv_ex(Sf)
    if int(info) != 0:
        Sinv_f = torch.linalg.pinv(Sf)
    Sinv = torch.zeros((6 * P, 6 * P), dtype=torch.float64, device=dev)
    fi = torch.nonzero(free)[:, 0]
    Sinv[fi[:, None], fi[None, :]] = Sinv_f

    blocks = Sinv.reshape(P, 6, P, 6)[torch.arange(P), :, torch.arange(P)]
    blocks = blocks.cpu().numpy()
    has_dof = pose_mask.any(-1).cpu().numpy()
    pose_covs = {p: blocks[p] for p in range(P) if has_dof[p]}

    point_covs: Dict[int, np.ndarray] = {}
    if options.compute_point_covariances:
        keep = ((counts > 0) & problem.point_mask.bool().any(-1)).cpu()
        for m0, m1, W in chunks:
            VW = torch.einsum("mab,mbi->mai", Vinv[m0:m1], W)
            cov = Vinv[m0:m1] + torch.einsum("mai,ij,mbj->mab", VW, Sinv, VW)
            cov = cov.cpu().numpy()
            for k in np.nonzero(keep[m0:m1].numpy())[0]:
                point_covs[m0 + int(k)] = cov[k]
    return BACovariance(pose_covs=pose_covs, point_covs=point_covs)


def estimate_pose_covariance_full_inverse(problem: ba.BAProblem,
                                          camera_model_id: int,
                                          damping: float = 1e-8
                                          ) -> np.ndarray:
    """The reference for tests: invert the full (pose + point) Hessian
    densely and return the pose-block marginals (P, 6, P, 6)."""
    Jp, Jx = _weighted_jacobians(problem, camera_model_id)
    dev = Jp.device
    pose_idx, point_idx = problem.obs_pose_idx, problem.obs_point_idx
    pose_mask, point_mask = problem.pose_mask, problem.point_mask
    P, M, N = pose_mask.shape[0], point_mask.shape[0], len(pose_idx)
    n = 6 * P + 3 * M
    J = torch.zeros((N, 2, n), dtype=torch.float64, device=dev)
    rows = torch.arange(N, device=dev)[:, None]
    J[rows, :, 6 * pose_idx[:, None] + torch.arange(6, device=dev)] = \
        Jp.transpose(1, 2)
    J[rows, :, 6 * P + 3 * point_idx[:, None]
      + torch.arange(3, device=dev)] = Jx.transpose(1, 2)
    J = J.reshape(2 * N, n)
    H = J.T @ J
    free = torch.cat([pose_mask.reshape(-1) > 0, point_mask.reshape(-1) > 0])
    fi = torch.nonzero(free)[:, 0]
    Hf = H[fi[:, None], fi[None, :]] + damping * torch.eye(
        len(fi), dtype=torch.float64, device=dev)
    full = torch.zeros((n, n), dtype=torch.float64, device=dev)
    full[fi[:, None], fi[None, :]] = torch.linalg.inv(Hf)
    return full[:6 * P, :6 * P].reshape(P, 6, P, 6).cpu().numpy()
