"""Sim3 pose-graph optimization (loop closure for hierarchical merging).

Port of colmap_tpu/estimators/pose_graph.py. Given per-cluster Sim3
placements and measured relative Sim3 edges between overlapping clusters,
jointly refine all placements with Levenberg-Marquardt, so that the
loop-closure error spreads over the whole graph instead of accumulating
along the merge order (the reference merges greedily,
controllers/hierarchical_mapper.h:45-80).

Each node i carries a global_from_cluster_i Sim3 as a 7-dof tangent (log
scale, rotation vector, translation). Edge (i, j) with measurement
Sji = cluster_j_from_cluster_i contributes the residual
tangent(inv(Sji) . (S_j^-1 . S_i)). The dense Jacobian comes from
`torch.func.jacrev`, the normal equations (7N x 7N; cluster counts are
small) solve in one call per iteration, and node 0 is the gauge. The
iterations are a fixed loop whose accept and reject steps are
`torch.where` on the device: the only host read is the result.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.geometry import sim3


def _params_to_sim3(p: torch.Tensor) -> torch.Tensor:
    """(..., 7) tangent [log_s, rotvec(3), t(3)] -> (..., 8) Sim3."""
    return sim3.make(torch.exp(p[..., 0]), rot.quat_from_axis_angle(
        p[..., 1:4]), p[..., 4:7])


def _sim3_tangent(e: torch.Tensor) -> torch.Tensor:
    """(..., 8) Sim3 near identity -> (..., 7) tangent residual."""
    return torch.cat([
        torch.log(torch.clamp(sim3.scale(e), min=1e-12))[..., None],
        rot.quat_to_axis_angle(rot.quat_normalize(sim3.quat(e))),
        sim3.trans(e)], dim=-1)


def _solve(params0: torch.Tensor, edges_i: torch.Tensor,
           edges_j: torch.Tensor, meas: torch.Tensor, weights: torch.Tensor,
           num_iters: int):
    n = params0.shape[0]
    meas_inv = sim3.inverse(meas)

    def residuals(flat):
        S = _params_to_sim3(flat.reshape(n, 7))  # global_from_cluster
        pred = sim3.compose(sim3.inverse(S[edges_j]), S[edges_i])  # j_from_i
        err = sim3.compose(meas_inv, pred)
        return (_sim3_tangent(err) * weights[:, None]).reshape(-1)

    jac = torch.func.jacrev(residuals)
    mask = torch.ones(n * 7, dtype=params0.dtype, device=params0.device)
    mask[:7] = 0.0  # gauge: node 0 stays fixed
    fixed = torch.diag(1.0 - mask)
    params = params0.reshape(-1)
    lam = torch.tensor(1e-6, dtype=params0.dtype, device=params0.device)
    cost = 0.5 * torch.sum(residuals(params) ** 2)
    for _ in range(num_iters):
        r = residuals(params)
        J = jac(params)
        H = J.T @ J
        g = J.T @ r
        H = H * mask[:, None] * mask[None, :] + fixed
        H = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-8))
        # solve_ex: no error check, so no host read; a singular system
        # gives a non-finite step, whose cost the test below rejects
        delta, _ = torch.linalg.solve_ex(H, (g * mask)[:, None])
        new_params = params - delta[:, 0]
        new_cost = 0.5 * torch.sum(residuals(new_params) ** 2)
        accept = new_cost < cost
        params = torch.where(accept, new_params, params)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e4))
        cost = torch.minimum(new_cost, cost)
    return params.reshape(n, 7), cost


def optimize_sim3_pose_graph(initial: np.ndarray, edges: np.ndarray,
                             measurements: np.ndarray,
                             weights: Optional[np.ndarray] = None,
                             num_iters: int = 20,
                             device="cuda") -> np.ndarray:
    """Jointly refine global_from_cluster Sim3 placements.

    initial: (n, 8) Sim3 per node; edges: (E, 2) int (i, j); measurements:
    (E, 8) Sim3 cluster_j_from_cluster_i; node 0 stays fixed. Runs in
    float32 on `device`. Returns the refined (n, 8) float32 placements.
    """
    initial = np.asarray(initial, np.float32)
    n = len(initial)
    if n <= 1 or len(edges) == 0:
        return initial
    q = initial[:, 1:5] / np.maximum(
        np.linalg.norm(initial[:, 1:5], axis=1, keepdims=True), 1e-12)
    params0 = np.zeros((n, 7), np.float32)
    params0[:, 0] = np.log(np.maximum(initial[:, 0], 1e-12))
    params0[:, 1:4] = rot.quat_to_axis_angle(torch.as_tensor(q)).numpy()
    params0[:, 4:7] = initial[:, 5:8]
    if weights is None:
        weights = np.ones(len(edges), np.float32)
    edges = np.asarray(edges)

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    params, _ = _solve(dev(params0), dev(edges[:, 0], torch.int64),
                       dev(edges[:, 1], torch.int64), dev(measurements),
                       dev(weights), num_iters)
    return _params_to_sim3(params).cpu().numpy()
