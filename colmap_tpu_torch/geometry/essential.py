"""Essential-matrix decomposition and pose recovery, batched.

Port of colmap_tpu/geometry/essential.py (the pose-recovery half).
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.estimators.utils import svd
from colmap_tpu_torch.geometry import rigid3, rotation as rot
from colmap_tpu_torch.geometry.triangulation import triangulate_point


def decompose_essential_matrix(E: torch.Tensor):
    """E (..., 3, 3) -> (R1, R2, t) with ||t|| = 1 (4 pose candidates)."""
    U, _, Vt = svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    t = t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-12)
    return R1, R2, t


def pose_from_essential_matrix(E: torch.Tensor, uv1: torch.Tensor,
                               uv2: torch.Tensor,
                               mask: torch.Tensor | None = None):
    """cam2_from_cam1 by cheirality voting over the 4 candidates.

    E (..., 3, 3); uv1/uv2 (..., N, 2) normalized rays; mask (..., N).
    Returns (pose (..., 7), num_in_front (...), points (..., N, 3)).
    """
    R1, R2, t = decompose_essential_matrix(E)
    q1 = rot.rotmat_to_quat(R1)
    q2 = rot.rotmat_to_quat(R2)
    cands = torch.stack([rigid3.make(q1, t), rigid3.make(q1, -t),
                         rigid3.make(q2, t), rigid3.make(q2, -t)],
                        dim=-2)  # (..., 4, 7)
    if mask is None:
        mask = torch.ones(uv1.shape[:-1], dtype=torch.bool, device=uv1.device)
    identity = rigid3.identity(E.dtype, E.device)
    posed = cands[..., :, None, :]  # (..., 4, 1, 7)
    X = triangulate_point(identity, posed, uv1[..., None, :, :],
                          uv2[..., None, :, :])  # (..., 4, N, 3)
    z1 = X[..., 2]
    z2 = rigid3.apply(posed, X)[..., 2]
    eps = torch.finfo(E.dtype).eps
    ok = (z1 > eps) & (z2 > eps) & (z1 < 1000.0) & (z2 < 1000.0)
    ok &= mask[..., None, :]
    counts = ok.sum(-1)  # (..., 4)
    best = torch.argmax(counts, dim=-1)
    pose = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 7)))[..., 0, :]
    count = torch.gather(counts, -1, best[..., None])[..., 0]
    pts = torch.gather(X, -3, best[..., None, None, None].expand(
        best.shape + (1,) + X.shape[-2:]))[..., 0, :, :]
    return pose, count, pts
