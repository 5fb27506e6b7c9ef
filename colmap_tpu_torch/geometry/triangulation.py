"""Point triangulation, batched over leading axes.

Port of colmap_tpu/geometry/triangulation.py (reference:
src/colmap/geometry/triangulation.h). Observations are normalized camera
rays (u, v).
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.estimators.utils import eigh
from colmap_tpu_torch.geometry import rigid3


def triangulate_point(cam1_from_world: torch.Tensor,
                      cam2_from_world: torch.Tensor,
                      uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """Two-view DLT: smallest eigenvector of the 4x4 normal matrix.
    Poses (..., 7) and rays (..., 2) broadcast; returns points (..., 3)."""
    P1 = rigid3.to_matrix(cam1_from_world)  # (..., 3, 4)
    P2 = rigid3.to_matrix(cam2_from_world)

    def rows(P, uv):
        r1 = uv[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        r2 = uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return torch.stack([r1, r2], dim=-2)  # (..., 2, 4)

    A1, A2 = torch.broadcast_tensors(rows(P1, uv1), rows(P2, uv2))
    A = torch.cat([A1, A2], dim=-2)  # (..., 4, 4)
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    _, vecs = eigh(AtA)
    X = vecs[..., :, 0]  # eigenvector of the smallest eigenvalue
    w = X[..., 3:4]
    return X[..., :3] / torch.where(torch.abs(w) > 1e-12, w,
                                    torch.full_like(w, 1e-12))


def triangulate_multi_view(proj_matrices: torch.Tensor, uvs: torch.Tensor,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """N-view least-squares triangulation with an optional per-view mask.

    proj_matrices (..., N, 3, 4); uvs (..., N, 2); mask (..., N) bool.
    Accumulates the 4x4 normal equations over the views (each row pair
    normalized, masked views weighted 0) and takes the smallest
    eigenvector (reference: TriangulateMultiViewPoint). Returns (..., 3)."""
    P = proj_matrices
    r1 = uvs[..., 0:1] * P[..., 2, :] - P[..., 0, :]  # (..., N, 4)
    r2 = uvs[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    A = torch.stack([r1, r2], dim=-2)  # (..., N, 2, 4)
    A = A / (torch.linalg.norm(A, dim=-1, keepdim=True) + 1e-12)
    if mask is not None:
        A = A * mask[..., None, None].to(A.dtype)
    AtA = torch.einsum("...nki,...nkj->...ij", A, A)
    _, vecs = eigh(AtA)
    X = vecs[..., :, 0]
    w = X[..., 3:4]
    return X[..., :3] / torch.where(torch.abs(w) > 1e-12, w,
                                    torch.full_like(w, 1e-12))


def calculate_triangulation_angle(center1: torch.Tensor,
                                  center2: torch.Tensor,
                                  point3d: torch.Tensor) -> torch.Tensor:
    """Angle (radians) at the 3D point subtended by the two camera centers,
    folded to [0, pi/2]."""
    baseline2 = torch.sum((center1 - center2) ** 2, dim=-1)
    ray1 = torch.sum((point3d - center1) ** 2, dim=-1)
    ray2 = torch.sum((point3d - center2) ** 2, dim=-1)
    denom = 2.0 * torch.sqrt(ray1 * ray2 + 1e-24)
    cos_angle = torch.clamp((ray1 + ray2 - baseline2)
                            / torch.clamp(denom, min=1e-24), -1.0, 1.0)
    angle = torch.arccos(cos_angle)
    return torch.minimum(angle, torch.pi - angle)


def has_point_positive_depth(cam_from_world: torch.Tensor,
                             point3d: torch.Tensor) -> torch.Tensor:
    """Whether the point lies in front of the camera (z > 0), batched."""
    return rigid3.apply(cam_from_world, point3d)[..., 2] > 0
