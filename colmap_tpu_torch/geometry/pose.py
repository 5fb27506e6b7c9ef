"""Pose utilities: interpolation, relative poses, cheirality.

Port of colmap_tpu/geometry/pose.py.
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.geometry import rigid3, rotation as rot


def interpolate_pose(p1: torch.Tensor, p2: torch.Tensor, t) -> torch.Tensor:
    """Slerp rotation + lerp translation (reference: InterpolateCameraPoses)."""
    q = rot.quat_slerp(rigid3.quat(p1), rigid3.quat(p2), t)
    tt = torch.as_tensor(t, dtype=p1.dtype, device=p1.device)
    tr = ((1.0 - tt)[..., None] * rigid3.trans(p1)
          + tt[..., None] * rigid3.trans(p2))
    return rigid3.make(q, tr)


def relative_pose(cam1_from_world: torch.Tensor,
                  cam2_from_world: torch.Tensor) -> torch.Tensor:
    """cam2_from_cam1."""
    return rigid3.compose(cam2_from_world, rigid3.inverse(cam1_from_world))


def check_cheirality(cam2_from_cam1: torch.Tensor, uv1: torch.Tensor,
                     uv2: torch.Tensor, min_depth: float = 1e-6,
                     max_depth: float = 1000.0) -> torch.Tensor:
    """Mask of correspondences (N, 2) that triangulate in front of both
    cameras."""
    from colmap_tpu_torch.geometry.triangulation import triangulate_point

    identity = rigid3.identity(uv1.dtype, uv1.device)
    X = triangulate_point(identity, cam2_from_cam1, uv1, uv2)
    z1 = X[..., 2]
    z2 = rigid3.apply(cam2_from_cam1, X)[..., 2]
    return ((z1 > min_depth) & (z2 > min_depth) & (z1 < max_depth)
            & (z2 < max_depth))
