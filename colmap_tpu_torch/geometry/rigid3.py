"""Rigid (SE3) transforms as flat (..., 7) tensors: [qw qx qy qz tx ty tz].

Port of the parts of colmap_tpu/geometry/rigid3.py that two-view geometry
uses. `b_from_a` maps points as x_b = R x_a + t.
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.geometry import rotation as rot


def identity(dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.tensor([1.0, 0, 0, 0, 0, 0, 0], dtype=dtype, device=device)


def make(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([q, t], dim=-1)


def quat(p: torch.Tensor) -> torch.Tensor:
    return p[..., :4]


def trans(p: torch.Tensor) -> torch.Tensor:
    return p[..., 4:7]


def apply(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply transform to points x (..., 3)."""
    return rot.quat_rotate(quat(p), x) + trans(p)


def to_matrix(p: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 3, 4) [R | t]."""
    R = rot.quat_to_rotmat(rot.quat_normalize(quat(p)))
    return torch.cat([R, trans(p)[..., None]], dim=-1)


def projection_center(cam_from_world: torch.Tensor) -> torch.Tensor:
    """Camera center in world coordinates: -R^T t."""
    q = rot.quat_normalize(quat(cam_from_world))
    return -rot.quat_rotate(rot.quat_conjugate(q), trans(cam_from_world))
