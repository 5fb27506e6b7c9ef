"""Rigid (SE3) transforms as flat (..., 7) tensors: [qw qx qy qz tx ty tz].

Port of colmap_tpu/geometry/rigid3.py. `b_from_a` maps points as
x_b = R x_a + t; image poses are `cam_from_world` transforms.
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.geometry import rotation as rot

def identity(dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor([1.0, 0, 0, 0, 0, 0, 0], dtype=dtype, device=device)


def make(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([q, t], dim=-1)


def quat(p: torch.Tensor) -> torch.Tensor:
    return p[..., :4]


def trans(p: torch.Tensor) -> torch.Tensor:
    return p[..., 4:7]


def normalize(p: torch.Tensor) -> torch.Tensor:
    return make(rot.quat_normalize(quat(p)), trans(p))


def apply(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply transform to points x (..., 3)."""
    return rot.quat_rotate(quat(p), x) + trans(p)


def compose(b_from_a: torch.Tensor, a_from_c: torch.Tensor) -> torch.Tensor:
    """Compose: (b_from_a) * (a_from_c) = b_from_c."""
    q = rot.quat_multiply(quat(b_from_a), quat(a_from_c))
    t = rot.quat_rotate(quat(b_from_a), trans(a_from_c)) + trans(b_from_a)
    return make(rot.quat_normalize(q), t)


def inverse(p: torch.Tensor) -> torch.Tensor:
    qi = rot.quat_conjugate(rot.quat_normalize(quat(p)))
    return make(qi, -rot.quat_rotate(qi, trans(p)))


def to_matrix(p: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 3, 4) [R | t]."""
    R = rot.quat_to_rotmat(rot.quat_normalize(quat(p)))
    return torch.cat([R, trans(p)[..., None]], dim=-1)


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 7)."""
    return make(rot.rotmat_to_quat(m[..., :3, :3]), m[..., :3, 3])


def projection_center(cam_from_world: torch.Tensor) -> torch.Tensor:
    """Camera center in world coordinates: -R^T t."""
    q = rot.quat_normalize(quat(cam_from_world))
    return -rot.quat_rotate(rot.quat_conjugate(q), trans(cam_from_world))


def exp_update(p: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative local update used by BA and pose refinement.

    delta (..., 6) = [omega (3), dt (3)]: R <- exp([omega]x) R, t <- t + dt.
    """
    dq = rot.quat_from_axis_angle(delta[..., :3])
    q = rot.quat_multiply(dq, quat(p))
    return make(rot.quat_normalize(q), trans(p) + delta[..., 3:6])
