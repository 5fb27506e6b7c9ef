"""Quaternion rotation math, batched over leading axes.

Port of the parts of colmap_tpu/geometry/rotation.py that two-view geometry
uses. Quaternions are (w, x, y, z); R(q) @ v rotates world->frame vectors.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Return the unit quaternion, guarding the zero quaternion to identity."""
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    safe = q / torch.clamp(n, min=_EPS)
    identity = torch.zeros_like(q)
    identity[..., 0] = 1.0
    return torch.where(n > _EPS, safe, identity)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    w = w.expand(u.shape[:-1] + (1,))
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), w >= 0.

    Branchless Shepperd-style selection of the best-conditioned of the four
    candidate formulas.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)

    def build(pivot2, a, b, c, order):
        s = 2.0 * torch.sqrt(pivot2 + _EPS)
        comps = [None] * 4
        comps[order[0]] = s / 4.0
        comps[order[1]] = a / s
        comps[order[2]] = b / s
        comps[order[3]] = c / s
        return torch.stack(comps, dim=-1)

    cw = build(qw2, m21 - m12, m02 - m20, m10 - m01, (0, 1, 2, 3))
    cx = build(qx2, m21 - m12, m01 + m10, m02 + m20, (1, 0, 2, 3))
    cy = build(qy2, m02 - m20, m01 + m10, m12 + m21, (2, 0, 1, 3))
    cz = build(qz2, m10 - m01, m02 + m20, m12 + m21, (3, 0, 1, 2))

    cands = torch.stack([cw, cx, cy, cz], dim=-2)  # (..., 4, 4)
    pivots = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_angle_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Relative rotation angle between two quaternions, in degrees."""
    d = torch.abs(torch.sum(quat_normalize(a) * quat_normalize(b), dim=-1))
    return torch.rad2deg(2.0 * torch.arccos(torch.clamp(d, -1.0, 1.0)))
