"""Quaternion rotation math, batched over leading axes.

Port of the parts of colmap_tpu/geometry/rotation.py that two-view
geometry, absolute pose and bundle adjustment use. Quaternions are
(w, x, y, z); R(q) @ v rotates world->frame vectors. Every function is
functional (no in-place writes), so torch.func transforms (vmap, vjp,
jacrev) run through it.
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.estimators.utils import eigh

_EPS = 1e-12


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Return the unit quaternion, guarding the zero quaternion to identity."""
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    safe = q / torch.clamp(n, min=_EPS)
    identity = torch.cat([torch.ones_like(q[..., :1]),
                          torch.zeros_like(q[..., 1:])], dim=-1)
    return torch.where(n > _EPS, safe, identity)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b (apply b first, then a, under quat_rotate)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


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


def quat_from_axis_angle(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) -> quaternion (..., 4).

    Differentiable at zero rotation (the BA / pose-refinement linearization
    point): the sqrt never sees 0, and small angles take a Taylor branch.
    """
    n2 = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    small = n2 < 1e-12
    angle = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    half = 0.5 * angle
    k = torch.where(small, 0.5 - n2 / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - n2 / 8.0, torch.cos(half))
    return torch.cat([w, k * axis_angle], dim=-1)


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) -> rotation vector (..., 3)."""
    q = quat_normalize(q)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.arctan2(vn, w)
    scale = torch.where(vn < 1e-9, 2.0 / torch.clamp(w, min=_EPS),
                        angle / torch.clamp(vn, min=_EPS))
    return scale * v


def quat_slerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation between unit quaternions; t broadcasts
    against the leading axes."""
    a = quat_normalize(a)
    b = quat_normalize(b)
    d = torch.sum(a * b, dim=-1, keepdim=True)
    b = torch.where(d < 0, -b, b)
    theta = torch.arccos(torch.clamp(torch.abs(d), -1.0, 1.0))
    sin_theta = torch.sin(theta)
    lerp = sin_theta < 1e-6
    t = torch.as_tensor(t, dtype=a.dtype, device=a.device)
    if t.dim() == a.dim() - 1:
        t = t[..., None]
    safe = torch.clamp(sin_theta, min=_EPS)
    wa = torch.where(lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    wb = torch.where(lerp, t, torch.sin(t * theta) / safe)
    return quat_normalize(wa * a + wb * b)


def quat_average(qs: torch.Tensor,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted quaternion average: the eigenvector of the largest
    eigenvalue of sum(w q q^T), sign fixed to w >= 0 (reference:
    geometry/pose.cc AverageQuaternions). qs (..., N, 4), weights (..., N)
    or None; returns (..., 4)."""
    if weights is None:
        weights = torch.ones(qs.shape[:-1], dtype=qs.dtype, device=qs.device)
    qs = quat_normalize(qs)
    A = torch.einsum("...n,...ni,...nj->...ij", weights, qs, qs)
    _, vecs = eigh(A)
    q = vecs[..., :, -1]
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def cross_matrix(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix [v]_x, (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))
