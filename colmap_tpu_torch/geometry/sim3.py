"""Similarity (Sim3) transforms as flat (..., 8) tensors:
[s, qw qx qy qz, tx ty tz], x_b = s R x_a + t.

Port of colmap_tpu/geometry/sim3.py.
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.geometry import rigid3, rotation as rot

def identity(dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor([1.0, 1.0, 0, 0, 0, 0, 0, 0], dtype=dtype,
                        device=device)


def make(scale: torch.Tensor, q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([scale[..., None], q, t], dim=-1)


def scale(p: torch.Tensor) -> torch.Tensor:
    return p[..., 0]


def quat(p: torch.Tensor) -> torch.Tensor:
    return p[..., 1:5]


def trans(p: torch.Tensor) -> torch.Tensor:
    return p[..., 5:8]


def apply(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return scale(p)[..., None] * rot.quat_rotate(quat(p), x) + trans(p)


def compose(b_from_a: torch.Tensor, a_from_c: torch.Tensor) -> torch.Tensor:
    s = scale(b_from_a) * scale(a_from_c)
    q = rot.quat_multiply(quat(b_from_a), quat(a_from_c))
    t = (scale(b_from_a)[..., None]
         * rot.quat_rotate(quat(b_from_a), trans(a_from_c)) + trans(b_from_a))
    return make(s, rot.quat_normalize(q), t)


def inverse(p: torch.Tensor) -> torch.Tensor:
    si = 1.0 / scale(p)
    qi = rot.quat_conjugate(rot.quat_normalize(quat(p)))
    ti = -si[..., None] * rot.quat_rotate(qi, trans(p))
    return make(si, qi, ti)


def transform_rigid(new_from_old: torch.Tensor,
                    cam_from_world: torch.Tensor) -> torch.Tensor:
    """The cam_from_world pose of a camera after the world is remapped by
    the Sim3 `new_from_old`; the translation is scaled so projections are
    preserved (reference: TransformCameraWorld)."""
    inv = inverse(new_from_old)
    q = rot.quat_multiply(rigid3.quat(cam_from_world), quat(inv))
    t = (rot.quat_rotate(rigid3.quat(cam_from_world), trans(inv))
         + rigid3.trans(cam_from_world))
    return rigid3.make(rot.quat_normalize(q),
                       t * scale(new_from_old)[..., None])
