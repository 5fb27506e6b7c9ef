"""Camera models as vectorized PyTorch functions.

Port of colmap_tpu/sensor/models.py. The ids, names and parameter layouts
cover all 12 COLMAP models (the database stores any of them); the
projection functions `img_from_cam` / `cam_from_img` cover SIMPLE_PINHOLE,
PINHOLE, SIMPLE_RADIAL, RADIAL and OPENCV. The other seven models raise
NotImplementedError (ROADMAP queue 1 item 1).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

MAX_PARAMS = 12


class CameraModelId(enum.IntEnum):
    """Model ids matching the reference enum (src/colmap/sensor/models.h:82)."""

    SIMPLE_PINHOLE = 0
    PINHOLE = 1
    SIMPLE_RADIAL = 2
    RADIAL = 3
    OPENCV = 4
    OPENCV_FISHEYE = 5
    FULL_OPENCV = 6
    FOV = 7
    SIMPLE_RADIAL_FISHEYE = 8
    RADIAL_FISHEYE = 9
    THIN_PRISM_FISHEYE = 10
    RAD_TAN_THIN_PRISM_FISHEYE = 11


MODEL_IDS_BY_NAME = {m.name: m for m in CameraModelId}

NUM_PARAMS = {
    CameraModelId.SIMPLE_PINHOLE: 3,  # f, cx, cy
    CameraModelId.PINHOLE: 4,  # fx, fy, cx, cy
    CameraModelId.SIMPLE_RADIAL: 4,  # f, cx, cy, k
    CameraModelId.RADIAL: 5,  # f, cx, cy, k1, k2
    CameraModelId.OPENCV: 8,  # fx, fy, cx, cy, k1, k2, p1, p2
    CameraModelId.OPENCV_FISHEYE: 8,
    CameraModelId.FULL_OPENCV: 12,
    CameraModelId.FOV: 5,
    CameraModelId.SIMPLE_RADIAL_FISHEYE: 4,
    CameraModelId.RADIAL_FISHEYE: 5,
    CameraModelId.THIN_PRISM_FISHEYE: 12,
    CameraModelId.RAD_TAN_THIN_PRISM_FISHEYE: 12,
}

# Index of focal/principal-point params within the param vector, per model.
_FXFY_CXCY = {
    CameraModelId.SIMPLE_PINHOLE: (0, 0, 1, 2),
    CameraModelId.PINHOLE: (0, 1, 2, 3),
    CameraModelId.SIMPLE_RADIAL: (0, 0, 1, 2),
    CameraModelId.RADIAL: (0, 0, 1, 2),
    CameraModelId.OPENCV: (0, 1, 2, 3),
    CameraModelId.OPENCV_FISHEYE: (0, 1, 2, 3),
    CameraModelId.FULL_OPENCV: (0, 1, 2, 3),
    CameraModelId.FOV: (0, 1, 2, 3),
    CameraModelId.SIMPLE_RADIAL_FISHEYE: (0, 0, 1, 2),
    CameraModelId.RADIAL_FISHEYE: (0, 0, 1, 2),
    CameraModelId.THIN_PRISM_FISHEYE: (0, 1, 2, 3),
    CameraModelId.RAD_TAN_THIN_PRISM_FISHEYE: (0, 1, 2, 3),
}


def pad_params(params, dtype=np.float32) -> np.ndarray:
    """Pad a per-model parameter list to a fixed MAX_PARAMS vector."""
    p = np.zeros(MAX_PARAMS, dtype=dtype)
    p[: len(params)] = params
    return p


def _distort_identity(p, uv):
    return uv


def _distort_simple_radial(p, uv):
    k = p[..., 3:4]
    r2 = torch.sum(uv * uv, dim=-1, keepdim=True)
    return uv * (1.0 + k * r2)


def _distort_radial(p, uv):
    k1, k2 = p[..., 3:4], p[..., 4:5]
    r2 = torch.sum(uv * uv, dim=-1, keepdim=True)
    return uv * (1.0 + k1 * r2 + k2 * r2 * r2)


def _distort_opencv(p, uv):
    k1, k2 = p[..., 4:5], p[..., 5:6]
    p1, p2 = p[..., 6:7], p[..., 7:8]
    u, v = uv[..., :1], uv[..., 1:2]
    u2, v2 = u * u, v * v
    uvp = u * v
    r2 = u2 + v2
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    du = u * radial + 2.0 * p1 * uvp + p2 * (r2 + 2.0 * u2)
    dv = v * radial + 2.0 * p2 * uvp + p1 * (r2 + 2.0 * v2)
    return torch.cat([du, dv], dim=-1)


_DISTORT_FNS = {
    CameraModelId.SIMPLE_PINHOLE: _distort_identity,
    CameraModelId.PINHOLE: _distort_identity,
    CameraModelId.SIMPLE_RADIAL: _distort_simple_radial,
    CameraModelId.RADIAL: _distort_radial,
    CameraModelId.OPENCV: _distort_opencv,
}


def _distortion(model_id: int):
    mid = CameraModelId(model_id)
    if mid not in _DISTORT_FNS:
        raise NotImplementedError(
            f"camera model {mid.name}: ROADMAP queue 1 item 1")
    return _DISTORT_FNS[mid]


def focal_pp(model_id: int, params: torch.Tensor):
    """Return (fx, fy, cx, cy) each shaped params.shape[:-1]."""
    i_fx, i_fy, i_cx, i_cy = _FXFY_CXCY[CameraModelId(model_id)]
    return (params[..., i_fx], params[..., i_fy], params[..., i_cx],
            params[..., i_cy])


def img_from_cam(model_id: int, params: torch.Tensor,
                 uv: torch.Tensor) -> torch.Tensor:
    """Normalized camera coords (..., 2) -> pixel coords (..., 2)."""
    duv = _distortion(model_id)(params, uv)
    fx, fy, cx, cy = focal_pp(model_id, params)
    x = fx[..., None] * duv[..., :1] + cx[..., None]
    y = fy[..., None] * duv[..., 1:2] + cy[..., None]
    return torch.cat([x, y], dim=-1)


_NEWTON_ITERS = 25


def cam_from_img(model_id: int, params: torch.Tensor,
                 xy: torch.Tensor) -> torch.Tensor:
    """Pixel coords (..., 2) -> normalized camera coords (..., 2).

    Closed form for the pinhole models; otherwise 25 Newton steps on the
    distortion with its true 2x2 Jacobian (a Python loop where JAX uses
    fori_loop).
    """
    mid = CameraModelId(model_id)
    distort = _distortion(model_id)
    fx, fy, cx, cy = focal_pp(model_id, params)
    duv = torch.stack([(xy[..., 0] - cx) / fx, (xy[..., 1] - cy) / fy],
                      dim=-1)
    if mid in (CameraModelId.SIMPLE_PINHOLE, CameraModelId.PINHOLE):
        return duv

    def fn(q):
        return distort(params, q)

    e_u = torch.stack([torch.ones_like(duv[..., 0]),
                       torch.zeros_like(duv[..., 0])], -1)
    e_v = torch.stack([torch.zeros_like(duv[..., 0]),
                       torch.ones_like(duv[..., 0])], -1)
    uv = duv
    for _ in range(_NEWTON_ITERS):
        f, jvp_u = torch.func.jvp(fn, (uv,), (e_u,))
        _, jvp_v = torch.func.jvp(fn, (uv,), (e_v,))
        r = f - duv
        a, c = jvp_u[..., 0], jvp_u[..., 1]
        b, d = jvp_v[..., 0], jvp_v[..., 1]
        det = a * d - b * c
        det = torch.where(torch.abs(det) > 1e-12, det,
                          torch.full_like(det, 1e-12))
        du = (d * r[..., 0] - b * r[..., 1]) / det
        dv = (-c * r[..., 0] + a * r[..., 1]) / det
        uv = uv - torch.stack([du, dv], dim=-1)
    return uv
