"""Camera models as vectorized PyTorch functions.

Port of colmap_tpu/sensor/models.py: ids, names, parameter layouts and the
projections `img_from_cam` / `cam_from_img` / `project` of all 12 COLMAP
models. Every function broadcasts over leading axes; the model id is a host
int. Undistortion is closed form for the pinhole models and FOV, else 25
Newton steps.
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


MODEL_NAMES = {m: m.name for m in CameraModelId}
MODEL_IDS_BY_NAME = {m.name: m for m in CameraModelId}

NUM_PARAMS = {
    CameraModelId.SIMPLE_PINHOLE: 3,  # f, cx, cy
    CameraModelId.PINHOLE: 4,  # fx, fy, cx, cy
    CameraModelId.SIMPLE_RADIAL: 4,  # f, cx, cy, k
    CameraModelId.RADIAL: 5,  # f, cx, cy, k1, k2
    CameraModelId.OPENCV: 8,  # fx, fy, cx, cy, k1, k2, p1, p2
    CameraModelId.OPENCV_FISHEYE: 8,  # fx, fy, cx, cy, k1, k2, k3, k4
    CameraModelId.FULL_OPENCV: 12,  # fx, fy, cx, cy, k1, k2, p1, p2, k3..k6
    CameraModelId.FOV: 5,  # fx, fy, cx, cy, omega
    CameraModelId.SIMPLE_RADIAL_FISHEYE: 4,  # f, cx, cy, k
    CameraModelId.RADIAL_FISHEYE: 5,  # f, cx, cy, k1, k2
    CameraModelId.THIN_PRISM_FISHEYE: 12,  # fx,fy,cx,cy,k1,k2,p1,p2,k3,k4,sx1,sy1
    CameraModelId.RAD_TAN_THIN_PRISM_FISHEYE: 12,  # fx,fy,cx,cy,k1..k4,p1,p2,sx1,sy1
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


def refine_mask(model_id: int, focal: bool = True,
                principal_point: bool = False, extra: bool = True) -> np.ndarray:
    """Per-parameter (MAX_PARAMS,) refinement mask for bundle adjustment:
    the reference's defaults refine focal and extra parameters and hold the
    principal point fixed unless asked."""
    mid = CameraModelId(model_id)
    fx, fy, cx, cy = _FXFY_CXCY[mid]
    m = np.zeros(MAX_PARAMS, np.float32)
    if focal:
        m[fx] = m[fy] = 1.0
    if principal_point:
        m[cx] = m[cy] = 1.0
    if extra:
        for i in range(NUM_PARAMS[mid]):
            if i not in (fx, fy, cx, cy):
                m[i] = 1.0
    return m


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


def _distort_full_opencv(p, uv):
    k1, k2, p1, p2 = p[..., 4:5], p[..., 5:6], p[..., 6:7], p[..., 7:8]
    k3, k4, k5, k6 = p[..., 8:9], p[..., 9:10], p[..., 10:11], p[..., 11:12]
    u, v = uv[..., :1], uv[..., 1:2]
    u2, v2 = u * u, v * v
    uvp = u * v
    r2 = u2 + v2
    r4 = r2 * r2
    r6 = r4 * r2
    radial = ((1.0 + k1 * r2 + k2 * r4 + k3 * r6)
              / (1.0 + k4 * r2 + k5 * r4 + k6 * r6))
    du = u * radial + 2.0 * p1 * uvp + p2 * (r2 + 2.0 * u2)
    dv = v * radial + 2.0 * p2 * uvp + p1 * (r2 + 2.0 * v2)
    return torch.cat([du, dv], dim=-1)


def _fisheye_theta(uv):
    r = torch.sqrt(torch.sum(uv * uv, dim=-1, keepdim=True) + 1e-24)
    return r, torch.arctan(r)


def _theta_poly(k1, k2, k3, k4, theta):
    t2 = theta * theta
    return theta * (1.0 + k1 * t2 + k2 * t2 ** 2 + k3 * t2 ** 3
                    + k4 * t2 ** 4)


def _distort_opencv_fisheye(p, uv):
    r, theta = _fisheye_theta(uv)
    theta_d = _theta_poly(p[..., 4:5], p[..., 5:6], p[..., 6:7], p[..., 7:8],
                          theta)
    return uv * torch.where(r > 1e-8, theta_d / r, 1.0)


def _distort_fov(p, uv):
    """rd = atan(2 r tan(omega / 2)) / omega, guarded at omega ~ 0."""
    omega = p[..., 4:5]
    r = torch.sqrt(torch.sum(uv * uv, dim=-1, keepdim=True) + 1e-24)
    tan_half = torch.tan(omega / 2.0)
    scale = torch.where(
        r > 1e-8,
        torch.arctan(2.0 * r * tan_half) / torch.clamp(omega * r, min=1e-24),
        2.0 * tan_half / torch.clamp(omega, min=1e-24))
    return uv * torch.where(torch.abs(omega) < 1e-6, 1.0, scale)


def _undistort_fov(p, uv):
    """The FOV model's closed-form inverse."""
    omega = p[..., 4:5]
    r = torch.sqrt(torch.sum(uv * uv, dim=-1, keepdim=True) + 1e-24)
    tan_half = torch.tan(omega / 2.0)
    scale = torch.where(
        r > 1e-8,
        torch.tan(r * omega) / torch.clamp(2.0 * r * tan_half, min=1e-24),
        omega / torch.clamp(2.0 * tan_half, min=1e-24))
    return uv * torch.where(torch.abs(omega) < 1e-6, 1.0, scale)


def _fisheye_wrap(distort_fn):
    """A radial model applied to the equidistant (theta) projection."""

    def fn(p, uv):
        r, theta = _fisheye_theta(uv)
        return distort_fn(p, uv * torch.where(r > 1e-8, theta / r, 1.0))

    return fn


def _tangential_prism(x, r2, p1, p2, sx1, sy1, radial):
    """x + x * radial + tangential + thin-prism terms on the (..., 2)
    point x with r2 = |x|^2."""
    u, v = x[..., :1], x[..., 1:2]
    uvp = u * v
    du = (u * radial + 2.0 * p1 * uvp + p2 * (r2 + 2.0 * u * u)
          + sx1 * r2)
    dv = (v * radial + 2.0 * p2 * uvp + p1 * (r2 + 2.0 * v * v)
          + sy1 * r2)
    return torch.cat([u + du, v + dv], dim=-1)


def _thin_prism(p, x):
    # fx fy cx cy k1 k2 p1 p2 k3 k4 sx1 sy1: the polynomial, tangential and
    # thin-prism terms (on the equidistant point, through _fisheye_wrap)
    k1, k2, k3, k4 = p[..., 4:5], p[..., 5:6], p[..., 8:9], p[..., 9:10]
    r2 = torch.sum(x * x, dim=-1, keepdim=True)
    radial = k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3 + k4 * r2 ** 4
    return _tangential_prism(x, r2, p[..., 6:7], p[..., 7:8], p[..., 10:11],
                             p[..., 11:12], radial)


def _distort_rad_tan_thin_prism_fisheye(p, uv):
    # fx fy cx cy k1 k2 k3 k4 p1 p2 sx1 sy1: the theta polynomial, then the
    # tangential and thin-prism terms on the distorted point
    r, theta = _fisheye_theta(uv)
    theta_d = _theta_poly(p[..., 4:5], p[..., 5:6], p[..., 6:7], p[..., 7:8],
                          theta)
    x = uv * torch.where(r > 1e-8, theta_d / r, 1.0)
    r2 = torch.sum(x * x, dim=-1, keepdim=True)
    return _tangential_prism(x, r2, p[..., 8:9], p[..., 9:10], p[..., 10:11],
                             p[..., 11:12], 0.0)


_DISTORT_FNS = {
    CameraModelId.SIMPLE_PINHOLE: _distort_identity,
    CameraModelId.PINHOLE: _distort_identity,
    CameraModelId.SIMPLE_RADIAL: _distort_simple_radial,
    CameraModelId.RADIAL: _distort_radial,
    CameraModelId.OPENCV: _distort_opencv,
    CameraModelId.OPENCV_FISHEYE: _distort_opencv_fisheye,
    CameraModelId.FULL_OPENCV: _distort_full_opencv,
    CameraModelId.FOV: _distort_fov,
    CameraModelId.SIMPLE_RADIAL_FISHEYE: _fisheye_wrap(_distort_simple_radial),
    CameraModelId.RADIAL_FISHEYE: _fisheye_wrap(_distort_radial),
    CameraModelId.THIN_PRISM_FISHEYE: _fisheye_wrap(_thin_prism),
    CameraModelId.RAD_TAN_THIN_PRISM_FISHEYE:
        _distort_rad_tan_thin_prism_fisheye,
}


def focal_pp(model_id: int, params: torch.Tensor):
    """Return (fx, fy, cx, cy) each shaped params.shape[:-1]."""
    i_fx, i_fy, i_cx, i_cy = _FXFY_CXCY[CameraModelId(model_id)]
    return (params[..., i_fx], params[..., i_fy], params[..., i_cx],
            params[..., i_cy])


def img_from_cam(model_id: int, params: torch.Tensor,
                 uv: torch.Tensor) -> torch.Tensor:
    """Normalized camera coords (..., 2) -> pixel coords (..., 2)."""
    duv = _DISTORT_FNS[CameraModelId(model_id)](params, uv)
    fx, fy, cx, cy = focal_pp(model_id, params)
    x = fx[..., None] * duv[..., :1] + cx[..., None]
    y = fy[..., None] * duv[..., 1:2] + cy[..., None]
    return torch.cat([x, y], dim=-1)


def project(model_id: int, params: torch.Tensor,
            p_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2) (z > 0 assumed)."""
    z = p_cam[..., 2:3]
    uv = p_cam[..., :2] / torch.where(torch.abs(z) > 1e-12, z, 1e-12)
    return img_from_cam(model_id, params, uv)


_NEWTON_ITERS = 25


def cam_from_img(model_id: int, params: torch.Tensor,
                 xy: torch.Tensor) -> torch.Tensor:
    """Pixel coords (..., 2) -> normalized camera coords (..., 2).

    Closed form for the pinhole models and FOV; otherwise 25 Newton steps on the
    distortion with its true 2x2 Jacobian (a Python loop where JAX uses
    fori_loop).
    """
    mid = CameraModelId(model_id)
    distort = _DISTORT_FNS[mid]
    fx, fy, cx, cy = focal_pp(model_id, params)
    duv = torch.stack([(xy[..., 0] - cx) / fx, (xy[..., 1] - cy) / fy],
                      dim=-1)
    if mid in (CameraModelId.SIMPLE_PINHOLE, CameraModelId.PINHOLE):
        return duv
    if mid == CameraModelId.FOV:
        return _undistort_fov(params, duv)

    def fn(q):
        return distort(params, q)

    # each point's distortion depends on that point only, so the vector-
    # Jacobian product with the cotangent e_u (e_v) gives every point's
    # first (second) Jacobian row
    e_u = torch.stack([torch.ones_like(duv[..., 0]),
                       torch.zeros_like(duv[..., 0])], -1)
    e_v = torch.stack([torch.zeros_like(duv[..., 0]),
                       torch.ones_like(duv[..., 0])], -1)
    uv = duv
    for _ in range(_NEWTON_ITERS):
        f, vjp_fn = torch.func.vjp(fn, uv)
        (row_u,), (row_v,) = vjp_fn(e_u), vjp_fn(e_v)
        r = f - duv
        a, b = row_u[..., 0], row_u[..., 1]
        c, d = row_v[..., 0], row_v[..., 1]
        det = a * d - b * c
        det = torch.where(torch.abs(det) > 1e-12, det,
                          torch.full_like(det, 1e-12))
        du = (d * r[..., 0] - b * r[..., 1]) / det
        dv = (-c * r[..., 0] + a * r[..., 1]) / det
        uv = uv - torch.stack([du, dv], dim=-1)
    return uv


def apply_model(fn_table, model_ids: torch.Tensor, params: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Mixed-model dispatch over rows: row i gets fn_table[k](k, params[i],
    x[i]) for its model id k. The rows are grouped by branch, each branch
    runs once on its group and the results are scattered back. A branch is
    chosen as the JAX package's lax.switch chooses it: the id's position
    among the table's keys (searchsorted), clamped to the last branch.
    model_ids (B,), params (B, P), x (B, ..., D)."""
    keys = list(fn_table.keys())
    key_ids = torch.as_tensor([int(k) for k in keys], device=model_ids.device)
    branch = torch.clamp(torch.searchsorted(key_ids, model_ids.to(key_ids.dtype)),
                         0, len(keys) - 1)
    mid = (1,) * (x.dim() - 2)
    out = None
    for b, k in enumerate(keys):
        rows = torch.nonzero(branch == b)[:, 0]
        if rows.numel() == 0:
            continue
        p = params[rows].reshape((len(rows),) + mid + params.shape[1:])
        y = fn_table[k](k, p, x[rows])
        if out is None:
            out = y.new_zeros((x.shape[0],) + y.shape[1:])
        out = out.index_copy(0, rows, y)
    return out


def default_params(model_id: int, focal: float, width: int,
                   height: int) -> np.ndarray:
    """The padded (MAX_PARAMS,) float32 parameters of a new camera: the
    focal length, the image centre as principal point, no distortion
    (reference: Camera::CreateFromModelId)."""
    mid = CameraModelId(model_id)
    i_fx, i_fy, i_cx, i_cy = _FXFY_CXCY[mid]
    params = [0.0] * NUM_PARAMS[mid]
    params[i_fx] = params[i_fy] = focal
    params[i_cx] = width / 2.0
    params[i_cy] = height / 2.0
    return pad_params(params)
