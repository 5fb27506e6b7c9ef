"""Coordinate-frame estimation: gravity and Manhattan-world alignment.

Port of colmap_tpu/estimators/coordinate_frame.py (reference:
estimators/coordinate_frame.h: EstimateGravityVectorFromImageOrientation,
the mean camera "down" direction, and EstimateManhattanWorldFrame: line
segments -> interpretation-plane normals -> dominant orthogonal axes).

The axis fit keeps the JAX package's 512 RANSAC pairs, drawn in the same
order from np.random.default_rng(seed), so both packages pick the same
axes; the port scores all 512 candidate axes against every normal in one
batched product on the device and keeps the first best (the JAX loop's
strict `>`). Line detection needs OpenCV (image/line.py).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.image.line import detect_line_segments
from colmap_tpu_torch.sensor import bitmap as bitmap_mod
from colmap_tpu_torch.sensor import models as cm

logger = logging.getLogger("colmap_tpu_torch")


def _quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def estimate_gravity_vector_from_image_orientation(rec) -> np.ndarray:
    """Mean camera 'down' direction in world coords
    (reference: EstimateGravityVectorFromImageOrientation)."""
    downs = [_quat_to_rotmat(rec.images[iid].cam_from_world[:4]).T
             @ np.array([0.0, 1.0, 0.0])
             for iid in rec.registered_image_ids()]
    if not downs:
        raise ValueError("no registered images")
    d = np.mean(downs, 0)
    return d / np.linalg.norm(d)


def line_plane_normals(rec, image_dir: str, min_length: float = 20.0,
                       max_images: Optional[int] = None) -> np.ndarray:
    """World-frame normals of the interpretation planes of detected 2D line
    segments: n = R^T (K^-1 p1 x K^-1 p2). A 3D direction d parallel to the
    segment's 3D line satisfies n . d = 0."""
    normals = []
    ids = rec.registered_image_ids()
    if max_images:
        ids = ids[:max_images]
    for iid in ids:
        im = rec.images[iid]
        path = os.path.join(image_dir, im.name)
        if not os.path.exists(path):
            continue
        cam = rec.cameras[im.camera_id]
        i_fx, i_fy, i_cx, i_cy = cm._FXFY_CXCY[cm.CameraModelId(cam.model_id)]
        K = np.array([[cam.params[i_fx], 0, cam.params[i_cx]],
                      [0, cam.params[i_fy], cam.params[i_cy]],
                      [0, 0, 1.0]])
        Kinv = np.linalg.inv(K)
        R = _quat_to_rotmat(im.cam_from_world[:4])
        bmp = bitmap_mod.read_bitmap(path)
        for seg in detect_line_segments(bmp.data, min_length):
            p1 = Kinv @ np.array([seg.start[0], seg.start[1], 1.0])
            p2 = Kinv @ np.array([seg.end[0], seg.end[1], 1.0])
            n = np.cross(p1, p2)
            nl = np.linalg.norm(n)
            if nl < 1e-9:
                continue
            normals.append(R.T @ (n / nl))
    return np.stack(normals) if normals else np.zeros((0, 3))


def _fit_axis(normals: np.ndarray, inlier_thresh: float = 0.02,
              num_trials: int = 512, seed: int = 0,
              constraint: Optional[np.ndarray] = None,
              device="cuda") -> Optional[np.ndarray]:
    """RANSAC axis d with n.d ~= 0 for many normals, with an optional
    orthogonality constraint to a previous axis."""
    if len(normals) < 10:
        return None
    rng = np.random.default_rng(seed)
    pairs = np.array([rng.choice(len(normals), 2, replace=False)
                      for _ in range(num_trials)])
    d = np.cross(normals[pairs[:, 0]], normals[pairs[:, 1]])
    nl = np.linalg.norm(d, axis=1)
    ok = nl >= 1e-6
    d = d / np.where(ok, nl, 1.0)[:, None]
    if constraint is not None:
        d = d - (d @ constraint)[:, None] * constraint
        nl = np.linalg.norm(d, axis=1)
        ok &= nl >= 0.3
        d = d / np.where(nl > 0, nl, 1.0)[:, None]
    n_dev = torch.as_tensor(normals, dtype=torch.float64, device=device)
    d_dev = torch.as_tensor(d, dtype=torch.float64, device=device)
    inl = (torch.abs(n_dev @ d_dev.T) < inlier_thresh).sum(0)
    inl = torch.where(torch.as_tensor(ok, device=device), inl,
                      torch.full_like(inl, -1))
    k = int(torch.argmax(inl))  # the first of the best, as the loop's `>`
    best, best_inl = d[k], int(inl[k])
    if best_inl < 0 or best_inl < max(10, 0.05 * len(normals)):
        return None
    # refine: smallest eigenvector of the inlier normal scatter
    m = np.abs(normals @ best) < inlier_thresh
    S = normals[m].T @ normals[m]
    if constraint is not None:
        S = S + 1e3 * np.outer(constraint, constraint)
    _, v = np.linalg.eigh(S)
    return v[:, 0] / np.linalg.norm(v[:, 0])


def estimate_manhattan_world_frame(rec, image_dir: str,
                                   max_images: Optional[int] = 20,
                                   device="cuda") -> Optional[np.ndarray]:
    """Rotation R_aligned_from_world whose rows are the Manhattan axes
    (x horizontal, y = gravity / down, z horizontal), or None.

    Reference: EstimateManhattanWorldFrame (coordinate_frame.cc)."""
    normals = line_plane_normals(rec, image_dir, max_images=max_images)
    if len(normals) < 20:
        logger.warning("too few line segments (%d) for Manhattan estimation",
                       len(normals))
        return None
    gravity = estimate_gravity_vector_from_image_orientation(rec)
    # vertical axis: seeded by gravity; refit on consistent normals
    down = _fit_axis(normals, seed=0, device=device)
    if down is None or abs(np.dot(down, gravity)) < 0.7:
        down = gravity
    if np.dot(down, gravity) < 0:
        down = -down
    axis_h1 = _fit_axis(normals, seed=1, constraint=down, device=device)
    if axis_h1 is None:
        return None
    # exact orthogonalization (the RANSAC constraint is soft)
    axis_h1 = axis_h1 - np.dot(axis_h1, down) * down
    axis_h1 /= np.linalg.norm(axis_h1)
    axis_h2 = np.cross(down, axis_h1)
    axis_h2 /= np.linalg.norm(axis_h2)
    R = np.stack([axis_h1, down, axis_h2])
    if np.linalg.det(R) < 0:  # a proper rotation
        R[2] = -R[2]
    return R


def align_to_manhattan_world(rec, image_dir: str, device="cuda"):
    """A copy of the reconstruction in its Manhattan frame; falls back to
    the gravity-only alignment when no frame is found."""
    from colmap_tpu_torch.tools.model_tools import (
        align_model_orientation, transform_model)

    R = estimate_manhattan_world_frame(rec, image_dir, device=device)
    if R is None:
        return align_model_orientation(rec)
    q = rot.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float32))
    t = np.concatenate([[1.0], q.numpy().astype(np.float64), [0.0, 0.0, 0.0]])
    return transform_model(rec, t)
