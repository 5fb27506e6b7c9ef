"""Planar stereo rectification of posed image pairs.

Port of colmap_tpu/image/rectification.py (reference: RunImageRectifier,
exe/image.cc / StereoRectifier): warps two undistorted (pinhole) images so
epipolar lines become horizontal scanlines. Fusiello-style rectifying
rotation (shared x-axis along the baseline, z from the mean optical axis)
in float64 numpy; the warps are single homography resamples
(image/warp.py) on `device`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from colmap_tpu_torch.geometry import rotation
from colmap_tpu_torch.image import warp as warp_mod


def _quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    q = torch.as_tensor(np.asarray(q, np.float64))
    return rotation.quat_to_rotmat(q / torch.linalg.vector_norm(q)).numpy()


def rectify_stereo_pair(K1: np.ndarray, K2: np.ndarray,
                        cam1_from_world: np.ndarray,
                        cam2_from_world: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Rectifying homographies (H1, H2), shared new K, and the baseline.

    Returns (H1, H2, K_new, baseline) with H_i mapping ORIGINAL pixel ->
    rectified pixel.
    """
    R1 = _quat_to_rotmat(cam1_from_world[:4])
    R2 = _quat_to_rotmat(cam2_from_world[:4])
    c1 = -R1.T @ cam1_from_world[4:7]
    c2 = -R2.T @ cam2_from_world[4:7]

    # new axes (world frame)
    x_axis = c2 - c1
    baseline = float(np.linalg.norm(x_axis))
    if baseline < 1e-9:
        raise ValueError("zero baseline")
    x_axis = x_axis / baseline
    z_mean = 0.5 * (R1[2] + R2[2])
    y_axis = np.cross(z_mean, x_axis)
    y_axis /= np.linalg.norm(y_axis)
    z_axis = np.cross(x_axis, y_axis)
    R_rect = np.stack([x_axis, y_axis, z_axis])  # world->rect rows

    K_new = 0.5 * (K1 + K2)
    K_new[0, 1] = 0.0
    H1 = K_new @ R_rect @ R1.T @ np.linalg.inv(K1)
    H2 = K_new @ R_rect @ R2.T @ np.linalg.inv(K2)
    return H1, H2, K_new, baseline


def rectify_images(img1: np.ndarray, img2: np.ndarray,
                   K1: np.ndarray, K2: np.ndarray,
                   cam1_from_world: np.ndarray, cam2_from_world: np.ndarray,
                   device="cuda") -> Tuple[np.ndarray, np.ndarray, dict]:
    """Warp an undistorted stereo pair into the rectified frame."""
    H1, H2, K_new, baseline = rectify_stereo_pair(
        K1, K2, cam1_from_world, cam2_from_world)
    shape = img1.shape[:2]

    def warp(img, H):
        return warp_mod.warp_with_homography(
            torch.as_tensor(np.asarray(img, np.float32), device=device),
            torch.as_tensor(H, dtype=torch.float32, device=device),
            shape).cpu().numpy()

    return (warp(img1, H1), warp(img2, H2),
            dict(H1=H1, H2=H2, K=K_new, baseline=baseline))
