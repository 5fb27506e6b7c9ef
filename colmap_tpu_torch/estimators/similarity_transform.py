"""Similarity transform estimation and reconstruction alignment.

Port of colmap_tpu/estimators/similarity_transform.py (estimate_sim3,
align_reconstructions_via_proj_centers, compare_reconstructions,
estimate_translation, estimate_affine2d; reference:
estimators/similarity_transform.h, estimators/alignment.h,
translation_transform.h, affine_transform.h).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from colmap_tpu_torch.estimators.utils import svd
from colmap_tpu_torch.geometry import rigid3, rotation as rot, sim3


def estimate_sim3(src: torch.Tensor, dst: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  with_scale: bool = True) -> torch.Tensor:
    """Umeyama alignment dst ~= s R src + t of (..., N, 3) point sets.
    Returns Sim3 (..., 8)."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    wsum = torch.sum(weights, dim=-1, keepdim=True) + 1e-12
    mu_s = torch.sum(src * weights[..., None], dim=-2) / wsum
    mu_d = torch.sum(dst * weights[..., None], dim=-2) / wsum
    s_c = src - mu_s[..., None, :]
    d_c = dst - mu_d[..., None, :]
    cov = (torch.einsum("...ni,...nj,...n->...ij", d_c, s_c, weights)
           / wsum[..., None])
    U, S, Vt = svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    D = torch.cat([torch.ones_like(S[..., :2]), torch.sign(det)[..., None]],
                  dim=-1)
    R = U @ (D[..., :, None] * Vt)
    var_s = (torch.sum(weights * torch.sum(s_c * s_c, dim=-1), dim=-1)
             / wsum[..., 0])
    if with_scale:
        scale = torch.sum(S * D, dim=-1) / torch.clamp(var_s, min=1e-12)
    else:
        scale = torch.ones_like(var_s)
    t = mu_d - scale[..., None] * torch.einsum("...ij,...j->...i", R, mu_s)
    return sim3.make(scale, rot.rotmat_to_quat(R), t)


def align_reconstructions_via_proj_centers(rec_src, rec_dst, with_scale=True,
                                           device="cuda"):
    """Sim3 aligning the src model to dst on their common registered
    images. Returns (sim3 (8,) numpy float64, common image ids)."""
    common = sorted(set(rec_src.registered_image_ids())
                    & set(rec_dst.registered_image_ids()))
    if len(common) < 3:
        return None, common
    src = np.stack([rec_src.images[i].projection_center() for i in common])
    dst = np.stack([rec_dst.images[i].projection_center() for i in common])
    t = estimate_sim3(
        torch.as_tensor(src, dtype=torch.float32, device=device),
        torch.as_tensor(dst, dtype=torch.float32, device=device),
        with_scale=with_scale)
    return t.cpu().numpy().astype(np.float64), common


def compare_reconstructions(rec_test, rec_gt, device="cuda"):
    """Per-image rotation (deg) and projection-centre errors after Sim3
    alignment (the reference's model_comparer metric). Returns None when
    fewer than 3 images are common."""
    t, common = align_reconstructions_via_proj_centers(rec_test, rec_gt,
                                                       device=device)
    if t is None:
        return None
    tt = torch.as_tensor(t, dtype=torch.float32, device=device)
    poses_t = torch.stack([
        torch.as_tensor(rec_test.images[i].cam_from_world,
                        dtype=torch.float32, device=device) for i in common])
    aligned = sim3.transform_rigid(tt, poses_t)
    centers = rigid3.projection_center(aligned).cpu().numpy()
    aligned = aligned.cpu().numpy()
    rot_errors, center_errors = {}, {}
    for k, iid in enumerate(common):
        im_g = rec_gt.images[iid]
        q_t = aligned[k, :4] / np.linalg.norm(aligned[k, :4])
        q_g = im_g.cam_from_world[:4] / np.linalg.norm(im_g.cam_from_world[:4])
        dq = abs(float(np.dot(q_t, q_g)))
        rot_errors[iid] = float(np.degrees(2 * np.arccos(min(1.0, dq))))
        center_errors[iid] = float(np.linalg.norm(
            centers[k] - im_g.projection_center()))
    return dict(
        sim3=t,
        common_images=common,
        rotation_errors_deg=rot_errors,
        center_errors=center_errors,
        max_rotation_error_deg=max(rot_errors.values()),
        max_center_error=max(center_errors.values()),
    )


def estimate_translation(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pure translation dst ~= src + t of (..., N, D) point sets
    (reference: translation_transform.h). Returns (..., D)."""
    return torch.mean(dst - src, dim=-2)


def estimate_affine2d(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Least-squares 2D affine dst ~= M [src; 1] of (..., N, 2) point sets
    (reference: affine_transform.h). Returns M (..., 2, 3).

    QR least squares (lstsq's gels driver, the one CUDA offers) on every
    device. It assumes what the reference's estimator needs: at least
    three points, not all on one line."""
    A = torch.cat([src, torch.ones(src.shape[:-1] + (1,), dtype=src.dtype,
                                   device=src.device)], dim=-1)
    sol = torch.linalg.lstsq(A, dst, driver="gels").solution
    return sol.transpose(-1, -2)
