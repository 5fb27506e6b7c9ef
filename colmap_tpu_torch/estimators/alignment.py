"""Reconstruction alignment and merging.

Port of colmap_tpu/estimators/alignment.py (reference:
estimators/alignment.h:15-69): robust (RANSAC) Sim3 alignment of two models
over their common projection centres or common 3D points, model merging for
the hierarchical mapper, and the per-image alignment error report.
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import numpy as np
import torch

from colmap_tpu_torch.estimators.similarity_transform import (
    compare_reconstructions,
    estimate_sim3,
)
from colmap_tpu_torch.geometry import sim3 as sim3_mod


def common_point_pairs(rec_src, rec_dst, max_pairs: int = 2000
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """3D point pairs whose tracks share an (image, point2D) observation
    (reference: AlignReconstructionsViaPoints)."""
    src_pts, dst_pts = [], []
    dst_imgs = rec_dst.images
    for pt in rec_src.points3D.values():
        for (iid, p2d) in pt.track:
            im = dst_imgs.get(iid)
            if im is None or len(im.point3D_ids) <= p2d:
                continue
            dpid = int(im.point3D_ids[p2d])
            if dpid >= 0 and dpid in rec_dst.points3D:
                src_pts.append(pt.xyz)
                dst_pts.append(rec_dst.points3D[dpid].xyz)
                break
        if len(src_pts) >= max_pairs:
            break
    if not src_pts:
        return np.zeros((0, 3)), np.zeros((0, 3))
    return np.stack(src_pts), np.stack(dst_pts)


def align_reconstructions_robust(rec_src, rec_dst, max_error: float = 0.1,
                                 num_trials: int = 256, seed: int = 0,
                                 device="cuda") -> Optional[np.ndarray]:
    """RANSAC Sim3 (float64 (8,), dst_from_src) over the common projection
    centres, or over common 3D points when fewer than 3 images are shared;
    None when fewer than 3 correspondences agree.

    The JAX package fits and scores its trials one at a time and stops at
    the first trial whose inliers are all points. Here all `num_trials`
    minimal samples are drawn first, from the same generator in the same
    order, then fitted in one batched Umeyama call and scored in one
    batched transform; the first trial with the most inliers is the one
    the sequential loop ends on. The refit on its inliers is a weighted
    Umeyama, and the result is read back to the host once."""
    common = sorted(set(rec_src.registered_image_ids())
                    & set(rec_dst.registered_image_ids()))
    if len(common) >= 3:
        src = np.stack([rec_src.images[i].projection_center()
                        for i in common])
        dst = np.stack([rec_dst.images[i].projection_center()
                        for i in common])
    else:
        src, dst = common_point_pairs(rec_src, rec_dst)
        if len(src) < 3:
            return None
    n = len(src)
    rng = np.random.default_rng(seed)
    sel = np.stack([rng.choice(n, 3, replace=False)
                    for _ in range(num_trials)])
    src_t = torch.as_tensor(src, dtype=torch.float32, device=device)
    dst_t = torch.as_tensor(dst, dtype=torch.float32, device=device)
    sel_t = torch.as_tensor(sel, device=device)
    trials = estimate_sim3(src_t[sel_t], dst_t[sel_t])  # (T, 8)
    err = torch.linalg.norm(sim3_mod.apply(trials[:, None, :], src_t[None])
                            - dst_t[None], dim=-1)
    inl = (err < max_error).sum(dim=1)
    best_inl = inl.max()
    order = torch.arange(num_trials, device=inl.device)
    best = torch.min(torch.where(inl == best_inl, order, num_trials))
    mask = (err[best] < max_error).to(torch.float32)
    refit = estimate_sim3(src_t, dst_t, weights=mask)
    out = torch.cat([best_inl.to(torch.float32)[None], refit]).cpu().numpy()
    if out[0] < 3:
        return None
    return out[1:].astype(np.float64)


def merge_reconstructions(rec_dst, rec_src, max_reproj_error: float = 8.0,
                          max_proj_center_error: float = 0.1,
                          precomputed_sim3: Optional[np.ndarray] = None,
                          device="cuda") -> bool:
    """Merge rec_src INTO rec_dst (in place).

    Reference: MergeReconstructions (estimators/alignment.cc): align src to
    dst via common registered images, transform, transfer novel images, and
    fuse 3D points whose tracks share observations. `precomputed_sim3`
    skips the alignment (the hierarchical mapper's pose graph has already
    placed every cluster in the global frame).
    """
    t = precomputed_sim3
    if t is None:
        t = align_reconstructions_robust(rec_src, rec_dst,
                                         max_error=max_proj_center_error,
                                         device=device)
    if t is None:
        return False
    src = copy.deepcopy(rec_src)
    src.transform(t)

    for cid, cam in src.cameras.items():
        if cid not in rec_dst.cameras:
            rec_dst.cameras[cid] = cam

    common = (set(rec_dst.registered_image_ids())
              & set(src.registered_image_ids()))
    for iid, img in src.images.items():
        if not img.registered or iid in common:
            continue
        if iid in rec_dst.images and rec_dst.images[iid].registered:
            continue
        new_img = copy.deepcopy(img)
        new_img.point3D_ids = np.full(len(img.xys), -1, np.int64)
        rec_dst.images[iid] = new_img

    # fuse points: a src track observation (image, p2d) that already has a
    # dst point merges the tracks; otherwise a new point is added
    for pt in src.points3D.values():
        dst_pid = -1
        for (iid, p2d) in pt.track:
            im = rec_dst.images.get(iid)
            if (im is not None and len(im.point3D_ids) > p2d
                    and im.point3D_ids[p2d] >= 0):
                dst_pid = int(im.point3D_ids[p2d])
                break
        new_obs = [(iid, p2d) for (iid, p2d) in pt.track
                   if iid in rec_dst.images
                   and rec_dst.images[iid].registered
                   and len(rec_dst.images[iid].point3D_ids) > p2d]
        if dst_pid >= 0:
            dst_pt = rec_dst.points3D[dst_pid]
            have = set(map(tuple, dst_pt.track))
            for obs in new_obs:
                if (tuple(obs) not in have
                        and rec_dst.images[obs[0]].point3D_ids[obs[1]] < 0):
                    dst_pt.track.append(obs)
                    rec_dst.images[obs[0]].point3D_ids[obs[1]] = dst_pid
            dst_pt.xyz = 0.5 * (dst_pt.xyz + pt.xyz)  # average the positions
        else:
            obs = [o for o in new_obs
                   if rec_dst.images[o[0]].point3D_ids[o[1]] < 0]
            if len(obs) >= 2:
                rec_dst.add_point3D(pt.xyz, obs, color=pt.color)
    return True


def alignment_errors(rec_test, rec_gt, device="cuda") -> Optional[dict]:
    """Per-image errors after alignment (reference:
    ComputeImageAlignmentError, alignment.h)."""
    return compare_reconstructions(rec_test, rec_gt, device=device)
