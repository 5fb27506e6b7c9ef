"""Vote-and-verify re-ranking for retrieval.

A copy of colmap_tpu/retrieval/vote_and_verify.py (host numpy). Reference:
src/colmap/retrieval/vote_and_verify.h:40-70 (ACCV'16 Hough voting on a 2D
similarity transform, followed by affine verification). It bins all
tentative correspondences into the 4D transform space (tx, ty, log-scale,
rotation) with one bincount, then refines the best bin with a
least-squares affine fit and counts inliers.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class VoteAndVerifyOptions:
    num_transl_bins: int = 16
    num_scale_bins: int = 8
    num_angle_bins: int = 8
    max_image_size: float = 1024.0
    inlier_threshold_px: float = 8.0


def vote_and_verify(xy1: np.ndarray, scale1: np.ndarray, ori1: np.ndarray,
                    xy2: np.ndarray, scale2: np.ndarray, ori2: np.ndarray,
                    options: VoteAndVerifyOptions = VoteAndVerifyOptions()
                    ) -> Tuple[float, int]:
    """Score matched keypoint lists (same length, index-aligned).

    Returns (score, num_inliers) of the best similarity-transform bin after
    affine refinement.
    """
    n = len(xy1)
    if n < 3:
        return 0.0, 0
    ds = np.log2(np.maximum(scale2, 1e-6) / np.maximum(scale1, 1e-6))
    da = np.mod(ori2 - ori1 + np.pi, 2 * np.pi) - np.pi
    s = 2.0 ** ds
    ca, sa = np.cos(da), np.sin(da)
    # translation implied by each correspondence under its similarity
    tx = xy2[:, 0] - s * (ca * xy1[:, 0] - sa * xy1[:, 1])
    ty = xy2[:, 1] - s * (sa * xy1[:, 0] + ca * xy1[:, 1])

    o = options
    bs = np.clip(((ds + 4) / 8 * o.num_scale_bins).astype(int), 0,
                 o.num_scale_bins - 1)
    ba = np.clip(((da + np.pi) / (2 * np.pi) * o.num_angle_bins).astype(int),
                 0, o.num_angle_bins - 1)
    bx = np.clip(((tx + o.max_image_size) / (2 * o.max_image_size)
                  * o.num_transl_bins).astype(int), 0, o.num_transl_bins - 1)
    by = np.clip(((ty + o.max_image_size) / (2 * o.max_image_size)
                  * o.num_transl_bins).astype(int), 0, o.num_transl_bins - 1)
    flat = ((bs * o.num_angle_bins + ba) * o.num_transl_bins + bx) \
        * o.num_transl_bins + by
    counts = np.bincount(flat, minlength=0)
    best = int(np.argmax(counts))
    members = flat == best
    if members.sum() < 3:
        return float(counts.max()), int(members.sum())

    # affine refinement on the bin members (reference: affine verification)
    A = np.zeros((2 * members.sum(), 6))
    b = xy2[members].reshape(-1)
    p = xy1[members]
    A[0::2, 0] = p[:, 0]
    A[0::2, 1] = p[:, 1]
    A[0::2, 2] = 1
    A[1::2, 3] = p[:, 0]
    A[1::2, 4] = p[:, 1]
    A[1::2, 5] = 1
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    M = np.array([[sol[0], sol[1], sol[2]], [sol[3], sol[4], sol[5]]])
    pred = np.c_[xy1, np.ones(n)] @ M.T
    err = np.linalg.norm(pred - xy2, axis=1)
    inl = int((err < o.inlier_threshold_px).sum())
    return float(inl), inl
