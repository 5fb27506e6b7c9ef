"""Homography estimation (4-point DLT + weighted refit + transfer residual).

Port of colmap_tpu/estimators/homography_matrix.py, batched over leading
axes.
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.estimators.utils import (
    inv, least_singular_vector, normalize_points)


def _dlt_rows(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """The 2N x 9 DLT constraint rows for x2 ~ H x1."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)
    r1 = torch.stack([-x1, -y1, -one, zero, zero, zero, x1 * x2, y1 * x2, x2],
                     dim=-1)
    r2 = torch.stack([zero, zero, zero, -x1, -y1, -one, x1 * y2, y1 * y2, y2],
                     dim=-1)
    return torch.cat([r1, r2], dim=-2)


def _solve_dlt(p1, p2, weights=None):
    p1n, T1 = normalize_points(p1, weights)
    p2n, T2 = normalize_points(p2, weights)
    A = _dlt_rows(p1n, p2n)  # (..., 2N, 9)
    if weights is not None:
        w2 = torch.cat([weights, weights], dim=-1)
        A = A * torch.sqrt(w2)[..., None]
    h = least_singular_vector(A)
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    H = inv(T2) @ Hn @ T1
    s = H[..., 2:3, 2:3]
    H = H / torch.where(torch.abs(s) > 1e-8, s, torch.ones_like(s))
    ok = torch.isfinite(H).all(-1).all(-1)
    return H, ok


def solve_4pt(p1: torch.Tensor, p2: torch.Tensor):
    """Minimal 4-point homography. p1/p2 (..., 4, 2) -> (..., 1, 3, 3),
    (..., 1) valid."""
    H, ok = _solve_dlt(p1, p2)
    return H[..., None, :, :], ok[..., None]


def refit(model, data: tuple, weights: torch.Tensor):
    """Weighted non-minimal DLT over all points (LO step)."""
    del model
    p1, p2 = data
    return _solve_dlt(p1, p2, weights)


def residuals(H: torch.Tensor, data: tuple) -> torch.Tensor:
    """Squared transfer error ||x2 - proj(H x1)||^2; H (..., 3, 3) against
    points (..., N, 2) whose leading axes broadcast with H's."""
    p1, p2 = data

    def h(i, j):
        return H[..., i, j, None]

    x = h(0, 0) * p1[..., 0] + h(0, 1) * p1[..., 1] + h(0, 2)
    y = h(1, 0) * p1[..., 0] + h(1, 1) * p1[..., 1] + h(1, 2)
    w = h(2, 0) * p1[..., 0] + h(2, 1) * p1[..., 1] + h(2, 2)
    w = torch.where(torch.abs(w) > 1e-12, w, torch.full_like(w, 1e-12))
    dx = x / w - p2[..., 0]
    dy = y / w - p2[..., 1]
    return dx * dx + dy * dy
