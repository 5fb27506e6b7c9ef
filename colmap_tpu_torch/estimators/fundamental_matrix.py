"""Fundamental matrix estimation: 7-point, 8-point, Sampson residual.

Port of colmap_tpu/estimators/fundamental_matrix.py. Solvers take points
with any leading batch shape (..., K, 2); the JAX versions are vmapped
instead.
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.estimators.utils import (
    least_singular_vector, normalize_points, nullspace_from_rows, solve, svd)
from colmap_tpu_torch.math.polynomial import cubic_real_roots


def _epipolar_rows(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Rows a s.t. a . vec(F) = x2^T F x1 (vec row-major)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = torch.ones_like(x1)
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                        x1, y1, one], dim=-1)


def solve_7pt(p1: torch.Tensor, p2: torch.Tensor):
    """Minimal 7-point solver. p1/p2 (..., 7, 2) -> (F (..., 3, 3, 3),
    valid (..., 3)); det(a F1 + (1 - a) F2) = 0 is a cubic in a."""
    A = _epipolar_rows(p1, p2)  # (..., 7, 9)
    ns = nullspace_from_rows(A, 2)  # (..., 9, 2)
    F1 = ns[..., :, 0].reshape(ns.shape[:-2] + (3, 3))
    F2 = ns[..., :, 1].reshape(ns.shape[:-2] + (3, 3))

    # the cubic's coefficients from its values at 4 points (Vandermonde)
    ts = torch.tensor([0.0, 1.0, -1.0, 2.0], dtype=p1.dtype,
                      device=p1.device)
    dets = torch.linalg.det(ts[:, None, None] * F1[..., None, :, :]
                            + (1.0 - ts)[:, None, None] * F2[..., None, :, :])
    V = torch.stack([ts ** 3, ts ** 2, ts, torch.ones_like(ts)], dim=-1)
    coeffs = solve(V.expand(dets.shape[:-1] + (4, 4)), dets[..., None])[..., 0]
    roots, valid = cubic_real_roots(coeffs[..., 0], coeffs[..., 1],
                                    coeffs[..., 2], coeffs[..., 3])
    a = roots[..., :, None, None]
    Fs = a * F1[..., None, :, :] + (1.0 - a) * F2[..., None, :, :]
    Fs = Fs / (torch.linalg.norm(Fs, dim=(-2, -1), keepdim=True) + 1e-12)
    valid = valid & torch.isfinite(Fs).all(-1).all(-1)
    return Fs, valid


def _solve_8pt_normalized(p1, p2, weights=None):
    p1n, T1 = normalize_points(p1, weights)
    p2n, T2 = normalize_points(p2, weights)
    A = _epipolar_rows(p1n, p2n)
    if weights is not None:
        A = A * torch.sqrt(weights)[..., None]
    f = least_singular_vector(A)
    F = f.reshape(f.shape[:-1] + (3, 3))
    U, s, Vt = svd(F)  # enforce rank 2
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    F = U @ (s[..., :, None] * Vt)
    F = T2.transpose(-1, -2) @ F @ T1
    F = F / (torch.linalg.norm(F, dim=(-2, -1), keepdim=True) + 1e-12)
    ok = torch.isfinite(F).all(-1).all(-1)
    return F, ok


def solve_8pt(p1: torch.Tensor, p2: torch.Tensor):
    """Normalized 8-point solver. p1/p2 (..., 8+, 2) -> ((..., 1, 3, 3),
    (..., 1))."""
    F, ok = _solve_8pt_normalized(p1, p2)
    return F[..., None, :, :], ok[..., None]


def refit(model, data: tuple, weights: torch.Tensor):
    del model
    p1, p2 = data
    return _solve_8pt_normalized(p1, p2, weights)


def sampson_residuals(F: torch.Tensor, data: tuple) -> torch.Tensor:
    """Squared Sampson error. F (..., 3, 3) against points (..., N, 2) whose
    leading axes broadcast with F's; returns (..., N)."""
    p1, p2 = data
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]

    def f(i, j):
        return F[..., i, j, None]

    Fx1_0 = f(0, 0) * x1 + f(0, 1) * y1 + f(0, 2)
    Fx1_1 = f(1, 0) * x1 + f(1, 1) * y1 + f(1, 2)
    Fx1_2 = f(2, 0) * x1 + f(2, 1) * y1 + f(2, 2)
    Ftx2_0 = f(0, 0) * x2 + f(1, 0) * y2 + f(2, 0)
    Ftx2_1 = f(0, 1) * x2 + f(1, 1) * y2 + f(2, 1)
    num = x2 * Fx1_0 + y2 * Fx1_1 + Fx1_2
    denom = Fx1_0 ** 2 + Fx1_1 ** 2 + Ftx2_0 ** 2 + Ftx2_1 ** 2
    return num * num / torch.clamp(denom, min=1e-12)


residuals = sampson_residuals
