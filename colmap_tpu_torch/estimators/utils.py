"""Shared estimator helpers (batched, f32).

Port of colmap_tpu/estimators/utils.py, plus guarded linear-algebra calls.
JAX's batched SVD / eigh / solve return NaN for a non-finite or singular
element and carry on; torch's raise for the whole batch. The guarded
versions below run on sanitized inputs and put NaN back where the input was
not finite, so one degenerate RANSAC sample behaves as it does in JAX.
"""

from __future__ import annotations

import torch


def _sanitize(A: torch.Tensor):
    bad = ~torch.isfinite(A).all(dim=-1).all(dim=-1)
    return torch.where(bad[..., None, None], torch.zeros_like(A), A), bad


def _poison(x: torch.Tensor, bad: torch.Tensor, extra_dims: int):
    nan = torch.full_like(x, float("nan"))
    return torch.where(bad.reshape(bad.shape + (1,) * extra_dims), nan, x)


def svd(A: torch.Tensor, full_matrices: bool = True):
    """Batched SVD; NaN outputs where A holds a non-finite entry."""
    A0, bad = _sanitize(A)
    U, s, Vt = torch.linalg.svd(A0, full_matrices=full_matrices)
    return _poison(U, bad, 2), _poison(s, bad, 1), _poison(Vt, bad, 2)


def eigh(A: torch.Tensor):
    """Batched symmetric eigendecomposition, ascending eigenvalues."""
    A0, bad = _sanitize(A)
    w, V = torch.linalg.eigh(A0)
    return _poison(w, bad, 1), _poison(V, bad, 2)


def solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched A X = B; NaN where A is singular or not finite."""
    A0, bad = _sanitize(A)
    X, info = torch.linalg.solve_ex(A0, B)
    return _poison(X, bad | (info != 0), B.dim() - A.dim() + 2)


def inv(A: torch.Tensor) -> torch.Tensor:
    A0, bad = _sanitize(A)
    X, info = torch.linalg.inv_ex(A0)
    return _poison(X, bad | (info != 0), 2)


def normalize_points(pts: torch.Tensor, weights: torch.Tensor | None = None):
    """Hartley isotropic normalization of (..., N, 2) points.

    Returns (pts_norm, T (..., 3, 3)) with T mapping original -> normalized
    homogeneous coordinates (weighted variant for LO refits).
    """
    if weights is None:
        w = torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    else:
        w = weights
    wsum = torch.sum(w, dim=-1, keepdim=True) + 1e-12
    centroid = (torch.sum(pts * w[..., None], dim=-2, keepdim=True)
                / wsum[..., None])
    d = torch.linalg.norm(pts - centroid, dim=-1)
    mean_dist = torch.sum(d * w, dim=-1, keepdim=True) / wsum
    scale = 2.0 ** 0.5 / torch.clamp(mean_dist, min=1e-12)
    pts_norm = (pts - centroid) * scale[..., None]
    s = scale[..., 0]
    cx = centroid[..., 0, 0]
    cy = centroid[..., 0, 1]
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    T = torch.stack([s, zero, -s * cx, zero, s, -s * cy, zero, zero, one],
                    dim=-1).reshape(pts.shape[:-2] + (3, 3))
    return pts_norm, T


def least_singular_vector(A: torch.Tensor) -> torch.Tensor:
    """Right singular vector of the smallest singular value of A (..., M, D)."""
    full = A.shape[-2] < A.shape[-1]  # need the full V when underdetermined
    _, _, Vt = svd(A, full_matrices=full)
    return Vt[..., -1, :]


def nullspace_from_rows(A: torch.Tensor, k: int) -> torch.Tensor:
    """Last-k right singular vectors of A (..., M, D) -> (..., D, k)."""
    _, _, Vt = svd(A, full_matrices=True)
    return Vt[..., -k:, :].transpose(-1, -2)
