"""Least absolute deviations (L1) linear solver by iteratively reweighted
least squares.

Port of colmap_tpu/optim/least_absolute_deviations.py (reference:
optim/least_absolute_deviations.h): a fixed number of IRLS iterations,
each one weighted least-squares solve of the normal equations, with the
weights 1 / max(|r|, eps). The coordinate-frame estimation uses it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LADOptions:
    max_num_iterations: int = 30
    eps: float = 1e-6  # IRLS weight floor (|r| clamp)


def solve_lad(A: torch.Tensor, b: torch.Tensor,
              options: LADOptions = LADOptions()) -> torch.Tensor:
    """argmin_x ||A x - b||_1 for A (m, n), b (m,) on their device."""
    n = A.shape[1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)

    def ls(w):
        Aw = A * w[:, None]
        return torch.linalg.solve(Aw.T @ A + 1e-10 * eye, Aw.T @ b)

    x = ls(torch.ones(A.shape[0], dtype=A.dtype, device=A.device))
    for _ in range(options.max_num_iterations):
        r = A @ x - b
        x = ls(1.0 / torch.clamp(torch.abs(r), min=options.eps))
    return x
