"""Batched RANSAC / LO-RANSAC over a batch of problems.

Port of colmap_tpu/optim/ransac.py. A fixed budget of minimal samples is
solved at once, every hypothesis is scored against every observation
(MSAC truncated loss), the best is refined by a fixed number of
weighted non-minimal refits. The JAX version vmaps one problem; here the
leading axis B of `data` and `valid` is a batch of independent problems
(the pairs of a block), the local optimization is a Python loop where JAX
uses lax.scan, and the hypothesis sweep is split into chunks so that the
(B, hypotheses, N) residuals stay within a memory budget.

`ransac` draws the samples from a torch.Generator and calls
`ransac_from_samples`, the deterministic core, which a test can feed the
JAX package's sample indices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

# residual elements (B x hypotheses x N) scored per chunk
SCORE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class RansacOptions:
    """The fixed-budget subset of colmap_tpu's RansacOptions that the
    front end uses (MSAC support, a fixed number of samples)."""

    max_error: float = 4.0
    num_samples: int = 1024  # minimal samples (hypotheses) per problem
    lo_iterations: int = 3


class RansacResult(NamedTuple):
    model: torch.Tensor  # (B, ...) best model parameters
    inlier_mask: torch.Tensor  # (B, N) bool
    num_inliers: torch.Tensor  # (B,) int
    score: torch.Tensor  # (B,) float (negated MSAC loss; higher better)
    success: torch.Tensor  # (B,) bool


def draw_minimal_samples(generator: torch.Generator, valid: torch.Tensor,
                         num_samples: int, sample_size: int) -> torch.Tensor:
    """Draw (..., num_samples, sample_size) index sets without replacement
    from the valid entries of `valid` (..., N): top-k over random keys."""
    n = valid.shape[-1]
    shape = valid.shape[:-1] + (num_samples, n)
    r = torch.rand(shape, generator=generator, device=valid.device)
    r = torch.where(valid[..., None, :], r,
                    torch.tensor(float("-inf"), device=valid.device))
    return torch.topk(r, sample_size, dim=-1).indices


def _gather_rows(d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """d (B, N, ...) gathered at idx (B, ...) along N -> (B, idx..., ...)."""
    B = d.shape[0]
    flat = idx.reshape(B, -1)
    tail = d.shape[2:]
    g = torch.gather(d, 1, flat.reshape(flat.shape + (1,) * len(tail))
                     .expand(flat.shape + tail))
    return g.reshape(idx.shape + tail)


def ransac_from_samples(
    idx: torch.Tensor,  # (B, S, k) sample indices
    solver: Callable,  # (samples (B, S, k, d)...) -> (models (B, S, m, ...), valid (B, S, m))
    residual_fn: Callable,  # (models (B, H, ...), data (B, 1, N, d)...) -> (B, H, N)
    refit_fn: Optional[Callable],  # (model, data, weights (B, N)) -> (model, ok)
    data: tuple,  # tensors (B, N, d)
    valid: torch.Tensor,  # (B, N) bool
    sample_size: int,
    options: RansacOptions,
) -> RansacResult:
    """The deterministic RANSAC core: solve, score, pick, refine."""
    B = valid.shape[0]
    max_err2 = options.max_error ** 2
    sample_data = tuple(_gather_rows(d, idx) for d in data)
    models, model_valid = solver(*sample_data)
    mshape = models.shape[3:]
    models = models.reshape((B, -1) + mshape)
    model_valid = model_valid.reshape(B, -1)
    inf = torch.tensor(float("inf"), device=valid.device)

    def score(r2, v):  # negated MSAC loss over the valid observations
        r2 = torch.where(v, r2, inf)
        s = torch.where(v, max_err2 - torch.clamp(r2, max=max_err2),
                        torch.zeros_like(r2)).sum(-1)
        return s, r2 < max_err2

    # hypothesis sweep in chunks of the hypothesis axis
    n = valid.shape[1]
    H = models.shape[1]
    hc = max(1, min(H, SCORE_ELEMS // max(1, B * n)))
    data_b = tuple(d[:, None] for d in data)
    parts = []
    for h0 in range(0, H, hc):
        r2 = residual_fn(models[:, h0:h0 + hc], data_b)
        parts.append(score(r2, valid[:, None, :])[0])
    scores = torch.cat(parts, dim=1)
    scores = torch.where(model_valid, scores, -inf)
    best = torch.argmax(scores, dim=1)
    ar = torch.arange(B, device=valid.device)
    best_model = models[ar, best]
    best_score = scores[ar, best]
    best_mask = score(residual_fn(best_model, data), valid)[1]

    if refit_fn is not None:
        for _ in range(options.lo_iterations):
            w = (best_mask & valid).to(data[0].dtype)
            new_model, ok = refit_fn(best_model, data, w)
            new_score, new_mask = score(residual_fn(new_model, data), valid)
            better = ok & (new_score > best_score)
            bm = better.reshape((B,) + (1,) * len(mshape))
            best_model = torch.where(bm, new_model, best_model)
            best_mask = torch.where(better[:, None], new_mask, best_mask)
            best_score = torch.where(better, new_score, best_score)

    num_inliers = (best_mask & valid).sum(-1)
    return RansacResult(model=best_model, inlier_mask=best_mask & valid,
                        num_inliers=num_inliers, score=best_score,
                        success=num_inliers >= sample_size)


def ransac(generator: torch.Generator, solver: Callable,
           residual_fn: Callable, refit_fn: Optional[Callable], data: tuple,
           valid: torch.Tensor, sample_size: int,
           options: RansacOptions) -> RansacResult:
    """Batched (LO-)RANSAC: draw minimal samples, then the core."""
    idx = draw_minimal_samples(generator, valid, options.num_samples,
                               sample_size)
    return ransac_from_samples(idx, solver, residual_fn, refit_fn, data,
                               valid, sample_size, options)
