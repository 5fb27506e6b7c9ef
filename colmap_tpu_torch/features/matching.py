"""Descriptor matching: exact uint8 cosine similarities + ratio/cross checks.

Port of colmap_tpu/features/matching.py. Descriptors are stored centered
(d - 128, int8) with per-row sums and inverse norms, so the exact uint8 dot
product is recovered from the centered one with a rank-1 correction:

    a . b = (a-128).(b-128) + 128*sum(a) + 128*sum(b) - 128*128*128

Every term is an integer below 2^24, so an f32 product of the centered
values is exact (TF32 is off, see colmap_tpu_torch/__init__.py).

This module holds the exact matcher that materializes the (B, N, M)
similarities, and the guided matcher, which gates them by epipolar
distance. The main path on a CUDA device runs the fused kernel in
features/hopper_matcher.py instead of the exact matcher.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MatchingOptions:
    max_ratio: float = 0.8
    max_distance: float = 0.7
    cross_check: bool = True


class DescriptorBlock(NamedTuple):
    """Packed descriptors of one image (N, ...) or a batch of pairs' sides
    (B, N, ...), at a fixed capacity."""

    centered: torch.Tensor  # (..., N, 128) int8 = uint8 - 128
    row_sum: torch.Tensor  # (..., N) float32 = sum(uint8 row)
    inv_norm: torch.Tensor  # (..., N) float32 = 1 / ||uint8 row||
    valid: torch.Tensor  # (..., N) bool


def _target_device(x, device):
    """Where a function's result goes: an explicit `device` wins, a torch
    tensor stays on its own device, anything else goes to the card."""
    if device is not None:
        return device
    return x.device if torch.is_tensor(x) else "cuda"


def prepare_descriptors(desc_u8, valid=None, device=None) -> DescriptorBlock:
    """Pack uint8 descriptors (..., N, 128) for int8 matching, on `device`
    (default: a tensor's own device, the card for numpy input)."""
    device = _target_device(desc_u8, device)
    d = torch.as_tensor(np.asarray(desc_u8) if not torch.is_tensor(desc_u8)
                        else desc_u8, device=device)
    di = d.to(torch.int32)
    row_sum = di.sum(-1).to(torch.float32)
    sq = (di * di).sum(-1).to(torch.float32)
    inv_norm = 1.0 / torch.sqrt(torch.clamp(sq, min=1e-12))
    centered = (di - 128).to(torch.int8)
    if valid is None:
        valid = torch.ones(d.shape[:-1], dtype=torch.bool, device=d.device)
    else:
        valid = torch.as_tensor(np.asarray(valid) if not torch.is_tensor(valid)
                                else valid, device=d.device).to(torch.bool)
    return DescriptorBlock(centered=centered, row_sum=row_sum,
                           inv_norm=inv_norm, valid=valid)


def block_from_numpy(centered, row_sum, inv_norm, valid,
                     device=None) -> DescriptorBlock:
    """A DescriptorBlock from numpy arrays (e.g. a JAX DescriptorBlock
    fetched to the host): the same layout, moved onto `device` (default:
    the card; torch tensors stay on their own device)."""
    device = _target_device(centered, device)

    def t(x, dtype):  # a copy: arrays fetched from JAX are read-only
        if torch.is_tensor(x):
            return x.to(device=device, dtype=dtype, copy=True)
        return torch.as_tensor(np.array(x), device=device).to(dtype)

    return DescriptorBlock(centered=t(centered, torch.int8),
                           row_sum=t(row_sum, torch.float32),
                           inv_norm=t(inv_norm, torch.float32),
                           valid=t(valid, torch.bool))


def _cosine_similarities(b1: DescriptorBlock, b2: DescriptorBlock
                         ) -> torch.Tensor:
    """Exact normalized uint8 dot products (..., N, M) in float32."""
    dots_c = torch.matmul(b1.centered.to(torch.float32),
                          b2.centered.to(torch.float32).transpose(-1, -2))
    dots = (dots_c
            + 128.0 * b1.row_sum[..., :, None]
            + 128.0 * b2.row_sum[..., None, :]
            - 128.0 * 128.0 * 128.0)
    return dots * b1.inv_norm[..., :, None] * b2.inv_norm[..., None, :]


def _select_matches(sims, b1: DescriptorBlock, b2: DescriptorBlock,
                    options: MatchingOptions) -> torch.Tensor:
    """Ratio test + distance gate + cross check on (..., N, M) similarities.
    Returns (..., N) int32 indices into b2 (-1 = none)."""
    neg_inf = torch.tensor(float("-inf"), device=sims.device)
    sims = torch.where(b1.valid[..., :, None] & b2.valid[..., None, :],
                       sims, neg_inf)
    best_sim = sims.amax(-1)
    best_idx = torch.argmax(sims, dim=-1)  # first occurrence on ties
    cols = torch.arange(sims.shape[-1], device=sims.device)
    second_sim = torch.where(cols == best_idx[..., None], neg_inf,
                             sims).amax(-1)
    best_dist = torch.arccos(torch.clamp(best_sim, -1.0, 1.0))
    second_dist = torch.arccos(torch.clamp(second_sim, -1.0, 1.0))

    ok = torch.isfinite(best_sim)
    ok &= best_dist <= options.max_distance
    # strict <: equal distances (e.g. duplicated descriptors) are ambiguous
    ok &= best_dist < options.max_ratio * second_dist
    if options.cross_check:
        rev_best = torch.argmax(sims, dim=-2)  # (..., M)
        rows = torch.arange(sims.shape[-2], device=sims.device)
        ok &= torch.gather(rev_best, -1, best_idx) == rows
    return torch.where(ok & b1.valid, best_idx,
                       torch.full_like(best_idx, -1)).to(torch.int32)


def match_pairs_batch(b1: DescriptorBlock, b2: DescriptorBlock,
                      options: MatchingOptions = MatchingOptions()
                      ) -> torch.Tensor:
    """One-to-one matches of a batch of pairs (or one pair, without the
    batch axis): b1/b2 hold (B, N, ...) arrays. Materializes the (B, N, M)
    similarities; returns (B, N) int32 indices into b2 (-1 = none)."""
    return _select_matches(_cosine_similarities(b1, b2), b1, b2, options)


def guided_match_descriptors(
    b1: DescriptorBlock, b2: DescriptorBlock,
    xy1: torch.Tensor, xy2: torch.Tensor, F: torch.Tensor,
    max_epipolar_error: float,
    options: MatchingOptions = MatchingOptions(),
) -> torch.Tensor:
    """Guided matching of one pair: candidates gated by their Sampson
    distance under F (x2^T F x1 = 0), then the usual ratio, distance and
    cross checks. b1/b2 hold (N, ...) and (M, ...) rows, xy1/xy2 the (N, 2)
    and (M, 2) keypoints at the same capacities. Returns (N,) int32
    indices into b2 (-1 = none). Reference: guided matching with an E/F
    constraint (feature/sift.cc:1508)."""
    sims = _cosine_similarities(b1, b2)
    h1 = torch.cat([xy1, torch.ones_like(xy1[:, :1])], dim=-1)  # (N, 3)
    h2 = torch.cat([xy2, torch.ones_like(xy2[:, :1])], dim=-1)  # (M, 3)
    Fx1 = h1 @ F.T  # (N, 3)
    Ftx2 = h2 @ F  # (M, 3)
    num = Fx1 @ h2.T  # x2^T F x1, (N, M)
    denom = (Fx1[:, 0:1] ** 2 + Fx1[:, 1:2] ** 2
             + (Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2)[None, :])
    sampson = num * num / torch.clamp(denom, min=1e-12)
    sims = torch.where(sampson <= max_epipolar_error ** 2, sims,
                       torch.tensor(float("-inf"), device=sims.device))
    return _select_matches(sims, b1, b2, options)


def matches_to_pairs(match_idx) -> np.ndarray:
    """Host helper: (N,) match indices -> (K, 2) index pair array (numpy)."""
    m = (match_idx.cpu().numpy() if torch.is_tensor(match_idx)
         else np.asarray(match_idx))
    rows = np.nonzero(m >= 0)[0]
    return np.stack([rows, m[rows]], axis=-1).astype(np.uint32)
