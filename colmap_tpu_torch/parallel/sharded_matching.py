"""Multi-device sharded descriptor matching.

Port of colmap_tpu/parallel/sharded_matching.py (reference parallelism:
block-wise exhaustive matching over GPU worker threads,
src/colmap/feature/pairing.h:41-47, controllers/feature_matching_utils.cc).
The pair axis splits over the mesh's shards: each shard prepares its
pairs' descriptors on its device and matches them with the fused matcher
kernel (features/hopper_matcher.py, its plain twin on the CPU); no
collective is needed until the host gathers the match indices. The
all-gather variant holds I/n images per shard and gathers all of them to
match its rows against every column.

Matches are integers and the matcher is exact, so they are equal for
every shard count.
"""

from __future__ import annotations

import numpy as np
import torch

from colmap_tpu_torch.features import hopper_matcher
from colmap_tpu_torch.features import matching as matching_mod
from colmap_tpu_torch.parallel.mesh import Mesh, run_shards


def _prepare(d_u8: np.ndarray, valid: np.ndarray, device
             ) -> matching_mod.DescriptorBlock:
    """(B, N, 128) uint8 rows on `device`, padded with invalid rows to the
    kernel's tile (a multiple of 64), prepared for the matcher."""
    n = d_u8.shape[1]
    pad = (-n) % hopper_matcher.TILE
    if pad:
        d_u8 = np.pad(d_u8, ((0, 0), (0, pad), (0, 0)))
        valid = np.pad(valid, ((0, 0), (0, pad)))
    return matching_mod.prepare_descriptors(
        torch.as_tensor(np.ascontiguousarray(d_u8), device=device),
        torch.as_tensor(np.ascontiguousarray(valid), device=device))


def match_pair_blocks_sharded(
    mesh: Mesh,
    d1_u8: np.ndarray,  # (B, N, 128) uint8 descriptors, side 1
    d2_u8: np.ndarray,  # (B, M, 128)
    v1: np.ndarray,  # (B, N) bool
    v2: np.ndarray,  # (B, M) bool
    options: matching_mod.MatchingOptions = matching_mod.MatchingOptions(),
) -> np.ndarray:
    """Match B pairs split over the mesh's shards, B / n contiguous pairs
    each; returns (B, N) int32 indices into side 2 (-1 = none). B must be a
    multiple of the mesh size (pad with empty pairs)."""
    n = mesh.size
    B, N = d1_u8.shape[:2]
    if B % n:
        raise ValueError(f"pad the pair blocks to a multiple of {n}, got {B}")
    per = B // n

    def shard(group):
        s = slice(group.rank * per, (group.rank + 1) * per)
        b1 = _prepare(d1_u8[s], v1[s], group.device)
        b2 = _prepare(d2_u8[s], v2[s], group.device)
        out = hopper_matcher.match_pairs_batch_fused(b1, b2, options)
        return out[:, :N].cpu().numpy()

    return np.concatenate(run_shards(mesh, shard))


def exhaustive_match_all_gather(
    mesh: Mesh,
    descriptors: np.ndarray,  # (I, N, 128) uint8, one row per image
    valid: np.ndarray,  # (I, N) bool
    options: matching_mod.MatchingOptions = matching_mod.MatchingOptions(),
) -> np.ndarray:
    """All-pairs matching with image shards: each shard prepares its I / n
    images, gathers every shard's prepared images (`all_gather`) and
    matches its rows against all of them. Returns (I, I, N) int32 indices
    (row image -> column image). I must be a multiple of the mesh size."""
    n = mesh.size
    I, N = descriptors.shape[:2]
    if I % n:
        raise ValueError(f"pad the images to a multiple of {n}, got {I}")
    per = I // n

    def shard(group):
        s = slice(group.rank * per, (group.rank + 1) * per)
        local = _prepare(descriptors[s], valid[s], group.device)
        every = matching_mod.DescriptorBlock(
            *(group.all_gather(t) for t in local))
        rows = torch.arange(per, device=group.device).repeat_interleave(I)
        cols = torch.arange(I, device=group.device).repeat(per)
        b1 = matching_mod.DescriptorBlock(*(t[rows] for t in local))
        b2 = matching_mod.DescriptorBlock(*(t[cols] for t in every))
        out = hopper_matcher.match_pairs_batch_fused(b1, b2, options)
        return out[:, :N].reshape(per, I, N).cpu().numpy()

    return np.concatenate(run_shards(mesh, shard))
