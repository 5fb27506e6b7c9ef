"""Batched k-means on descriptors: the vocab-tree building block.

Port of colmap_tpu/retrieval/kmeans.py. Lloyd's algorithm whose assignment
step is one distance product per iteration (||x - c||^2 = ||x||^2 - 2 x.c +
||c||^2, TF32 off), on the points' device. The initial draw is split from
the iteration (`kmeans_init` / `kmeans_from_centers`), as RANSAC's draw is
split from `ransac_from_samples`, so a caller can start the iteration from
given centres. Shapes are exact: a node's points are its own, with no
padding rows, so the draw picks among real points only.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

# f32 elements of one [chunk, branching, D] temporary in `quantize`
QUANTIZE_ELEMS = 1 << 26


def kmeans_init(generator: torch.Generator, points: torch.Tensor,
                k: int) -> torch.Tensor:
    """k distinct points drawn with `generator` (on its own device) as the
    initial centres [k, D]."""
    perm = torch.randperm(points.shape[0], generator=generator,
                          device=generator.device)
    return points[perm[:k].to(points.device)]


def _sq_dists(points, pn, centers):
    cn = (centers * centers).sum(1)
    return pn[:, None] - 2.0 * points @ centers.T + cn[None, :]


def kmeans_from_centers(points: torch.Tensor, centers: torch.Tensor,
                        num_iters: int = 20
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations from `centers` [k, D] over `points` [N, D] f32.

    Returns (centers [k, D], assignment [N] int32). An empty cluster is
    re-seeded at the j-th farthest point (j its index), in a stable
    descending order of the distance to the nearest centre."""
    k = centers.shape[0]
    pn = (points * points).sum(1)
    for _ in range(num_iters):
        d2 = _sq_dists(points, pn, centers)
        assign = torch.argmin(d2, dim=1)  # first index on ties
        oh = torch.nn.functional.one_hot(assign, k).to(points.dtype)
        counts = oh.sum(0)
        new_centers = (oh.T @ points) / torch.clamp(counts[:, None], min=1.0)
        far_idx = torch.argsort(-d2.amin(1), stable=True)[:k]
        centers = torch.where(counts[:, None] > 0.5, new_centers,
                              points[far_idx])
    d2 = _sq_dists(points, pn, centers)
    return centers, torch.argmin(d2, dim=1).to(torch.int32)


def kmeans(generator: torch.Generator, points: torch.Tensor, k: int,
           num_iters: int = 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means of `points` [N, D] f32 from k distinct points drawn
    with `generator`. Returns (centers [k, D], assignment [N] int32)."""
    return kmeans_from_centers(points, kmeans_init(generator, points, k),
                               num_iters)


def hierarchical_kmeans(rng: np.random.Generator, points: np.ndarray,
                        branching: int, depth: int,
                        min_points_per_node: int = 2,
                        device="cuda") -> List[np.ndarray]:
    """Build a full hierarchical k-means tree on `device`; returns the
    per-level centre tables (host float32).

    Level l holds a [branching^l, branching, D] table: node index at level l
    is the path prefix read in base `branching`, and a leaf word id is the
    whole path. Each clustered node takes one `rng.integers(0, 2**31)`, in
    node order, to seed the CPU generator of its initial draw (so the tree
    is the same on every device up to rounding); a node with fewer than
    `min_points_per_node` points keeps its mean and draws nothing."""
    d = points.shape[1]
    pts_dev = torch.as_tensor(np.asarray(points, np.float32), device=device)
    levels = []
    assignments = np.zeros(len(points), np.int64)  # node index at cur level
    for level in range(depth):
        n_nodes = branching ** level
        table = np.zeros((n_nodes, branching, d), np.float32)
        new_assign = np.zeros_like(assignments)
        for node in range(n_nodes):
            rows = np.nonzero(assignments == node)[0]
            if len(rows) < min_points_per_node:
                # degenerate node: replicate whatever is there
                if len(rows) > 0:
                    table[node] = np.tile(points[rows].mean(0), (branching, 1))
                new_assign[rows] = node * branching
                continue
            gen = torch.Generator().manual_seed(int(rng.integers(0, 2**31)))
            pts = pts_dev[torch.as_tensor(rows, device=device)]
            centers, assign = kmeans(gen, pts, min(branching, len(rows)), 15)
            centers = centers.cpu().numpy()
            if len(centers) < branching:
                centers = np.concatenate(
                    [centers, np.tile(centers[-1:],
                                      (branching - len(centers), 1))])
            table[node] = centers
            new_assign[rows] = node * branching + assign.cpu().numpy()
        levels.append(table)
        assignments = new_assign
    return levels


def quantize(levels, descriptors, device="cuda") -> np.ndarray:
    """Descend the tree on `device`; returns leaf word ids [N] int64.

    Each level compares with its children by the direct difference
    sum((x - c)^2), as the JAX package does (a product form rounds
    otherwise and flips words near ties), in chunks of N that keep the
    [chunk, branching, D] temporaries within QUANTIZE_ELEMS."""
    n = len(descriptors)
    if n == 0:
        return np.zeros(0, np.int64)
    tables = [torch.as_tensor(t, device=device) for t in levels]
    branching, d = tables[0].shape[1:]
    x_all = torch.as_tensor(np.asarray(descriptors, np.float32), device=device)
    chunk = max(1, QUANTIZE_ELEMS // (branching * d))
    out = []
    for s in range(0, n, chunk):
        x = x_all[s:s + chunk]
        node = torch.zeros(len(x), dtype=torch.int64, device=device)
        for table in tables:
            d2 = ((x[:, None, :] - table[node]) ** 2).sum(-1)
            node = node * branching + torch.argmin(d2, dim=1)
        out.append(node)
    return torch.cat(out).cpu().numpy()
