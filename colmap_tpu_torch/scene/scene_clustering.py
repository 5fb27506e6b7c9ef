"""Scene clustering: partition the match graph for hierarchical mapping.

Copy of colmap_tpu/scene/scene_clustering.py (host numpy and scipy; the
same tree on the same weights). Reference: scene/scene_clustering.h:43-96,
a hierarchical normalized multi-way cut of the image match graph with
`image_overlap` shared images between sibling clusters.

The normalized cut is computed spectrally: the Fiedler vector of the
normalized graph Laplacian (scipy's sparse eigensolver; the graph is
host-scale) drives recursive bisection; the overlap images are each leaf's
strongest cross-cut neighbours.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SceneClusteringOptions:
    """Reference: SceneClustering::Options (scene_clustering.h:46)."""

    branching: int = 2
    image_overlap: int = 50
    leaf_max_num_images: int = 500


@dataclasses.dataclass
class Cluster:
    image_ids: List[int]
    children: List["Cluster"] = dataclasses.field(default_factory=list)

    def leaves(self) -> List["Cluster"]:
        if not self.children:
            return [self]
        out = []
        for c in self.children:
            out.extend(c.leaves())
        return out


def _fiedler_bisect(ids: List[int], weights: Dict[Tuple[int, int], float]
                    ) -> Tuple[List[int], List[int]]:
    """Spectral bisection via the Fiedler vector of the normalized Laplacian.

    Shift-invert ARPACK: on sequence-like match graphs the Fiedler
    eigenvalue is O(1/n^2) and plain which="SM" Lanczos does not converge
    — it silently returns noise and the "clusters" interleave across the
    whole sequence. Factorizing
    (L - sigma*I) with sigma < 0 is SPD and cheap at host scale. The split
    point along the sorted Fiedler order is chosen by a normalized-cut
    sweep over the balanced middle range rather than a blind median."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    n = len(ids)
    idx = {iid: i for i, iid in enumerate(ids)}
    rows, cols, vals = [], [], []
    for (a, b), w in weights.items():
        if a in idx and b in idx:
            rows += [idx[a], idx[b]]
            cols += [idx[b], idx[a]]
            vals += [w, w]
    W = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    deg = np.asarray(W.sum(1)).reshape(-1)
    deg = np.maximum(deg, 1e-9)
    Dm = sp.diags(1.0 / np.sqrt(deg))
    L = (sp.eye(n) - Dm @ W @ Dm).tocsc()
    try:
        v0 = np.full(n, 1.0 / np.sqrt(n))
        evals, evecs = spla.eigsh(L, k=2, sigma=-1e-2, which="LM",
                                  v0=v0, maxiter=5000, tol=0)
        fiedler = evecs[:, np.argsort(evals)[1]]
    except Exception:
        fiedler = np.asarray(range(n), float)  # fallback: arbitrary split
    order = np.argsort(fiedler)

    # sweep cut: among balanced split points, minimize the normalized cut
    # ncut = cut/vol(A) + cut/vol(B) (Shi-Malik) of the reordered chain
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n)
    total_vol = float(deg.sum())
    lo, hi = max(1, n // 4), min(n - 1, (3 * n) // 4) + 1
    # prefix volumes along the sorted order
    vol_prefix = np.cumsum(deg[order])
    # cut(s) for split after sorted position s-1: sum of edge weights
    # crossing the split; accumulate via per-edge [min_pos, max_pos) range
    cut_delta = np.zeros(n + 1)
    coo = sp.triu(W, k=1).tocoo()
    for r, c, w in zip(coo.row, coo.col, coo.data):
        a, b = pos[r], pos[c]
        if a > b:
            a, b = b, a
        cut_delta[a + 1] += w
        cut_delta[b + 1] -= w
    cut_at = np.cumsum(cut_delta)[:n]  # cut_at[s] = cut after position s-1
    best, best_s = np.inf, n // 2
    for s in range(lo, hi):
        va, vb = vol_prefix[s - 1], total_vol - vol_prefix[s - 1]
        if va <= 0 or vb <= 0:
            continue
        ncut = cut_at[s] / va + cut_at[s] / vb
        if ncut < best:
            best, best_s = ncut, s
    left = [ids[i] for i in order[:best_s]]
    right = [ids[i] for i in order[best_s:]]
    return left, right


def cluster_scene(image_ids: Sequence[int],
                  edge_weights: Dict[Tuple[int, int], float],
                  options: SceneClusteringOptions = SceneClusteringOptions()
                  ) -> Cluster:
    """Recursive partition; returns the cluster tree (reference:
    SceneClustering::Partition)."""
    weights = {tuple(sorted(k)): float(v) for k, v in edge_weights.items()}

    def build(ids: List[int]) -> Cluster:
        node = Cluster(image_ids=list(ids))
        if len(ids) <= options.leaf_max_num_images:
            return node
        parts = [ids]
        while len(parts) < options.branching:
            big = max(range(len(parts)), key=lambda i: len(parts[i]))
            l, r = _fiedler_bisect(parts[big], weights)
            if not l or not r:
                break
            parts[big:big + 1] = [l, r]
        if len(parts) < 2:
            return node
        node.children = [build(p) for p in parts]
        return node

    root = build(list(image_ids))

    # add overlapping images to the leaves (reference: image_overlap)
    if options.image_overlap > 0:
        adj: Dict[int, List[Tuple[int, float]]] = {}
        for (a, b), w in weights.items():
            adj.setdefault(a, []).append((b, w))
            adj.setdefault(b, []).append((a, w))
        for leaf in root.leaves():
            members = set(leaf.image_ids)
            cross: Dict[int, float] = {}
            for iid in leaf.image_ids:
                for nbr, w in adj.get(iid, ()):
                    if nbr not in members:
                        cross[nbr] = cross.get(nbr, 0.0) + w
            extra = sorted(cross.items(), key=lambda kv: -kv[1])
            leaf.image_ids.extend(
                [iid for iid, _ in extra[: options.image_overlap]])
    return root


def edge_weights_from_database(database, min_num_inliers: int = 15
                               ) -> Dict[Tuple[int, int], float]:
    """Match-graph edge weights = verified inlier counts."""
    out = {}
    for pair, g in database.read_all_two_view_geometries().items():
        n = len(g["inlier_matches"])
        if n >= min_num_inliers:
            out[pair] = float(n)
    return out
