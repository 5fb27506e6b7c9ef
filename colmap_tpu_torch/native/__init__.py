"""Host helpers of the mapper: connected components and counting-sort CSR.

Port of the numpy versions in colmap_tpu/native/__init__.py. The JAX
package also builds a g++ runtime for these (native/src/runtime.cc); the
port keeps the numpy versions only (ROADMAP queue 1 item 0).
"""

from __future__ import annotations

import numpy as np


def union_find(edges_a: np.ndarray, edges_b: np.ndarray, n_nodes: int
               ) -> np.ndarray:
    """Connected-component labels (n_nodes,): each node gets the smallest
    node index of its component."""
    a = np.ascontiguousarray(edges_a, np.int64)
    b = np.ascontiguousarray(edges_b, np.int64)
    parent = np.arange(n_nodes, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for x, y in zip(a, b):
        rx, ry = find(x), find(y)
        if rx != ry:
            parent[max(rx, ry)] = min(rx, ry)
    return np.array([find(i) for i in range(n_nodes)], np.int64)


def build_csr(keys: np.ndarray, n_bins: int):
    """Group indices by key; returns (offsets (n_bins + 1,), order (n,))."""
    k = np.ascontiguousarray(keys, np.int64)
    order = np.argsort(k, kind="stable")
    offsets = np.searchsorted(k[order], np.arange(n_bins + 1))
    return offsets.astype(np.int64), order.astype(np.int64)
