"""Minimum spanning tree over node-trajectory distances.

Port of ``riggs_tpu/skeleton/mst.py``: Prim's algorithm on a dense cost
matrix (mean pairwise trajectory distance), rooted at node 2, zero-cost
edges treated as absent. Numpy, on the host.

The reference's ``build_tree`` runs its native C++ Prim whenever that
library loads, and that Prim keeps float32 keys and takes the first strict
minimum. ``build_tree`` here casts the cost to float32 first, so that the
numpy Prim (which compares in its input's dtype and also takes the first
minimum) makes the native choices on near-ties that float64 would split.
"""
from __future__ import annotations

import numpy as np


def prim_mst(cost: np.ndarray, init_id: int = 0) -> np.ndarray:
    """Prim MST. cost: (K, K) symmetric; entries <= 0 mean "no edge".

    Returns parents (K,) int64 with parent[init_id] = -1."""
    K = cost.shape[0]
    INF = np.inf
    key = np.full(K, INF)
    parent = np.full(K, -1, np.int64)
    in_tree = np.zeros(K, bool)
    key[init_id] = 0.0
    for _ in range(K):
        masked = np.where(in_tree, INF, key)
        u = int(np.argmin(masked))
        if not np.isfinite(masked[u]):
            break  # disconnected remainder
        in_tree[u] = True
        row = cost[u]
        better = (~in_tree) & (row > 0) & (row < key)
        key[better] = row[better]
        parent[better] = u
    return parent


def build_tree(cost: np.ndarray, init_id: int = 2) -> np.ndarray:
    """The MST rooted at node 2 (or the last node of a smaller graph), on
    the float32 cost."""
    init_id = min(init_id, cost.shape[0] - 1)
    return prim_mst(np.asarray(cost, np.float32), init_id)
