"""Graph-locality node relabelling for the search index
(nann_tpu/index/reorder.py).

BFS relabelling gives consecutive node ids in breadth-first order from the
enter points over the ground-level graph, so a hop's frontier (graph-adjacent
nodes) maps to nearby table rows. It is a bijective relabel applied at load
time; external item ids travel with `item_ids`.

Results in item-id space are identical to the plain order only where no hop
overflows its frontier cap: the truncation of an overflowing hop keeps the
smallest salted node ids (`search/beam.py: _select_fresh`), and the relabel
changes which nodes those are.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def bfs_order(neighbors0: np.ndarray, enter_points: np.ndarray,
              n: int) -> np.ndarray:
    """Vectorised BFS over the dense-packed ground level.

    Returns order[new_id] = old_id covering all n nodes (disconnected
    leftovers appended in id order).
    """
    visited = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    frontier = np.unique(np.asarray(enter_points, np.int64))
    frontier = frontier[(frontier >= 0) & (frontier < n)]
    visited[frontier] = True
    order[:len(frontier)] = frontier
    pos = len(frontier)
    while frontier.size:
        nb = np.unique(neighbors0[frontier].reshape(-1).astype(np.int64))
        nb = nb[(nb >= 0) & (nb < n)]
        nb = nb[~visited[nb]]
        visited[nb] = True
        order[pos:pos + len(nb)] = nb
        pos += len(nb)
        frontier = nb
    if pos < n:
        rest = np.nonzero(~visited)[0]
        order[pos:] = rest
    return order


def relabel(enter_points: np.ndarray, neighbors: Dict[int, np.ndarray],
            item_embs: np.ndarray, item_ids: np.ndarray,
            order: np.ndarray) -> Tuple[np.ndarray, Dict[int, np.ndarray],
                                        np.ndarray, np.ndarray]:
    """Apply a node permutation (order[new] = old) consistently to every
    id-indexed structure. Self-padded neighbor rows stay self-padded."""
    n = len(order)
    old_to_new = np.empty(n, np.int64)
    old_to_new[order] = np.arange(n, dtype=np.int64)
    new_neighbors = {
        l: old_to_new[nb[order].astype(np.int64)].astype(np.int32)
        for l, nb in neighbors.items()
    }
    new_enter = old_to_new[np.asarray(enter_points, np.int64)].astype(
        enter_points.dtype)
    return new_enter, new_neighbors, item_embs[order], item_ids[order]
