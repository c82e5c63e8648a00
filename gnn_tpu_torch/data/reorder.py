"""(A copy of `gnn_tpu.data.reorder`, so the port imports nothing of the
JAX package.) Degree-sorted graph reordering.

Re-implements the reference's reordering utilities
(the reference's `preprocess.py:147-258`) — relabel nodes by descending
(train-)degree so hot rows are contiguous — as vectorized numpy instead
of the reference's per-node Python loops. Useful for cache/placement
locality: after reordering, the hottest features occupy a contiguous
prefix, so contiguous ("naive") partitioning approximates hot-first
placement, and blocked adjacency tiles densify.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp


def degree_order(adj: sp.csr_matrix) -> np.ndarray:
    """Node ids sorted by descending weighted degree
    (`preprocess.py:148-157`)."""
    deg = np.asarray(adj.sum(axis=1)).ravel()
    return np.argsort(-deg, kind="stable")


def reorder_graph(adj_full: sp.csr_matrix,
                  order: np.ndarray) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Relabel the graph so ``order[i]`` becomes node ``i``.

    Returns (reordered adjacency, new_id_of_old — the inverse map the
    reference calls ``rate_nodes_dict``, `preprocess.py:159-161`).
    """
    n = adj_full.shape[0]
    new_of_old = np.empty(n, np.int64)
    new_of_old[order] = np.arange(n)
    coo = adj_full.tocoo()
    out = sp.csr_matrix(
        (coo.data, (new_of_old[coo.row], new_of_old[coo.col])),
        shape=adj_full.shape)
    out.sum_duplicates()
    return out, new_of_old


def reorder_dataset(graph, order: np.ndarray = None):
    """Reorder a full GraphData bundle (adjacency, feats, labels, splits)
    — the vectorized analog of `reorder_graphsaint_graph` /
    `reorder_ogbn_graph` (`preprocess.py:147-258`)."""
    import dataclasses

    if order is None:
        order = degree_order(graph.adj_full)
    adj, new_of_old = reorder_graph(graph.adj_full, order)
    return dataclasses.replace(
        graph,
        adj_full=adj,
        feats=graph.feats[order],
        labels=graph.labels[order],
        train_nodes=np.sort(new_of_old[graph.train_nodes]),
        valid_nodes=np.sort(new_of_old[graph.valid_nodes]),
        test_nodes=np.sort(new_of_old[graph.test_nodes]),
    )
