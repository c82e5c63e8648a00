"""The reference's graph: everything the port derives from the raw
adjacency, worked out again in NumPy, and the check of each sampled
batch against it.

* The propagation matrix ``D^-1 A`` of the binary adjacency (``norm:
  row``): row ``r`` holds ``float32(1) / float32(deg r)`` on its support.
* The sampling probability of the placement (ones over the training rows
  pushed through the matrix ``depth`` times, in float64) and the hot set,
  its top ``hot_k`` nodes (ties to the lower id).
* A LADIES layer: for output rows ``R`` (in order) and sampled input
  columns ``C``, the column probability ``p = (neighbour counts from R) /
  total``, ``s = min(#support, samp_num)``, the debias weight
  ``1 / clip(s * p[c], 1e-10, 1)`` as float32, and every edge of ``R x C``
  with its value. The sample is valid when ``C`` is sorted and distinct,
  holds ``R``, and its other columns, at most ``s``, all lie on the
  support.
"""
from __future__ import annotations

import numpy as np


class BatchFault(ValueError):
    """A sampled batch that the graph does not bear out."""


class RefGraph:
    """The raw dataset as both sides read it: the binary adjacency in CSR
    (``indptr``, ``indices``), the labels as an indicator CSR, the
    training nodes, and the configuration's ``norm``, ``hot_k`` and the
    model depth the hot set is computed for."""

    def __init__(self, indptr, indices, data, label_indptr, label_indices,
                 num_classes: int, train_nodes, *, norm: str, hot_k: int,
                 depth: int):
        if norm != "row":
            raise ValueError(f"the reference knows norm 'row', not {norm!r}")
        self.indptr = np.asarray(indptr, np.int64)
        self.indices = np.asarray(indices, np.int64)
        if not np.all(np.asarray(data) == 1):
            raise ValueError("the reference expects a binary adjacency")
        self.n = len(self.indptr) - 1
        deg = np.diff(self.indptr).astype(np.float32)
        self.row_val = np.zeros(self.n, np.float32)
        nz = deg > 0
        self.row_val[nz] = np.float32(1.0) / deg[nz]
        self.label_indptr = np.asarray(label_indptr, np.int64)
        self.label_indices = np.asarray(label_indices, np.int64)
        self.num_classes = int(num_classes)
        self.train_nodes = np.asarray(train_nodes, np.int64)
        self.is_train = np.zeros(self.n, bool)
        self.is_train[self.train_nodes] = True
        self.hot = np.zeros(self.n, bool)
        prob = self.sample_prob(depth)
        self.hot[np.argsort(-prob, kind="stable")[: min(hot_k, self.n)]] = \
            True

    def _rows(self, rows):
        """``(row position of each entry, column of each entry)`` of the
        CSR rows ``rows``, in row order."""
        starts = self.indptr[rows]
        lens = self.indptr[rows + 1] - starts
        tot = int(lens.sum())
        first = np.repeat(np.cumsum(lens) - lens, lens)
        ent = np.repeat(starts, lens) + (np.arange(tot) - first)
        return np.repeat(np.arange(len(rows)), lens), self.indices[ent]

    def sample_prob(self, depth: int) -> np.ndarray:
        """Ones over the training rows pushed through ``D^-1 A`` ``depth``
        times (float64, summed in the matrix's row order)."""
        pos, col = self._rows(self.train_nodes)
        v = np.bincount(col, weights=self.row_val[self.train_nodes][pos]
                        .astype(np.float64), minlength=self.n)
        every = np.arange(self.n)
        pos, col = self._rows(every)
        w = self.row_val[pos].astype(np.float64)
        for _ in range(depth - 1):
            v = np.bincount(col, weights=w * v[pos], minlength=self.n)
        return v

    def labels(self, nodes) -> np.ndarray:
        """Dense float32 ``[len(nodes), classes]`` indicator rows."""
        out = np.zeros((len(nodes), self.num_classes), np.float32)
        pos, col = _csr_rows(self.label_indptr, self.label_indices, nodes)
        out[pos, col] = 1.0
        return out

    def layer(self, rows, cols, samp_num: int) -> dict:
        """The sampled layer ``rows x cols`` (global ids) checked against
        the graph: ``r``, ``c`` (local positions of every edge), ``val``
        (its ``D^-1 A`` value, float32), ``hot`` (both ends in the hot
        set), ``nf`` (the columns' debias weights, float32) and
        ``self_pos`` (each row's position among the columns). Raises
        :class:`BatchFault` where the sample is not a valid draw."""
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        if len(cols) == 0 or np.any(np.diff(cols) <= 0):
            raise BatchFault("a layer's columns are not sorted and distinct")
        if cols[0] < 0 or cols[-1] >= self.n or np.any(rows < 0) or \
                np.any(rows >= self.n):
            raise BatchFault("a node id lies outside the graph")
        if len(np.unique(rows)) != len(rows):
            raise BatchFault("a layer's rows repeat")
        self_pos = np.searchsorted(cols, rows)
        if np.any(self_pos >= len(cols)) or np.any(
                cols[np.minimum(self_pos, len(cols) - 1)] != rows):
            raise BatchFault("a layer's columns do not hold its rows")
        pos, nbr = self._rows(rows)
        pi = np.bincount(nbr, minlength=self.n).astype(np.float64)
        support = int(np.count_nonzero(pi))
        s_num = min(support, samp_num)
        is_row = np.zeros(self.n, bool)
        is_row[rows] = True
        drawn = cols[~is_row[cols]]
        if len(drawn) > s_num or np.any(pi[drawn] <= 0):
            raise BatchFault(f"{len(drawn)} drawn columns for a draw of "
                             f"{s_num}, or one off the support")
        if len(cols) < s_num:
            raise BatchFault(f"{len(cols)} columns for a draw of {s_num}")
        p = pi[cols] / max(pi.sum(), 1e-300)
        nf = (1.0 / np.clip(s_num * p, 1e-10, 1.0)).astype(np.float32)
        table = np.full(self.n, -1, np.int64)
        table[cols] = np.arange(len(cols))
        c = table[nbr]
        keep = c >= 0
        r = pos[keep]
        c = c[keep]
        return {"r": r, "c": c, "val": self.row_val[rows][r],
                "hot": self.hot[rows][r] & self.hot[cols][c], "nf": nf,
                "self_pos": self_pos, "nnz": len(r),
                "nnz_hot": int(np.count_nonzero(
                    self.hot[rows][r] & self.hot[cols][c]))}


def _csr_rows(indptr, indices, rows):
    starts = indptr[rows]
    lens = indptr[np.asarray(rows) + 1] - starts
    first = np.repeat(np.cumsum(lens) - lens, lens)
    ent = np.repeat(starts, lens) + (np.arange(int(lens.sum())) - first)
    return np.repeat(np.arange(len(rows)), lens), indices[ent]


def levels(batch: dict) -> list:
    """The global node ids of each level of a batch, bottom up: the input
    nodes, then each layer's rows chained through its positions among
    the level below. ``batch``: ``input_nodes`` (valid ids) and
    ``positions`` (per layer, each valid row's position below)."""
    out = [np.asarray(batch["input_nodes"], np.int64)]
    for pos in batch["positions"]:
        pos = np.asarray(pos, np.int64)
        if pos.size and (pos.min() < 0 or pos.max() >= len(out[-1])):
            raise BatchFault("a row's position lies outside the level below")
        out.append(out[-1][pos])
    return out


def check_targets(graph: RefGraph, batches: list) -> None:
    """The batches' targets: training nodes, each once over all the
    batches, and equal to the top level the chain reaches."""
    seen = set()
    for b in batches:
        top = levels(b)[-1]
        targets = np.asarray(b["targets"], np.int64)
        if not np.array_equal(top, targets):
            raise BatchFault("the top level is not the batch's targets")
        if not graph.is_train[targets].all():
            raise BatchFault("a target is not a training node")
        if seen.intersection(targets.tolist()) or len(
                set(targets.tolist())) != len(targets):
            raise BatchFault("a target repeats across the checked steps")
        seen.update(targets.tolist())
