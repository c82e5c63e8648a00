"""The part-sharded resident graph (``--resident_parts P``): the
counterpart of `gnn_tpu.parallel.shardedresident`.

Replicated, the resident state is O(N + K^2) per device; this module
shards it over the ``P`` ranks of a part group
(`gnn_tpu_torch.parallel.dist`, the grid's part axis), so each rank
holds ``1/P`` of it while the batch stays data-parallel over the data
ranks (the part ranks of one data group sample the same batch):

* ``slot_of_node``, ``row_val`` and ``col_val`` shard by node ranges
  (node v lives on part ``v // nsh``). A lookup is a local masked take
  (:meth:`ShardedResidentGraph.slot_partial` and its siblings) plus one
  sum over the part group: every id has one owner, so the sum is the
  lookup. The slot lookup sums ``slot + 1`` as int32, so ids outside
  every range (the pad id ``n``) read ``-1``.
* The hot blocks shard by slot columns: part p holds ``D[:, lo:hi]`` and
  ``D^T[:, lo:hi]``, each ``[k, k/P]``. `gnn_tpu_torch.ops.hotdense`
  contracts only the local slot range and sums the ``[rh, F]`` partial
  over the part group, forward and transposed.
* The cold residual and the k-sized plumbing are computed replicated in
  lite mode. In full-expansion mode (``resident_ship_cold=False``) the
  CSR shards by row ranges as well: each part expands only the rows it
  owns (:meth:`ShardedResidentGraph.csr_spans`), and the partial cold
  aggregation is summed over the part group (``cold_partial``).

Only this rank's shard reaches its device: :func:`shard_resident_state`
moves ``[nsh]`` slices of the tables and the ``[k, k/P]`` blocks (given
whole, they are sliced on the host side of the move; the CLI builds only
its own columns, `gnn_tpu_torch.ops.hotdense.build_hot_dense_shard`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from gnn_tpu_torch.parallel.dist import PartGroup, part_sum_


@dataclasses.dataclass
class ShardedResidentGraph:
    """One part rank's shard of the resident state. Stands in for
    :class:`~gnn_tpu_torch.ops.residentgraph.ResidentGraph` in
    `materialize_adjs` (the same lookups); the layers it yields carry
    ``part``, so their hot products sum over the part group."""

    slot_shard: torch.Tensor     # int32 [nsh], slots of my node range
    row_val_shard: torch.Tensor  # f32 [nsh]
    col_val_shard: torch.Tensor  # f32 [nsh]
    dense: torch.Tensor          # [k, ksh] slot-column shard of D
    dense_t: torch.Tensor        # [k, ksh] slot-column shard of D^T
    n: int
    k: int
    nsh: int
    part: PartGroup
    col_trivial: bool = True
    # full-expansion mode only: my node range's CSR rows, local offsets
    # (constant past the range, so its padded tail reads degree 0)
    row_ptr_shard: Optional[torch.Tensor] = None  # int32 [nsh + 1]
    col_idx_shard: Optional[torch.Tensor] = None  # int32 [esh_pad]
    val_shard: Optional[torch.Tensor] = None      # f32 [esh_pad]

    def _owned(self, ids: torch.Tensor):
        loc = ids.long() - self.part.rank * self.nsh
        ok = (loc >= 0) & (loc < self.nsh)
        return ok, loc.clamp(0, self.nsh - 1)

    def slot_partial(self, ids: torch.Tensor) -> torch.Tensor:
        """``slot + 1`` where this part owns the id, else 0 (int32)."""
        ok, loc = self._owned(ids)
        return torch.where(ok, self.slot_shard.index_select(0, loc) + 1,
                           torch.zeros((), dtype=torch.int32,
                                       device=ids.device))

    def rowval_partial(self, ids: torch.Tensor) -> torch.Tensor:
        ok, loc = self._owned(ids)
        return torch.where(ok, self.row_val_shard.index_select(0, loc),
                           torch.zeros((), device=ids.device))

    def colval_partial(self, ids: torch.Tensor) -> torch.Tensor:
        ok, loc = self._owned(ids)
        return torch.where(ok, self.col_val_shard.index_select(0, loc),
                           torch.zeros((), device=ids.device))

    def slot_lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """Hot slot of each id (-1 = cold or outside every range)."""
        v = self.slot_partial(ids)
        part_sum_([v], self.part)
        return v - 1

    def rowval_lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """Row factor of each id (0 outside every range)."""
        v = self.rowval_partial(ids)
        part_sum_([v], self.part)
        return v

    def colval_lookup(self, ids: torch.Tensor) -> torch.Tensor:
        v = self.colval_partial(ids)
        part_sum_([v], self.part)
        return v

    def csr_spans(self, ids: torch.Tensor):
        """Per id, ``(start, degree)`` in this part's CSR shard; degree 0
        for every id this part does not own (the pad id too), so each
        graph row is expanded on exactly one part."""
        ok, loc = self._owned(ids)
        rp = self.row_ptr_shard.long()
        lo = rp.index_select(0, loc)
        hi = rp.index_select(0, loc + 1)
        zero = torch.zeros((), dtype=torch.long, device=ids.device)
        return torch.where(ok, lo, zero), torch.where(ok, hi - lo, zero)

    def state_bytes(self) -> dict:
        """Bytes of each resident tensor on the device."""
        out = {f: getattr(self, f).nbytes for f in
               ("slot_shard", "row_val_shard", "col_val_shard", "dense",
                "dense_t")}
        if self.row_ptr_shard is not None:
            out["csr"] = sum(t.nbytes for t in (
                self.row_ptr_shard, self.col_idx_shard, self.val_shard))
        return out


def _csr_row_shards(indptr, indices, data, n_parts: int, nsh: int):
    """Row-range CSR shards stacked on a leading part axis (the JAX
    package's arrays): per part a local indptr ([nsh + 1] int32, rebased
    to 0, constant past the owned range), and indices / data padded to
    the largest shard's nnz (a multiple of 128)."""
    n = len(indptr) - 1
    indptr = np.asarray(indptr, np.int64)
    rp = np.zeros((n_parts, nsh + 1), np.int32)
    nnzs = []
    for p in range(n_parts):
        lo, hi = p * nsh, min((p + 1) * nsh, n)
        seg = (indptr[lo:hi + 1] - indptr[lo] if hi > lo
               else np.zeros(1, np.int64))
        rp[p, : len(seg)] = seg
        rp[p, len(seg):] = seg[-1]
        nnzs.append(int(seg[-1]))
    esh = ((max(max(nnzs), 1) + 127) // 128) * 128
    ci = np.zeros((n_parts, esh), np.int32)
    vv = np.zeros((n_parts, esh), np.asarray(data).dtype)
    for p in range(n_parts):
        lo, hi = p * nsh, min((p + 1) * nsh, n)
        if hi > lo:
            a, b = int(indptr[lo]), int(indptr[hi])
            ci[p, : b - a] = indices[a:b]
            vv[p, : b - a] = data[a:b]
    return rp, ci, vv


def _range_slice(a, lo: int, nsh: int, fill, dtype) -> torch.Tensor:
    """``a[lo:lo + nsh]`` padded with ``fill`` to ``nsh`` entries."""
    a = np.asarray(a)
    out = np.full(nsh, fill, dtype)
    part = a[lo:lo + nsh]
    out[: len(part)] = part
    return torch.from_numpy(out)


def _columns(block, lo: int, ksh: int, k: int) -> torch.Tensor:
    """Columns ``lo:lo + ksh`` of a ``[k, k]`` block, or the block itself
    where it is already this part's ``[k, ksh]`` shard."""
    block = torch.as_tensor(block)
    if tuple(block.shape) == (k, ksh):
        return block
    if tuple(block.shape) != (k, k):
        raise ValueError(f"a hot block of shape {tuple(block.shape)} is "
                         f"neither [k, k] nor [k, k/P] = [{k}, {ksh}]")
    return block[:, lo:lo + ksh].contiguous()


def shard_resident_state(rg: dict, part: PartGroup, device,
                         ship_csr: bool = False) -> ShardedResidentGraph:
    """This part rank's shard of a `build_resident_graph` dict, on
    ``device``. ``dense`` / ``dense_t`` may be the whole blocks or this
    part's column shards. The CSR ships (row-range shard) only with
    ``ship_csr``: lite mode needs none on the device, full expansion
    (``resident_ship_cold=False``) reads it."""
    n, k, P = int(rg["n"]), int(rg["k"]), part.size
    if k % P:
        raise ValueError(f"hot slot count k={k} (a multiple of 128) "
                         f"must divide by n_parts={P}")
    ksh, nsh = k // P, -(-n // P)
    lo = part.rank * nsh
    slot = _range_slice(rg["slot_of_node"], lo, nsh, -1, np.int32)
    rv = _range_slice(rg["row_val"], lo, nsh, 0.0, np.float32)
    cv = _range_slice(rg.get("col_val", np.ones(n, np.float32)), lo, nsh,
                      0.0, np.float32)
    csr_kw = {}
    if ship_csr:
        rp, ci, vv = _csr_row_shards(rg["row_ptr"], rg["col_idx"],
                                     rg["val"], P, nsh)
        csr_kw = {f: torch.from_numpy(np.ascontiguousarray(a[part.rank])
                                      ).to(device)
                  for f, a in (("row_ptr_shard", rp), ("col_idx_shard", ci),
                               ("val_shard", vv))}
    return ShardedResidentGraph(
        slot_shard=slot.to(device), row_val_shard=rv.to(device),
        col_val_shard=cv.to(device),
        dense=_columns(rg["dense"], part.rank * ksh, ksh, k).to(device),
        dense_t=_columns(rg["dense_t"], part.rank * ksh, ksh, k).to(device),
        n=n, k=k, nsh=nsh, part=part,
        col_trivial=bool(rg.get("col_trivial", True)), **csr_kw)


def build_sharded_resident(lap: sp.csr_matrix, spec, dense, dense_t,
                           part: PartGroup, device="cpu",
                           ship_csr: bool = False):
    """This part's shard straight from the Laplacian and the blocks (from
    ``build_hot_dense``); returns ``(shard, val_free)``."""
    from gnn_tpu_torch.ops.residentgraph import build_resident_graph
    if int(spec.k) % part.size:
        raise ValueError(f"hot slot count k={spec.k} (a multiple of 128) "
                         f"must divide by n_parts={part.size}")
    rg = build_resident_graph(lap, spec, dense, dense_t)
    return shard_resident_state(rg, part, device, ship_csr), rg["val_free"]
