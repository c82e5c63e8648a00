"""Edge-partitioned distributed aggregation with a halo exchange: the
counterpart of `gnn_tpu.parallel.halo`.

The graph's rows are cut into contiguous partitions, one a rank; each
rank owns its nodes' features and activations, and a layer's
aggregation ``y = A @ x`` runs as

    y_local = A_intra @ x_local  +  A_halo @ x_halo

where ``x_halo`` (the rows owned by other ranks that this rank's edges
read) arrives through one ``all_to_all_single`` over the ranks' group.
The host builds the plan once (it depends only on the graph):
:func:`build_halo_plan` and :func:`partition_features` are numpy copies
of the JAX functions and give the same arrays bit for bit, with the
leading ``[D]`` axis. :class:`LocalHaloPlan` is one rank's row of the
plan on its device, made once per trainer.

The exchange (:class:`_HaloExchange`) sends ``D`` segments of ``H`` rows
(the JAX layout, including the zero segment a rank sends itself), so
every rank sends and receives ``D * H`` rows whatever its halo edges.
Its backward is the same all-to-all applied to the cotangents: a
received row's gradient goes back to the rank that owns the row, where
the take's transpose (``index_select``'s backward) adds it onto
``x_local``, as the transpose of the JAX ``all_to_all`` does. Every rank
enters every forward and backward exchange in the same order because
every rank runs the same layers. The two aggregations are
`gnn_tpu_torch.ops.sparse.spmm` over a COO (chunked ``index_add_``,
backward the transposed aggregation), so the ``[edges, F]`` gather
temporary stays bounded at any width. A world of one exchanges nothing
and computes ``A_intra @ x``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from gnn_tpu_torch.ops.sparse import COOAdj, spmm
from gnn_tpu_torch.parallel.dist import DistContext


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class HaloPlan:
    """The exchange plan and the partitioned adjacency, every array with
    a leading ``[D]`` rank axis. For rank d:

    - ``intra`` — COO of the edges whose source is local, cols indexing
      the local x slab;
    - ``halo`` — COO of the edges whose source is remote, cols indexing
      the received halo buffer (one ``H``-row segment per owner);
    - ``send_idx[d, o, j]`` — local row j that rank d sends to rank o
      (``send_mask`` 0 marks padding);
    - ``n_local`` — rows per rank (padded, the same everywhere);
    - ``halo_width`` — ``H``, the rows of one segment."""

    intra_rows: np.ndarray   # int32 [D, nnz_i]
    intra_cols: np.ndarray   # int32 [D, nnz_i]
    intra_vals: np.ndarray   # f32 [D, nnz_i]
    halo_rows: np.ndarray    # int32 [D, nnz_h]
    halo_cols: np.ndarray    # int32 [D, nnz_h]
    halo_vals: np.ndarray    # f32 [D, nnz_h]
    send_idx: np.ndarray     # int32 [D, D, H]
    send_mask: np.ndarray    # f32 [D, D, H]
    n_local: int
    halo_width: int

    @property
    def num_devs(self) -> int:
        return self.send_idx.shape[0]


def build_halo_plan(adj: sp.csr_matrix, num_devs: int,
                    pad_multiple: int = 8) -> Tuple[HaloPlan, np.ndarray]:
    """Partition rows contiguously across ``num_devs`` ranks and build the
    exchange plan. Returns (plan, owner_of_node)."""
    n = adj.shape[0]
    n_local = _round_up((n + num_devs - 1) // num_devs, pad_multiple)
    owner = np.minimum(np.arange(n) // n_local, num_devs - 1)

    coo = adj.tocoo()
    e_owner = owner[coo.row]
    intra: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    halo_parts = []
    # per (dest d, owner o): which of o's local rows d needs
    need: List[List[np.ndarray]] = [[None] * num_devs
                                    for _ in range(num_devs)]
    for d in range(num_devs):
        mine = e_owner == d
        r = coo.row[mine] - d * n_local
        c = coo.col[mine]
        v = coo.data[mine].astype(np.float32)
        c_owner = owner[c]
        local = c_owner == d
        intra.append((r[local].astype(np.int32),
                      (c[local] - d * n_local).astype(np.int32),
                      v[local]))
        rem_r, rem_c, rem_v, rem_o = (r[~local], c[~local], v[~local],
                                      c_owner[~local])
        halo_parts.append((rem_r, rem_c, rem_v, rem_o))
        for o in range(num_devs):
            sel = rem_c[rem_o == o]
            need[d][o] = np.unique(sel) - o * n_local

    H = max(1, max((len(need[d][o]) for d in range(num_devs)
                    for o in range(num_devs)), default=1))
    H = _round_up(H, 8)
    send_idx = np.zeros((num_devs, num_devs, H), np.int32)
    send_mask = np.zeros((num_devs, num_devs, H), np.float32)
    for d in range(num_devs):
        for o in range(num_devs):
            ids = need[d][o]
            # rank o sends these local rows to rank d
            send_idx[o, d, : len(ids)] = ids
            send_mask[o, d, : len(ids)] = 1.0

    # halo edge columns into the received buffer's layout: on rank d,
    # [owner 0 segment | owner 1 segment | ...], each H wide
    halo = []
    for d in range(num_devs):
        rem_r, rem_c, rem_v, rem_o = halo_parts[d]
        new_c = np.empty(len(rem_c), np.int64)
        for o in range(num_devs):
            sel = rem_o == o
            pos = np.searchsorted(need[d][o], rem_c[sel] - o * n_local)
            new_c[sel] = o * H + pos
        halo.append((rem_r.astype(np.int32), new_c.astype(np.int32),
                     rem_v))

    nnz_i = _round_up(max(1, max(len(t[0]) for t in intra)), 8)
    nnz_h = _round_up(max(1, max(len(t[0]) for t in halo)), 8)

    def pad_stack(parts, width):
        rr = np.zeros((num_devs, width), np.int32)
        cc = np.zeros((num_devs, width), np.int32)
        vv = np.zeros((num_devs, width), np.float32)
        for d, (r, c, v) in enumerate(parts):
            rr[d, : len(r)] = r
            cc[d, : len(c)] = c
            vv[d, : len(v)] = v
        return rr, cc, vv

    ir, ic, iv = pad_stack(intra, nnz_i)
    hr, hc, hv = pad_stack(halo, nnz_h)
    plan = HaloPlan(intra_rows=ir, intra_cols=ic, intra_vals=iv,
                    halo_rows=hr, halo_cols=hc, halo_vals=hv,
                    send_idx=send_idx, send_mask=send_mask,
                    n_local=int(n_local), halo_width=int(H))
    return plan, owner


def partition_features(feats: np.ndarray, owner: np.ndarray,
                       num_devs: int, n_local: int) -> np.ndarray:
    """Stack node rows into the ``[D, n_local, F]`` partitioned layout."""
    out = np.zeros((num_devs, n_local, feats.shape[1]), feats.dtype)
    for d in range(num_devs):
        mine = np.flatnonzero(owner == d)
        out[d, : len(mine)] = feats[mine]
    return out


@dataclasses.dataclass
class LocalHaloPlan:
    """Rank ``rank``'s row of a :class:`HaloPlan` on its device: the
    intra and halo COOs, and the flat ``[D * H]`` send rows and mask."""

    intra: COOAdj
    halo: COOAdj
    send_idx: torch.Tensor      # int64 [D * H]
    send_mask: torch.Tensor     # f32 [D * H]
    num_devs: int

    @classmethod
    def from_plan(cls, plan: HaloPlan, rank: int, device) -> "LocalHaloPlan":
        D, H, nl = plan.num_devs, plan.halo_width, plan.n_local

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        def coo(rows, cols, vals, ncols):
            return COOAdj(rows=t(rows[rank]), cols=t(cols[rank]),
                          vals=t(vals[rank]), n_valid_rows=nl,
                          n_valid_cols=ncols, nrows=nl, ncols=ncols)
        return cls(
            intra=coo(plan.intra_rows, plan.intra_cols, plan.intra_vals, nl),
            halo=coo(plan.halo_rows, plan.halo_cols, plan.halo_vals, D * H),
            send_idx=t(plan.send_idx[rank].reshape(-1).astype(np.int64)),
            send_mask=t(plan.send_mask[rank].reshape(-1)), num_devs=D)


# bytes each rank sent through the halo exchange, forward and backward
# (the figure chip_smoke.py logs a step)
exchange_bytes = {"sent": 0}


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s equal segments, one a rank, exchanged over ``group``."""
    x = x.contiguous()
    out = torch.empty_like(x)
    exchange_bytes["sent"] += x.numel() * x.element_size()
    dist.all_to_all_single(out, x, group=group)
    return out


class _HaloExchange(torch.autograd.Function):
    """The served rows ``[D * H, F]`` in, the rows every owner served
    this rank out; backward the same all-to-all of the cotangents, which
    returns each received row's gradient to its owner."""

    @staticmethod
    def forward(ctx, served, group):
        ctx.group = group
        return _all_to_all(served, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def halo_spmm_local(plan: LocalHaloPlan, x_local: torch.Tensor,
                    ctx: DistContext) -> torch.Tensor:
    """One rank's ``y_local = A_intra @ x_local + A_halo @ x_halo``:
    take the rows it serves (masked), exchange them, aggregate both
    parts. ``plan`` is rank ``ctx.rank``'s, of a plan over
    ``ctx.world_size`` ranks."""
    if plan.num_devs != ctx.world_size:
        raise ValueError(f"a halo plan over {plan.num_devs} ranks on a "
                         f"world of {ctx.world_size}")
    y = spmm(plan.intra, x_local)
    if ctx.world_size == 1:
        return y
    served = (x_local.index_select(0, plan.send_idx)
              * plan.send_mask[:, None])
    halo_x = _HaloExchange.apply(served, ctx.group)
    return y + spmm(plan.halo, halo_x)


def distributed_spmm(plan: LocalHaloPlan, x_local: torch.Tensor,
                     ctx: DistContext) -> torch.Tensor:
    """``y = A @ x`` with ``x`` and ``y`` partitioned ``[n_local, F]`` a
    rank: the counterpart of `gnn_tpu.parallel.halo.make_distributed_spmm`
    (one rank's call; every rank of ``ctx`` calls it together)."""
    return halo_spmm_local(plan, x_local, ctx)
