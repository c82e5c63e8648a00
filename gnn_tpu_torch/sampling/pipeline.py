"""Prefetching minibatch pipeline (host side): the counterpart of
`gnn_tpu.sampling.pipeline` for one rank of ``world_size``.

A thread pool samples the next minibatches while the device trains
(reference ``sampler.py:163-210``). An epoch's shuffle and every batch's
sampling seed derive from ``(seed, epoch)`` exactly as in the JAX
package: at each step every rank draws all ``world_size`` seeds in rank
order from one generator and samples only its own batch, so rank r's
batches are those the JAX pipeline samples for rank r. As the trainer
runs its val pass and checkpoint after an epoch, the pool already
samples the next epoch's first batches (cross-epoch priming).

Per-step training (:meth:`BatchPipeline.train_epoch`) keeps the shapes
the sampler gave each batch. Grouped training (``--steps_per_dispatch
G``, :meth:`BatchPipeline.train_epoch_grouped`) yields G batches at a
time re-padded to common shapes, as the JAX pipeline does: the group's
largest bucket, raised to a :class:`ShapeBook`'s sticky caps. The card
runs a group as one replay of a CUDA graph captured for those shapes, so
a new shape means a new capture; the caps only grow, so after the first
groups every group meets the same shapes. The padded arrays equal, bit
for bit, those the JAX pipeline's ``train_epoch_grouped`` stacks; the
port keeps a list of G batches where JAX stacks ``[G, ws, ...]``.
The resident format's layers (`ResidentLayerRef`) and the shipped COO
and hot formats' (`COOAdj`, `HotDenseAdj`) are re-padded; the pattern
and blocked formats' raise, as those formats do not run grouped yet
(ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np

from gnn_tpu_torch.ops.hotdense import HotDenseAdj
from gnn_tpu_torch.ops.residentgraph import ResidentLayerRef
from gnn_tpu_torch.ops.sparse import COOAdj
from gnn_tpu_torch.sampling.ladies import (MiniBatch, SamplerConfig,
                                           SAMPLERS, bucket_size)
from gnn_tpu_torch.utils.timing import count, span


# steps sampled ahead of the trainer
QUEUE_DEPTH = 8
# steps of the next epoch sampled while the trainer runs an epoch's tail
PRIME_DEPTH = 6 * QUEUE_DEPTH


class ShapeBook:
    """Sticky per-layer shape caps: every cap only grows, and every group
    pads up to the recorded maximum, so the number of distinct padded
    shapes (CUDA graph captures on the card) is the number of growth
    events, a handful early in the first epoch. Padding is inert (zero
    edges, zero-count tile entries, unread hot-slot rows), so the
    results do not change. Keys are ``(layer, nrows, ncols, type,
    kind)``, as the JAX package's. With a ``path`` the book is loaded
    from it and rewritten (tmp + rename) on every growth, so a rerun
    starts at the steady-state caps; a book that cannot be read starts
    empty."""

    def __init__(self, path: Optional[str] = None):
        self._caps = {}
        self._path = path
        if path is not None and os.path.exists(path):
            try:
                with open(path) as f:
                    self._caps = {str(k): int(v)
                                  for k, v in json.load(f).items()}
            except (OSError, ValueError, TypeError, AttributeError) as e:
                print(f"shape book {path} unusable ({e}); starting empty",
                      flush=True)

    def cap(self, key: tuple, value: int) -> int:
        """The cap for ``key``, first raised to ``value``."""
        k = "|".join(str(x) for x in key)
        cur = self._caps.get(k, 0)
        if value > cur:
            self._caps[k] = cur = value
            self._save()
        return cur

    def _save(self):
        if self._path is None:
            return
        tmp = f"{self._path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(self._caps, f)
            os.replace(tmp, self._path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def _book_cap(book: ShapeBook, l: int, a, kind: str, value: int) -> int:
    """Sticky cap keyed by (layer, padded shape, type, kind)."""
    return book.cap((l, a.nrows, a.ncols, type(a).__name__, kind), value)


def _repad_coo(adj, nnz_pad: int):
    """A shipped COO's edge arrays padded to ``nnz_pad`` edges (the JAX
    pipeline's ``_repad_coo``): pad rows at the last row, cols and values
    0, so row-sorted edges stay sorted; a col-sorted copy (``rows_t`` /
    ``cols_t`` / ``vals_t``) pads its cols at the last column."""
    pad = nnz_pad - adj.rows.shape[0]
    if pad == 0:
        return adj

    def ext(a, fill=0):
        return np.concatenate([a, np.full(pad, fill, a.dtype)])

    fields = dict(rows=ext(adj.rows, adj.nrows - 1), cols=ext(adj.cols),
                  vals=ext(adj.vals))
    if isinstance(adj, HotDenseAdj):
        fields.update(rows_t=ext(adj.rows_t),
                      cols_t=ext(adj.cols_t, adj.ncols - 1),
                      vals_t=ext(adj.vals_t))
    return dataclasses.replace(adj, **fields)


def _unify_shipped(layer: list, l: int, book: ShapeBook) -> list:
    """One layer's shipped COO or hot layers of a group, re-padded (the
    JAX pipeline's ``_unify_layer`` for ``COOAdj`` / ``HotDenseAdj``):
    the edges to the bucket of the group's largest count, raised to the
    book's cap; a hot layer's batch-present slot lists with zeros to the
    group's longest, raised to its caps. A pad slot stays inert: no
    ``row_cmp_idx`` / ``col_cmp_idx`` entry points at it."""
    nnz = _book_cap(book, l, layer[0], "nnz",
                    bucket_size(max(a.rows.shape[0] for a in layer)))
    layer = [_repad_coo(a, nnz) for a in layer]
    if not isinstance(layer[0], HotDenseAdj):
        return layer
    rh = _book_cap(book, l, layer[0], "rh",
                   max(a.present_row_slots.shape[0] for a in layer))
    ch = _book_cap(book, l, layer[0], "ch",
                   max(a.present_col_slots.shape[0] for a in layer))

    def pad1(a, m):
        return np.concatenate([a, np.zeros(m - a.shape[0], a.dtype)])

    return [dataclasses.replace(
        a, present_row_slots=pad1(a.present_row_slots, rh),
        present_col_slots=pad1(a.present_col_slots, ch)) for a in layer]


def _unify_layer(layer: list, l: int, book: ShapeBook) -> list:
    """One layer's adjacencies of a group, re-padded to common shapes:
    the group's largest, raised to the book's caps (the JAX pipeline's
    ``_unify_layer``). Shipped COO and hot layers go to
    :func:`_unify_shipped`. Of resident refs, the lite COO's arrays pad
    with zero-valued edges at the last row, the stream tiles with
    zero-count entries (``repad_tiles``); ``e_cap``, ``rh_pad`` and
    ``ch_pad`` size device buffers and take the group's maximum. The
    pattern and blocked formats' layers raise."""
    if isinstance(layer[0], (COOAdj, HotDenseAdj)):
        return _unify_shipped(layer, l, book)
    if not isinstance(layer[0], ResidentLayerRef):
        raise TypeError(
            f"grouped dispatch does not re-pad {type(layer[0]).__name__} "
            f"layers yet (ROADMAP.md)")
    nnz = _book_cap(book, l, layer[0], "nnz",
                    max(x.nnz_cold for x in layer))

    def ext(a, fill=0):
        if a is None or a.shape[0] == nnz:
            return a
        return np.concatenate(
            [a, np.full(nnz - a.shape[0], fill, a.dtype)])

    if layer[0].cols is not None:
        layer = [dataclasses.replace(a, cols=ext(a.cols),
                                     rows=ext(a.rows, a.nrows - 1),
                                     vals=ext(a.vals)) for a in layer]
    if layer[0].es_rc is not None:
        from gnn_tpu_torch.ops.edgestream import repad_tiles
        nbp = _book_cap(book, l, layer[0], "nbp",
                        max(x.es_rc.shape[0] for x in layer))
        ncr = _book_cap(book, l, layer[0], "ncr",
                        max(x.es_coords.shape[0] for x in layer))
        fixed = []
        for a in layer:
            c2, rc2, off2, ord2, v2 = repad_tiles(
                a.es_coords, a.es_rc, a.es_off, a.es_ord, nbp, ncr,
                a.nrows // a.es_bm, a.ncols // a.es_bk, vals=a.es_vals)
            fixed.append(dataclasses.replace(
                a, es_coords=c2, es_rc=rc2, es_off=off2, es_ord=ord2,
                es_vals=v2))
        layer = fixed
    caps = dict(
        e_cap=_book_cap(book, l, layer[0], "ecap",
                        max(x.e_cap for x in layer)),
        nnz_cold=nnz,
        rh_pad=_book_cap(book, l, layer[0], "rh",
                         max(x.rh_pad for x in layer)),
        ch_pad=_book_cap(book, l, layer[0], "ch",
                         max(x.ch_pad for x in layer)))
    return [dataclasses.replace(a, **caps) for a in layer]


def _adj_bytes(mbs: List[MiniBatch]) -> int:
    """Bytes of the arrays of a group's adjacencies (one shared by
    several layers counts once)."""
    seen = {id(a): a for mb in mbs for a in mb.adjs if a is not None}
    return sum(v.nbytes for a in seen.values()
               for v in vars(a).values() if isinstance(v, np.ndarray))


def unify_group(mbs: List[MiniBatch], book: ShapeBook) -> List[MiniBatch]:
    """A group's batches with every layer re-padded to the group's common
    shapes (:func:`_unify_layer`); the node sets and labels already share
    the sampler's static caps. Counts the bytes the re-padding added
    (``pipeline.repad_bytes``)."""
    out = [dataclasses.replace(mb, adjs=list(mb.adjs)) for mb in mbs]
    for l in range(len(mbs[0].adjs)):
        if mbs[0].adjs[l] is None:
            continue
        for mb, a in zip(out, _unify_layer([mb.adjs[l] for mb in mbs], l,
                                           book)):
            mb.adjs[l] = a
    count("pipeline.repad_bytes", _adj_bytes(out) - _adj_bytes(mbs))
    return out


def _rank_chunks(n_targets: int, world_size: int):
    chunk = n_targets // world_size
    if n_targets % world_size:
        chunk += 1
    return [(r * chunk, min((r + 1) * chunk, n_targets))
            for r in range(world_size)]


def _same_targets(a, b):
    if a is None or b is None:
        return a is b
    if isinstance(a, list) or isinstance(b, list):
        return (isinstance(a, list) and isinstance(b, list)
                and len(a) == len(b)
                and all(np.array_equal(x, y) for x, y in zip(a, b)))
    return np.array_equal(a, b)


class BatchPipeline:
    """Prefetching minibatch source for rank ``rank`` of ``world_size``
    data-parallel ranks (one device: rank 0 of 1)."""

    def __init__(self, cfg: SamplerConfig, lap_matrix, labels_full,
                 pool_num: int = 4,
                 per_rank_skew: Optional[List[List[np.ndarray]]] = None,
                 local_shuffle: bool = False, seed: int = 0,
                 world_size: int = 1, rank: int = 0,
                 shape_book_path: Optional[str] = None):
        """``per_rank_skew``: per-layer skew lists, one per placement
        buffer (each rank skews toward its own resident nodes, reference
        ``sampler.py:23-25``); rank r samples its batches with list
        ``r % len(per_rank_skew)``, the JAX pipeline's rule (the composed
        ``--resident_parts --feature_cache`` placement has one buffer a
        part, which may be fewer than the data ranks).
        ``shape_book_path``: where the grouped path's :class:`ShapeBook`
        persists (None: in memory only)."""
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} of {world_size}")
        self.cfg = cfg
        self.lap = lap_matrix
        self.labels = labels_full
        self.world_size = world_size
        self.rank = rank
        self.per_rank_skew = per_rank_skew
        # layer 0's skew set (this rank's own buffer) as a node mask
        self._skew_mask = None
        if per_rank_skew is not None:
            self._skew_mask = np.zeros(cfg.num_nodes, bool)
            self._skew_mask[self._skew_of(rank)[0]] = True
        self.pool = ThreadPoolExecutor(max_workers=pool_num)
        self.local_shuffle = local_shuffle
        self._sampler = SAMPLERS[cfg.sampler]
        self.shape_book = ShapeBook(shape_book_path)
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._epoch = 0
        # the next epoch's first steps, submitted once this epoch's last
        # step is (see train_epoch); None when nothing is primed
        self._primed = None
        # the last epoch to train (set by Trainer.fit): nothing is primed
        # past it, so the final test sweep's batches queue behind nothing
        self.final_epoch: Optional[int] = None
        # native OpenMP width so pool x OMP ~= 2x cores
        from gnn_tpu_torch import native as _native
        lib = _native.get_lib()
        if lib is not None:
            import os
            ncpu = os.cpu_count() or 4
            lib.set_threads(max(1, round(2 * ncpu / max(pool_num, 1))))

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)

    def skew_share(self, mb: MiniBatch) -> float:
        """The share of ``mb``'s layer-0 input nodes that lie in this
        rank's skew set; NaN without a skew."""
        if self._skew_mask is None:
            return float("nan")
        return float(self._skew_mask[mb.input_nodes[: mb.n_input]].mean())

    def _skew_of(self, rank):
        return self.per_rank_skew[rank % len(self.per_rank_skew)]

    def _sample_one(self, seed, batch_nodes, cfg, rank=0):
        """One batch of ``batch_nodes`` under ``cfg``, skewed toward rank
        ``rank``'s nodes (a span ``sampler.batch``; the counter
        ``sampler.batches``)."""
        skew = None if self.per_rank_skew is None else self._skew_of(rank)
        with span("sampler.batch"):
            mb = self._sampler(cfg, seed, batch_nodes, self.lap,
                               self.labels, skew)
        count("sampler.batches")
        return mb

    def _epoch_plan(self, target_nodes, rank_chunks, eid):
        """Every rank's shuffled chunk + the step count for internal epoch
        id ``eid`` (a pure function of (eid, targets)): one global shuffle
        cut into disjoint chunks, each rank's span shuffled alone
        (``local_shuffle``), or the given ``rank_chunks`` each shuffled."""
        ws, bs = self.world_size, self.cfg.batch_size
        if rank_chunks is None:
            n = len(target_nodes)
            if self.local_shuffle:
                spans = _rank_chunks(n, ws)
                per_rank = [
                    target_nodes[s + np.random.default_rng(
                        eid * ws + r).permutation(e - s)]
                    for r, (s, e) in enumerate(spans)]
            else:
                perm = np.random.default_rng(eid).permutation(n)
                shuffled = target_nodes[perm]
                spans = _rank_chunks(n, ws)
                per_rank = [shuffled[s:e] for s, e in spans]
        else:
            # more lists than ranks (the composed cache's placement has
            # one a part): every list is shuffled and counts toward the
            # step count, and rank r samples list r, as in the JAX package
            if len(rank_chunks) < ws:
                raise ValueError(
                    f"{len(rank_chunks)} rank chunks for {ws} ranks: every "
                    f"rank needs its own list (the JAX pipeline fails "
                    f"here with an IndexError)")
            per_rank = [
                c[np.random.default_rng(
                    eid * ws + r).permutation(len(c))]
                for r, c in enumerate(rank_chunks)]
        num_steps = max(int(np.ceil(len(c) / bs)) for c in per_rank)
        return per_rank, num_steps

    def _submit_step(self, per_rank, rng, j):
        """Draw step ``j``'s seeds for every rank, in rank order, and
        submit this rank's batch. A rank whose chunk ran out before the
        last step cycles through it again (every rank needs a batch at
        every step)."""
        ws, bs, r = self.world_size, self.cfg.batch_size, self.rank
        seeds = [int(rng.integers(2 ** 31 - 1)) for _ in range(ws)]
        chunk = per_rank[r][j * bs:(j + 1) * bs]
        if len(chunk) == 0:
            nr = len(per_rank[r])
            idx = np.arange(j * bs, j * bs + bs) % max(nr, 1)
            chunk = per_rank[r][idx]
        # the config is bound here, at submission: a worker that runs
        # later never sees a factor the tuner set in the meantime
        return self.pool.submit(self._sample_one, seeds[r], chunk, self.cfg,
                                r)

    def _prime(self, epoch, target_nodes, rank_chunks):
        """Submit the first steps of epoch ``epoch`` from a fresh
        ``rng((seed, epoch))``, the stream `train_epoch` would start, so
        the primed batches are the ones it would sample."""
        eid = epoch + 1
        rng = np.random.default_rng((self._seed, epoch))
        per_rank, num_steps = self._epoch_plan(target_nodes, rank_chunks,
                                               eid)
        futures = [self._submit_step(per_rank, rng, j)
                   for j in range(min(PRIME_DEPTH, num_steps))]
        self._primed = dict(eid=eid, rng=rng, per_rank=per_rank,
                            num_steps=num_steps, futures=futures,
                            targets=target_nodes, chunks=rank_chunks,
                            cfg=self.cfg)

    @staticmethod
    def _discard(primed):
        """Drop a prime nobody adopts: cancel the futures not started, and
        warn of an error in those that ran or are running."""
        def observe(f):
            exc = None if f.cancelled() else f.exception()
            if exc is not None:
                warnings.warn(f"discarded primed batch raised: {exc!r}")
        for f in primed["futures"]:
            if not f.cancel():
                f.add_done_callback(observe)

    def train_epoch(self, target_nodes: np.ndarray,
                    rank_chunks: Optional[List[np.ndarray]] = None,
                    epoch: Optional[int] = None,
                    depth: int = QUEUE_DEPTH) -> Iterator[MiniBatch]:
        """Yield this rank's minibatches of one epoch, keeping ``depth``
        steps sampled ahead. Passing ``epoch``
        pins the epoch's shuffle and sampling randomness to (seed, epoch)
        and primes epoch + 1 once this epoch is submitted (up to
        ``final_epoch``). A primed epoch is adopted only for the same
        targets and the same config object: after the tuner replaced
        ``cfg``, the epoch is sampled afresh under the new one."""
        primed, self._primed = self._primed, None
        futures = []
        if (epoch is not None and primed is not None
                and primed["eid"] == epoch + 1 and primed["cfg"] is self.cfg
                and _same_targets(primed["targets"], target_nodes)
                and _same_targets(primed["chunks"], rank_chunks)):
            self._epoch, self._rng = primed["eid"], primed["rng"]
            per_rank, num_steps = primed["per_rank"], primed["num_steps"]
            futures = primed["futures"]
        else:
            if primed is not None:
                self._discard(primed)
            if epoch is not None:
                self._epoch = epoch + 1
                self._rng = np.random.default_rng((self._seed, epoch))
            else:
                self._epoch += 1
            per_rank, num_steps = self._epoch_plan(target_nodes, rank_chunks,
                                                   self._epoch)
        rng = self._rng
        submitted = len(futures)

        def maybe_prime():
            if (epoch is not None and self._primed is None
                    and (self.final_epoch is None
                         or epoch < self.final_epoch)):
                self._prime(epoch + 1, target_nodes, rank_chunks)

        def submit():
            nonlocal submitted
            futures.append(self._submit_step(per_rank, rng, submitted))
            submitted += 1
            if submitted == num_steps:
                maybe_prime()

        while submitted < min(num_steps, depth):
            submit()
        if submitted >= num_steps:
            maybe_prime()
        for _ in range(num_steps):
            fut = futures.pop(0)
            if submitted < num_steps:
                submit()
            with span("pipeline.wait"):
                mb = fut.result()
            yield mb

    def train_epoch_grouped(self, target_nodes: np.ndarray,
                            rank_chunks: Optional[List[np.ndarray]] = None,
                            epoch: Optional[int] = None, group: int = 1
                            ) -> Iterator[Tuple[List[MiniBatch], int]]:
        """Yield ``(batches, n_valid)``: ``group`` consecutive batches of
        :meth:`train_epoch` re-padded to common shapes
        (:func:`unify_group`, the pipeline's :attr:`shape_book`). The
        last group, when the epoch's steps do not divide by ``group``,
        repeats its last batch up to ``group`` and carries ``n_valid <
        group``: only its first ``n_valid`` batches are steps. About two
        groups are sampled ahead, so the pool works while a group
        trains."""
        pending: List[MiniBatch] = []
        for mb in self.train_epoch(target_nodes, rank_chunks, epoch,
                                   depth=max(QUEUE_DEPTH, 2 * group + 1)):
            pending.append(mb)
            if len(pending) == group:
                with span("pipeline.repad"):
                    mbs = unify_group(pending, self.shape_book)
                yield mbs, group
                pending = []
        if pending:
            n_valid = len(pending)
            pending += [pending[-1]] * (group - n_valid)
            with span("pipeline.repad"):
                mbs = unify_group(pending, self.shape_book)
            yield mbs, n_valid

    def eval_batches(self, target_nodes: np.ndarray, batch_size: int,
                     mode: str = "val") -> Iterator[MiniBatch]:
        """Evaluation batches (reference ``sampler.py:194-210``): val =
        one random batch, the same on every rank (skewed as rank 0's);
        test = this rank's share of the full sweep
        (:meth:`eval_batches_sharded`)."""
        if mode != "val":
            yield from self.eval_batches_sharded(target_nodes, batch_size)
            return
        cfg = self.cfg
        if batch_size > cfg.batch_size:
            cfg = dataclasses.replace(cfg, batch_size=batch_size)
        idx = self._rng.permutation(len(target_nodes))[:batch_size]
        yield self._sample_one(int(self._rng.integers(2 ** 31 - 1)),
                               target_nodes[idx], cfg)

    def eval_batches_sharded(self, target_nodes: np.ndarray,
                             batch_size: int) -> Iterator[MiniBatch]:
        """This rank's share of the full sweep: of each group of
        ``world_size`` consecutive batches, the r-th, sampled with rank
        r's skew (every rank draws every batch's seed). Where the last
        group has no r-th batch, the rank gets a filler: the group's last
        batch with empty label and input masks, which contributes nothing
        but keeps the rank in step with the others' exchanges. One rank
        sweeps every batch."""
        cfg = self.cfg
        if batch_size > cfg.batch_size:
            cfg = dataclasses.replace(cfg, batch_size=batch_size)
        ws, r = self.world_size, self.rank
        n_batches = int(np.ceil(len(target_nodes) / batch_size))
        seeds = [int(self._rng.integers(2 ** 31 - 1))
                 for _ in range(n_batches)]

        def nodes(j):
            return target_nodes[j * batch_size:(j + 1) * batch_size]

        futs = {j: self.pool.submit(self._sample_one, seeds[j], nodes(j),
                                    cfg, j % ws)
                for j in range(r, n_batches, ws)}
        for g in range(0, n_batches, ws):
            j = g + r
            if j < n_batches:
                with span("pipeline.wait"):
                    mb = futs[j].result()
                yield mb
                continue
            last = n_batches - 1
            mb = self._sample_one(seeds[last], nodes(last), cfg, last % ws)
            yield dataclasses.replace(
                mb, label_mask=np.zeros_like(mb.label_mask),
                input_mask=np.zeros_like(mb.input_mask))
