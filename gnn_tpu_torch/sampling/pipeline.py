"""Prefetching minibatch pipeline (host side): the one-device counterpart
of `gnn_tpu.sampling.pipeline`.

A thread pool samples the next minibatches while the device trains
(reference ``sampler.py:163-210``). An epoch's shuffle and every batch's
sampling seed derive from ``(seed, epoch)`` exactly as in the JAX
package, so both packages yield the same batch stream.

What the JAX pipeline has and this one does not, by decision (ROADMAP):
``ShapeBook`` and the group stacking/re-padding exist to stop XLA from
recompiling on new shapes; PyTorch runs eagerly, so each batch keeps the
shapes its sampler gave it. The cross-epoch priming and the multi-rank
chunking wait for the multi-device slice.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional

import numpy as np

from gnn_tpu_torch.sampling.ladies import MiniBatch, SamplerConfig, SAMPLERS


# batches sampled ahead of the trainer
QUEUE_DEPTH = 8


def _rank_chunks(n_targets: int, world_size: int):
    chunk = n_targets // world_size
    if n_targets % world_size:
        chunk += 1
    return [(r * chunk, min((r + 1) * chunk, n_targets))
            for r in range(world_size)]


class BatchPipeline:
    """Prefetching minibatch source for one trainer on one device."""

    def __init__(self, cfg: SamplerConfig, lap_matrix, labels_full,
                 pool_num: int = 4, local_shuffle: bool = False,
                 seed: int = 0):
        self.cfg = cfg
        self.lap = lap_matrix
        self.labels = labels_full
        self.world_size = 1
        self.pool = ThreadPoolExecutor(max_workers=pool_num)
        self.local_shuffle = local_shuffle
        self._sampler = SAMPLERS[cfg.sampler]
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._epoch = 0
        # native OpenMP width so pool x OMP ~= 2x cores
        from gnn_tpu_torch import native as _native
        lib = _native.get_lib()
        if lib is not None:
            import os
            ncpu = os.cpu_count() or 4
            lib.set_threads(max(1, round(2 * ncpu / max(pool_num, 1))))

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)

    def _sample_one(self, seed, batch_nodes, cfg=None):
        return self._sampler(cfg or self.cfg, seed, batch_nodes, self.lap,
                             self.labels)

    def _epoch_plan(self, target_nodes, rank_chunks, eid):
        """Shuffled chunk + step count for internal epoch id ``eid`` (a
        pure function of (eid, targets))."""
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
            per_rank = [
                c[np.random.default_rng(
                    eid * ws + r).permutation(len(c))]
                for r, c in enumerate(rank_chunks)]
        num_steps = max(int(np.ceil(len(c) / bs)) for c in per_rank)
        return per_rank, num_steps

    def _submit_step(self, per_rank, rng, j):
        ws, bs = self.world_size, self.cfg.batch_size
        group = []
        for r in range(ws):
            chunk = per_rank[r][j * bs:(j + 1) * bs]
            if len(chunk) == 0:
                nr = len(per_rank[r])
                idx = np.arange(j * bs, j * bs + bs) % max(nr, 1)
                chunk = per_rank[r][idx]
            seed = int(rng.integers(2 ** 31 - 1))
            group.append(self.pool.submit(self._sample_one, seed, chunk))
        return group

    def train_epoch(self, target_nodes: np.ndarray,
                    rank_chunks: Optional[List[np.ndarray]] = None,
                    epoch: Optional[int] = None) -> Iterator[MiniBatch]:
        """Yield one epoch's minibatches. Passing ``epoch`` pins the
        epoch's shuffle and sampling randomness to (seed, epoch)."""
        if epoch is not None:
            self._epoch = epoch + 1
            self._rng = np.random.default_rng((self._seed, epoch))
        else:
            self._epoch += 1
        per_rank, num_steps = self._epoch_plan(target_nodes, rank_chunks,
                                               self._epoch)
        rng = self._rng
        depth = QUEUE_DEPTH
        futures = []
        submitted = 0
        while submitted < num_steps and submitted < depth:
            futures.append(self._submit_step(per_rank, rng, submitted))
            submitted += 1
        for _ in range(num_steps):
            group = futures.pop(0)
            if submitted < num_steps:
                futures.append(self._submit_step(per_rank, rng, submitted))
                submitted += 1
            yield group[0].result()

    def eval_batches(self, target_nodes: np.ndarray, batch_size: int,
                     mode: str = "val") -> Iterator[MiniBatch]:
        """Evaluation batches (reference ``sampler.py:194-210``): val =
        one random batch; test = full sweep."""
        cfg = self.cfg
        if batch_size > cfg.batch_size:
            cfg = dataclasses.replace(cfg, batch_size=batch_size)
        if mode == "val":
            idx = self._rng.permutation(len(target_nodes))[:batch_size]
            yield self._sample_one(int(self._rng.integers(2 ** 31 - 1)),
                                   target_nodes[idx], cfg)
            return
        n_batches = int(np.ceil(len(target_nodes) / batch_size))
        futs = [self.pool.submit(
            self._sample_one, int(self._rng.integers(2 ** 31 - 1)),
            target_nodes[j * batch_size:(j + 1) * batch_size], cfg)
            for j in range(n_batches)]
        for f in futs:
            yield f.result()
