"""Op-bucket timing probes (``--op_timing``): per-step spmm forward /
backward and communication seconds from isolated ops on the epoch's
last batch, the reference's ``main.py:196`` buckets (the counterpart of
`gnn_tpu.train.optiming`). On the part-sharded resident graph each
probe is a layer's resident rebuild plus its ``spmm`` or
``spmm_transpose``, part sums included, as the JAX package's part
branch times it: no rank holds a layer whole."""
from __future__ import annotations

import time

import numpy as np
import torch

from gnn_tpu_torch.parallel.dist import all_reduce_sum_
from gnn_tpu_torch.train.stepfns import prepare_adjs
from gnn_tpu_torch.utils.timing import cuda_time_ms


class OpTimingMixin:
    """`measure_op_buckets` and its helpers (a mixin over `Trainer`,
    which sets ``n_feats``, ``agg_state``, ``dist`` and
    ``feature_source``)."""

    def _layer_widths(self):
        """Per-layer input feature widths of the encoder stack (the
        widths of the spmm operands)."""
        from gnn_tpu_torch.models.gnn import GraphSage
        # GATv1 has no separate encoder: its layers read nhid wide too
        enc = getattr(self.net, "encoder", self.net)
        # reference `models.py:36`: GraphSAGE layer i reads
        # (1 + orders[i-1]) * nhid
        mult = [(1 + o) if isinstance(enc, GraphSage) else 1
                for o in enc.orders[:-1]]
        return [self.n_feats] + [m * enc.nhid for m in mult]

    def _time_s(self, fn) -> float:
        """Seconds of one ``fn()`` call: on the card, a warm-up call and
        the median of several rounds by CUDA events; on the CPU, the
        mean of three calls after one warm-up by the host clock."""
        if self.device.type == "cuda":
            return cuda_time_ms(fn) / 1e3
        fn()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        return (time.perf_counter() - t0) / 3

    @torch.no_grad()
    def measure_op_buckets(self, batch):
        """``(spmm forward, spmm backward, communication)`` seconds a
        step, each aggregating layer's ``spmm`` and ``spmm_transpose``
        timed alone on ``batch`` (the epoch's last device batch) at the
        layer's input width, with operands drawn from ``default_rng(0)``.
        Pattern layers (GAT off the resident path) have no standalone
        spmm and are skipped; on the part-sharded resident graph each
        call rebuilds the layer as well. Communication, across ranks, is
        the step's one ``all_reduce`` of the flat gradient buffer plus,
        with a feature source that exchanges rows (the cache, the part
        shards), ``batch``'s feature gather; one device runs no
        collective and reads 0.0. Every rank runs the
        probe at the same point, since it times collectives. The result
        is cached keyed on the current ``scale_factor`` (the same on
        every rank): the sampled-set sizes, and so the buckets, move with
        it."""
        from gnn_tpu_torch.ops.residentgraph import (layer_ids,
                                                     materialize_layer)
        from gnn_tpu_torch.ops.sparse import PatternAdj, spmm, spmm_transpose
        from gnn_tpu_torch.parallel.feature_cache import ReplicatedFeatures
        from gnn_tpu_torch.parallel.shardedresident import \
            ShardedResidentGraph

        sf_key = float(self.pipeline.cfg.scale_factor)
        cached = getattr(self, "_op_buckets", None)
        if cached is not None and cached[0] == sf_key:
            return cached[1]
        if batch is None:
            return (float("nan"),) * 3
        sharded = isinstance(self.agg_state, ShardedResidentGraph)
        if sharded:
            ids = layer_ids(batch.adjs, batch.sampled_nodes,
                            batch.input_nodes)
            adjs = list(batch.adjs)
        else:
            adjs = prepare_adjs(batch, self.agg_state)
        widths = self._layer_widths()
        rng = np.random.default_rng(0)

        def operand(n, w):
            return torch.from_numpy(
                rng.normal(size=(n, w)).astype(np.float32)).to(self.device)

        def layer(l):
            if not sharded:
                return adjs[l]
            return materialize_layer(self.agg_state, batch.adjs[l], *ids[l])

        t_fwd = t_bwd = 0.0
        for l, adj in enumerate(adjs):
            if adj is None or isinstance(adj, PatternAdj):
                continue
            w = widths[l] if l < len(widths) else widths[-1]
            x, g = operand(adj.ncols, w), operand(adj.nrows, w)
            t_fwd += self._time_s(lambda: spmm(layer(l), x))
            t_bwd += self._time_s(lambda: spmm_transpose(layer(l), g))
        t_comm = 0.0
        if self.dist.world_size > 1:
            flat = torch.zeros(
                1 + sum(p.numel() for p in self.net.parameters()),
                device=self.device)
            t_comm = self._time_s(lambda: all_reduce_sum_([flat], self.dist))
            if not isinstance(self.feature_source, ReplicatedFeatures):
                t_comm += self._time_s(lambda: self.feature_source.gather(
                    batch.input_nodes, batch.input_mask, batch.feat_plan))
        self._op_buckets = (sf_key, (t_fwd, t_bwd, t_comm))
        return self._op_buckets[1]
