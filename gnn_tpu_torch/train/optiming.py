"""Op-bucket timing probes (``--op_timing``): per-step spmm forward /
backward and communication seconds from isolated ops on the epoch's
last batch, the reference's ``main.py:196`` buckets. The one-device
half of `gnn_tpu.train.optiming`; its part-sharded probe waits for the
multi-device slice."""
from __future__ import annotations

import time

import numpy as np
import torch

from gnn_tpu_torch.train.stepfns import prepare_adjs
from gnn_tpu_torch.utils.timing import cuda_time_ms


class OpTimingMixin:
    """`measure_op_buckets` and its helpers (a mixin over `Trainer`,
    which sets ``n_feats`` and ``agg_state``)."""

    def _layer_widths(self):
        """Per-layer input feature widths of the encoder stack (the
        widths of the spmm operands)."""
        from gnn_tpu_torch.models.gnn import GraphSage
        enc = self.net.encoder
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
        spmm and are skipped. Communication is 0.0: one device runs no
        collective. The result is cached keyed on the current
        ``scale_factor``: the sampled-set sizes, and so the buckets, move
        with it."""
        from gnn_tpu_torch.ops.sparse import PatternAdj, spmm, spmm_transpose

        sf_key = float(self.pipeline.cfg.scale_factor)
        cached = getattr(self, "_op_buckets", None)
        if cached is not None and cached[0] == sf_key:
            return cached[1]
        if batch is None:
            return (float("nan"),) * 3
        adjs = prepare_adjs(batch, self.agg_state)
        widths = self._layer_widths()
        rng = np.random.default_rng(0)

        def operand(n, w):
            return torch.from_numpy(
                rng.normal(size=(n, w)).astype(np.float32)).to(self.device)

        t_fwd = t_bwd = 0.0
        for l, adj in enumerate(adjs):
            if adj is None or isinstance(adj, PatternAdj):
                continue
            w = widths[l] if l < len(widths) else widths[-1]
            x, g = operand(adj.ncols, w), operand(adj.nrows, w)
            t_fwd += self._time_s(lambda: spmm(adj, x))
            t_bwd += self._time_s(lambda: spmm_transpose(adj, g))
        self._op_buckets = (sf_key, (t_fwd, t_bwd, 0.0))
        return self._op_buckets[1]
