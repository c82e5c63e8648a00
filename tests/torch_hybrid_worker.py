"""Rank workers of `tests/test_torch_hybrid.py`: gloo ranks on the CPU in
the hybrid DP x cache mode (``hybrid_view`` of a ``2 x P`` grid: every
rank a data rank, the feature cache sharded over the P ranks of a part
group), each writing what it computed to ``out_dir``.

The ranks start with the ``spawn`` method, which imports this module
afresh in each of them, while the test process holds JAX; so this module
imports only numpy, torch, the port and `torch_dist_worker` (the
training cases' set-up).
"""
import os

import numpy as np
import torch

import torch_dist_worker as dw
from gnn_tpu_torch.parallel.dist import close_dist, hybrid_view, init_dist


def _trainer(b, init, ctx, source):
    """This rank's Trainer on ``b`` (`dw.build`'s set-up with the
    hybrid placement) from ``init``, dropout off, the features from the
    hybrid cache ("cached") or the replicated table."""
    from gnn_tpu_torch.models.gnn import build_model
    from gnn_tpu_torch.parallel.feature_cache import (CachedFeatures,
                                                      ReplicatedFeatures)
    from gnn_tpu_torch.sampling.pipeline import BatchPipeline
    from gnn_tpu_torch.train.trainer import Trainer

    g = b["graph"]
    pipe = BatchPipeline(b["cfg"], b["lap"], g.labels, pool_num=dw.POOL,
                         seed=dw.SEED, world_size=ctx.world_size,
                         rank=ctx.rank)
    net = build_model("graphsage", dw.NHID, dw.SAMPLER["orders"],
                      g.num_classes, n_feats=g.feats.shape[1], dropout=0.0)
    net.load_state_dict(init)
    fs = (CachedFeatures(g.feats, b["placement"], ctx, part=ctx.cache_part)
          if source == "cached" else ReplicatedFeatures(g.feats))
    return Trainer(net, pipe, g.feats, lr=0.01, sigmoid_loss=True,
                   seed=dw.SEED, feature_source=fs, resident_graph=b["rg"],
                   device="cpu", dist=ctx)


def hybrid_case(rank, rdv, out_dir, cache_parts, placement, init, targets,
                sources):
    """The hybrid cache's gather of this rank's first batch (and the
    batch's input nodes and mask), then one epoch on ``targets`` from
    ``init`` for each feature source of ``sources``: step losses,
    parameters and the digest."""
    from gnn_tpu_torch.train.stepfns import to_device_batch
    torch.set_num_threads(1)
    grid = init_dist(rank, rdv, "cpu", "gloo", cache_parts)
    ctx = hybrid_view(grid)
    out = {}
    try:
        b = dict(dw.build(), placement=placement)
        for source in sources:
            tr = _trainer(b, init, ctx, source)
            try:
                if source == "cached":
                    mb = next(iter(tr.pipeline.train_epoch(targets,
                                                           epoch=0)))
                    batch = to_device_batch(mb, "cpu", tr.feature_source)
                    out["gather"] = tr.feature_source.gather(
                        batch.input_nodes, batch.input_mask,
                        batch.feat_plan).numpy()
                    out["input_nodes"] = mb.input_nodes
                    out["input_mask"] = mb.input_mask
                    out["stats"] = np.array([tr.feature_source.stats[k]
                                             for k in ("rows_local",
                                                       "rows_peer",
                                                       "rows_host")])
                m = tr.train_epoch(targets, 0)
            finally:
                tr.pipeline.close()
            out[f"{source}_losses"] = np.asarray(m.step_losses)
            out[f"{source}_digest"] = np.asarray(tr.param_digest())
            for k, v in tr.net.state_dict().items():
                out[f"{source}_param_{k}"] = v.numpy()
    finally:
        close_dist(grid)
    np.savez(os.path.join(out_dir, f"hybrid{rank}.npz"), **out)
