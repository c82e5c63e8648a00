"""Rank workers of `tests/test_torch_dist.py`, and the set-up both sides
of its comparisons share.

The ranks start with the ``spawn`` method, which imports this module
afresh in each of them, while the test process holds JAX; so this module
imports only numpy, torch and the port. Each worker joins a gloo group on
the CPU with one thread and writes what it computed to ``out_dir``.
"""
import json
import os

import numpy as np
import torch

from gnn_tpu_torch.parallel.dist import (all_reduce_sum_, broadcast_from_main,
                                         close_dist, init_dist,
                                         mean_across_ranks, sum_across_ranks)

WORLD = 2
# the training cases' configuration (tests/test_torch_train.py's)
GRAPH = dict(num_nodes=2000, avg_degree=12, num_feats=32, num_classes=7,
             seed=0)
SAMPLER = dict(batch_size=64, samp_num=128, orders=(1, 1))
HOT_K = 256
NHID = 32
POOL = 2
SEED = 3


def _join(rank, rdv):
    torch.set_num_threads(1)
    return init_dist(rank, rdv, "cpu", "gloo")


def collectives_case(rank, rdv, out_dir):
    """all_reduce_sum_ over tensors of two shapes, the sum, mean and
    rank-0 broadcast of floats."""
    ctx = _join(rank, rdv)
    try:
        a = torch.full((2, 3), float(rank + 1))
        b = torch.arange(4, dtype=torch.float32) * (rank + 1)
        all_reduce_sum_([a, b], ctx)
        rec = {"a": a.tolist(), "b": b.tolist(),
               "sum": sum_across_ranks([rank, 0.5], ctx),
               "mean": mean_across_ranks([rank, 2.0], ctx),
               "bcast": broadcast_from_main([10.0 + rank], ctx)}
        ctx.barrier()
    finally:
        close_dist(ctx)
    with open(os.path.join(out_dir, f"collectives{rank}.json"), "w") as f:
        json.dump(rec, f)


class _Inputs:
    """The two fields of a minibatch a feature source plans from."""

    def __init__(self, input_nodes, input_mask):
        self.input_nodes, self.input_mask = input_nodes, input_mask


def cache_case(rank, rdv, out_dir, feats, placement, batches):
    """``CachedFeatures`` at float32 and bfloat16: every batch of this
    rank (``batches[rank]``, (input_nodes, input_mask) pairs) through the
    exchange, and through the host path; the rows' sources counted."""
    from gnn_tpu_torch.parallel.feature_cache import CachedFeatures
    ctx = _join(rank, rdv)
    out = {}
    try:
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            src = CachedFeatures(feats, placement, ctx, dtype=dtype)
            for i, (nodes, mask) in enumerate(batches[rank]):
                plan = src.plan(_Inputs(nodes, mask))
                x = src.gather(torch.from_numpy(nodes),
                               torch.from_numpy(mask), plan)
                out[f"{name}_{i}"] = x.numpy()
                out[f"{name}_host_{i}"] = src.host_gather(nodes, mask).numpy()
            out[f"{name}_stats"] = np.array(
                [src.stats[k] for k in ("rows_local", "rows_peer",
                                        "rows_host")])
    finally:
        close_dist(ctx)
    np.savez(os.path.join(out_dir, f"cache{rank}.npz"), **out)


def build():
    """The port's side of the training cases: graph, Laplacian, resident
    hot block (float32, stream tiles on), sampler config and the greedy
    placement of 20% of the nodes over two ranks (alpha 0, the CLI's
    default, so the ranks' buffers differ). Returns a dict."""
    from gnn_tpu_torch.data.synthetic import make_powerlaw_graph
    from gnn_tpu_torch.ops.hotdense import HotSpec, build_hot_dense
    from gnn_tpu_torch.ops.residentgraph import build_resident_graph
    from gnn_tpu_torch.placement.engine import (compute_sample_prob,
                                                create_placement)
    from gnn_tpu_torch.sampling.ladies import SamplerConfig
    from gnn_tpu_torch.utils.normalize import build_laplacian

    g = make_powerlaw_graph(**GRAPH)
    lap = build_laplacian(g.adj_full, "graphsage")
    n = lap.shape[0]
    prob = compute_sample_prob(lap, g.train_nodes, 2)
    spec = HotSpec.from_sample_prob(prob, HOT_K)
    d, dt = build_hot_dense(lap, spec, torch.float32, "cpu")
    cfg = SamplerConfig(num_nodes=n, num_classes=g.num_classes,
                        adj_format="resident", hot_spec=spec,
                        resident_val_free=True, resident_stream_tiles=True,
                        **SAMPLER)
    placement = create_placement(lap, g.train_nodes, per_dev=n // 5,
                                 num_devs=WORLD, num_conv_layers=2,
                                 alpha=0.0)
    return dict(graph=g, lap=lap, cfg=cfg,
                rg=build_resident_graph(lap, spec, d, dt),
                placement=placement)


def make_trainer(b, init, rank, source="replicated", ctx=None,
                 device="cpu"):
    """Rank ``rank``'s Trainer on ``build``'s set-up with the weights
    ``init`` and dropout off; ``source`` is "replicated" or "cached"."""
    from gnn_tpu_torch.models.gnn import build_model
    from gnn_tpu_torch.parallel.feature_cache import (CachedFeatures,
                                                      ReplicatedFeatures)
    from gnn_tpu_torch.sampling.pipeline import BatchPipeline
    from gnn_tpu_torch.train.trainer import Trainer

    g = b["graph"]
    pipe = BatchPipeline(b["cfg"], b["lap"], g.labels, pool_num=POOL,
                         seed=SEED, world_size=WORLD, rank=rank)
    net = build_model("graphsage", NHID, SAMPLER["orders"], g.num_classes,
                      n_feats=g.feats.shape[1], dropout=0.0)
    net.load_state_dict(init)
    fs = (CachedFeatures(g.feats, b["placement"], ctx)
          if source == "cached"
          else ReplicatedFeatures(g.feats, device=device))
    return Trainer(net, pipe, g.feats, lr=0.01, sigmoid_loss=True,
                   seed=SEED, feature_source=fs, resident_graph=b["rg"],
                   device=device, dist=ctx)


def first_grads(tr, targets, rank_chunks):
    """This rank's gradient on its first batch of epoch 0, before any
    clip, and its global norm; the parameters stay as they were."""
    from gnn_tpu_torch.train.loss import masked_loss
    from gnn_tpu_torch.train.stepfns import prepare_adjs, to_device_batch

    mb = next(iter(tr.pipeline.train_epoch(targets, rank_chunks, epoch=0)))
    batch = to_device_batch(mb, "cpu")
    x = tr.feature_source.gather(batch.input_nodes, batch.input_mask)
    out = tr.net(x, prepare_adjs(batch, tr.agg_state), batch.sampled_nodes)
    tr.net.zero_grad(set_to_none=True)
    masked_loss(out, batch.labels, batch.label_mask, True).backward()
    grads = {k: p.grad.clone() for k, p in tr.net.named_parameters()}
    tr.net.zero_grad(set_to_none=True)
    norm = torch.sqrt(sum((g ** 2).sum() for g in grads.values()))
    return grads, float(norm)


def train_case(rank, rdv, out_dir, init, targets, clip_init, clip_chunks):
    """Three training cases in one group: "replicated" and "cached", one
    epoch on ``targets`` from ``init`` (step losses, final parameters);
    then "clip", from ``clip_init`` on ``clip_chunks``: this rank's raw
    gradient on its first batch and its norm, then that step (the Adam
    first moments after it)."""
    ctx = _join(rank, rdv)
    out = {}
    try:
        b = build()
        for case in ("replicated", "cached"):
            tr = make_trainer(b, init, rank, case, ctx)
            try:
                m = tr.train_epoch(targets, 0)
            finally:
                tr.pipeline.close()
            out[f"{case}_losses"] = np.asarray(m.step_losses)
            out[f"{case}_digest"] = np.asarray(tr.param_digest())
            for k, v in tr.net.state_dict().items():
                out[f"{case}_param_{k}"] = v.numpy()
        tr = make_trainer(b, clip_init, rank, "replicated", ctx)
        try:
            grads, norm = first_grads(tr, None, clip_chunks)
            m = tr.train_epoch(None, 0, clip_chunks)
        finally:
            tr.pipeline.close()
        out["clip_norm"] = np.asarray(norm)
        out["clip_losses"] = np.asarray(m.step_losses)
        for k, p in tr.net.named_parameters():
            out[f"clip_grad_{k}"] = grads[k].numpy()
            out[f"clip_mu_{k}"] = tr.optimizer.state[p]["exp_avg"].numpy()
    finally:
        close_dist(ctx)
    np.savez(os.path.join(out_dir, f"train{rank}.npz"), **out)


def cuda_case(rank, rdv, out_dir, init):
    """Two gloo ranks sharing ``cuda:0``: the cache's gather of this
    rank's first batch against the table's rows, then one epoch of
    training through the cache (its step losses, parameter digest)."""
    from gnn_tpu_torch.train.stepfns import to_device_batch
    torch.set_num_threads(1)
    ctx = init_dist(rank, rdv, "cuda", "gloo")
    out = {"device": str(ctx.device)}
    try:
        b = build()
        tr = make_trainer(b, init, rank, "cached", ctx, device=ctx.device)
        try:
            g = b["graph"]
            targets = g.train_nodes[:256]
            mb = next(iter(tr.pipeline.train_epoch(targets, epoch=0)))
            batch = to_device_batch(mb, ctx.device, tr.feature_source)
            x = tr.feature_source.gather(batch.input_nodes,
                                         batch.input_mask, batch.feat_plan)
            want = g.feats[mb.input_nodes] * mb.input_mask[:, None]
            out["gather_exact"] = bool(np.array_equal(x.cpu().numpy(),
                                                      want))
            m = tr.train_epoch(targets, 0)
            out["losses"] = m.step_losses
            out["digest"] = tr.param_digest()
        finally:
            tr.pipeline.close()
    finally:
        close_dist(ctx)
    with open(os.path.join(out_dir, f"cuda{rank}.json"), "w") as f:
        json.dump(out, f)


_BUNDLE_RG = ("row_ptr", "col_idx", "val", "slot_of_node", "row_val",
              "col_val", "dense", "dense_t")


def _publishable(b):
    """``build``'s set-up as GraphBundle items (arrays, CSRs, numbers)."""
    g, rg = b["graph"], b["rg"]
    items = dict(lap=b["lap"], feats=g.feats, labels=g.labels,
                 train_nodes=g.train_nodes, num_classes=g.num_classes,
                 hot_nodes=b["cfg"].hot_spec.hot_nodes)
    for k in _BUNDLE_RG:
        v = rg[k]
        items["rg_" + k] = v.numpy() if isinstance(v, torch.Tensor) else v
    items.update({k: rg[k] for k in ("n", "k", "col_trivial", "val_free")})
    return items


def _from_bundle(items):
    """``build``'s set-up rebuilt around the attached arrays (no copy)."""
    import types

    from gnn_tpu_torch.ops.hotdense import HotSpec
    from gnn_tpu_torch.sampling.ladies import SamplerConfig
    rg = {k: items["rg_" + k] for k in _BUNDLE_RG}
    for k in ("dense", "dense_t"):
        rg[k] = torch.from_numpy(rg[k])
    rg.update({k: items[k] for k in ("n", "k", "col_trivial", "val_free")})
    spec = HotSpec(hot_nodes=items["hot_nodes"],
                   slot_of_node=rg["slot_of_node"], k=items["k"])
    g = types.SimpleNamespace(feats=items["feats"], labels=items["labels"],
                              train_nodes=items["train_nodes"],
                              num_classes=items["num_classes"])
    cfg = SamplerConfig(num_nodes=items["n"], num_classes=g.num_classes,
                        adj_format="resident", hot_spec=spec,
                        resident_val_free=True, resident_stream_tiles=True,
                        **SAMPLER)
    return dict(graph=g, lap=items["lap"].tocsr(), cfg=cfg, rg=rg)


def _in_segments(a, segs) -> bool:
    """Whether ``a``'s bytes lie inside one of the shared segments."""
    lo = a.ctypes.data
    for seg in segs:
        base = np.frombuffer(seg.buf, np.uint8).ctypes.data
        if base <= lo and lo + a.nbytes <= base + seg.size:
            return True
    return False


def bundle_case(rank, rdv, out_dir, path, targets):
    """Rank 0 builds the set-up and publishes it as a GraphBundle at
    ``path``; rank 1 attaches it. Each then trains one epoch alone (a
    world of one, rank 0's batches) from the same weights and writes its
    step losses, and whether its feature table and Laplacian values lie
    in the attached shared-memory segments."""
    from gnn_tpu_torch.data.shared import GraphBundle
    from gnn_tpu_torch.models.gnn import build_model
    ctx = _join(rank, rdv)
    keep, bundle = [], None
    try:
        if rank == 0:
            b = build()
            bundle = GraphBundle.publish(_publishable(b), path)
            ctx.barrier()
        else:
            ctx.barrier()
            items, keep = GraphBundle.attach(path)
            b = _from_bundle(items)
        g = b["graph"]
        init = build_model("graphsage", NHID, SAMPLER["orders"],
                           g.num_classes, n_feats=g.feats.shape[1],
                           dropout=0.0).state_dict()
        tr = make_trainer(b, init, 0)
        try:
            m = tr.train_epoch(targets, 0)
        finally:
            tr.pipeline.close()
        shared = [_in_segments(a, keep) for a in (g.feats, b["lap"].data)]
        rec = {"losses": m.step_losses, "shared": shared}
        ctx.barrier()
    finally:
        for seg in keep:
            seg.close()
        if bundle is not None:
            bundle.close()
        close_dist(ctx)
    with open(os.path.join(out_dir, f"bundle{rank}.json"), "w") as f:
        json.dump(rec, f)
