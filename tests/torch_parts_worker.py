"""Rank workers of `tests/test_torch_parts_train.py`: gloo ranks of a
``data x part`` grid on the CPU (or sharing a card), each writing what it
computed to ``out_dir``.

The ranks start with the ``spawn`` method, which imports this module
afresh in each of them, while the test process holds JAX; so this module
imports only numpy, torch, the port and `torch_dist_worker` (the set-up
the data-parallel tests share: graph, Laplacian, float32 resident hot
block with stream tiles, sampler configuration, greedy placement of 20%
of the nodes over two buffers).
"""
import json
import os

import numpy as np
import torch

import torch_dist_worker as dw
from gnn_tpu_torch.parallel.dist import close_dist, init_dist

# the resume case's targets: two steps of 64 an epoch
RESUME_TARGETS = 128


def _join(rank, rdv, parts, device_type="cpu"):
    torch.set_num_threads(1)
    return init_dist(rank, rdv, device_type, "gloo", parts)


def make_trainer(b, init, ctx, source="sharded", model="graphsage",
                 device="cpu"):
    """This rank's Trainer on ``dw.build``'s set-up with weights ``init``
    and dropout off: the resident graph sharded over the part group,
    the features as ``source`` ("sharded": node ranges, "cached": the
    placement's buffers, one a part)."""
    from gnn_tpu_torch.models.gnn import build_model
    from gnn_tpu_torch.parallel.feature_cache import (PartCachedFeatures,
                                                      PartShardedFeatures)
    from gnn_tpu_torch.sampling.pipeline import BatchPipeline
    from gnn_tpu_torch.train.trainer import Trainer

    g = b["graph"]
    pipe = BatchPipeline(b["cfg"], b["lap"], g.labels, pool_num=dw.POOL,
                         seed=dw.SEED, world_size=ctx.dp,
                         rank=ctx.data_rank)
    net = build_model(model, dw.NHID, dw.SAMPLER["orders"], g.num_classes,
                      n_feats=g.feats.shape[1], dropout=0.0)
    net.load_state_dict(init)
    fs = (PartCachedFeatures(g.feats, b["placement"], ctx.part,
                             device=device)
          if source == "cached"
          else PartShardedFeatures(g.feats, ctx.part, device=device))
    return Trainer(net, pipe, g.feats, lr=0.01, sigmoid_loss=True,
                   seed=dw.SEED, feature_source=fs, resident_graph=b["rg"],
                   device=device, dist=ctx, resident_parts=ctx.parts)


def _train(out, key, tr, targets):
    try:
        m = tr.train_epoch(targets, 0)
    finally:
        tr.pipeline.close()
    out[f"{key}_losses"] = np.asarray(m.step_losses)
    out[f"{key}_digest"] = np.asarray(tr.param_digest())
    out[f"{key}_part_bytes"] = np.asarray(m.part_bytes)
    for k, p in tr.net.named_parameters():
        out[f"{key}_param_{k}"] = p.detach().numpy()
        out[f"{key}_mu_{k}"] = tr.optimizer.state[p]["exp_avg"].numpy()


def grid_case(rank, rdv, out_dir, parts, init, targets, sources):
    """One epoch on ``targets`` from ``init`` for each feature source of
    ``sources``: step losses, parameters, Adam's first moments, the
    digest and the bytes summed over the part group."""
    ctx = _join(rank, rdv, parts)
    out = {}
    try:
        b = dw.build()
        for source in sources:
            _train(out, source, make_trainer(b, init, ctx, source), targets)
    finally:
        close_dist(ctx)
    np.savez(os.path.join(out_dir, f"grid{rank}.npz"), **out)


def _gat_case(ctx, case):
    """GATConv on layer 0 of ``case``'s batch, rebuilt on this part's
    shard: the output and the gradients of ``sum(out[:n_rows] ** 2)``."""
    from gnn_tpu_torch.models.gat import GATConv
    from gnn_tpu_torch.ops.residentgraph import materialize_adjs
    from gnn_tpu_torch.ops.sparse import to_device
    from gnn_tpu_torch.parallel.shardedresident import shard_resident_state
    g = shard_resident_state(case["rg"], ctx.part, "cpu",
                             ship_csr=case["full"])
    mb = case["mb"]
    adj = materialize_adjs(g, [to_device(a, "cpu") for a in mb.adjs],
                           [torch.from_numpy(s) for s in mb.sampled_nodes],
                           torch.from_numpy(mb.input_nodes))[0]
    assert adj.part_axis is not None and adj.cold_partial == case["full"]
    conv = GATConv(case["x"].shape[1], case["n_out"], n_heads=case["heads"])
    conv.load_state_dict(case["weights"])
    out = conv(torch.from_numpy(case["x"]), adj,
               torch.from_numpy(mb.sampled_nodes[0]))
    (out[: adj.n_valid_rows] ** 2).sum().backward()
    return out.detach().numpy(), {n: p.grad.numpy()
                                  for n, p in conv.named_parameters()}


def part_case(rank, rdv, out_dir, init, targets, gat_cases):
    """The single data rank of a two-part grid: this rank's gradient on
    its first batch (before the clip); GAT's part-sharded attention on
    each of ``gat_cases``; a resume (three epochs, against one and then
    a resume to three); the op-timing buckets after an epoch."""
    from gnn_tpu_torch.parallel.dist import part_bytes
    ctx = _join(rank, rdv, 2)
    out = {}
    try:
        b = dw.build()
        tr = make_trainer(b, init, ctx)
        try:
            grads, _ = dw.first_grads(tr, targets, None)
        finally:
            tr.pipeline.close()
        for k, v in grads.items():
            out[f"grad_{k}"] = v.numpy()
        for name, case in gat_cases.items():
            before = sum(part_bytes.values())
            y, g = _gat_case(ctx, case)
            out[f"gat_{name}_out"] = y
            out[f"gat_{name}_bytes"] = np.asarray(
                sum(part_bytes.values()) - before)
            for k, v in g.items():
                out[f"gat_{name}_grad_{k}"] = v
        res = targets[:RESUME_TARGETS]
        ck = os.path.join(out_dir, "ckpt")
        hists = []
        for epochs, resume in ((3, False), (1, False), (3, True)):
            tr = make_trainer(b, init, ctx)
            try:
                hists.append(tr.fit(res, b["graph"].valid_nodes, epochs,
                                    log=False, resume=resume,
                                    checkpoint_dir=None if epochs == 3
                                    and not resume else ck))
            finally:
                tr.pipeline.close()
        full, _, resumed = hists
        out["resume_epochs"] = np.asarray([m.epoch for m in resumed])
        out["resume_losses"] = np.asarray([m.step_losses for m in resumed])
        out["full_losses"] = np.asarray([m.step_losses for m in full[1:]])
        tr = make_trainer(b, init, ctx)
        try:
            tr.train_epoch(res, 0, keep_last_batch=True)
            out["op_buckets"] = np.asarray(
                tr.measure_op_buckets(tr.last_batch))
        finally:
            tr.pipeline.close()
    finally:
        close_dist(ctx)
    np.savez(os.path.join(out_dir, f"part{rank}.npz"), **out)


def cuda_case(rank, rdv, out_dir, init):
    """Two gloo part ranks sharing ``cuda:0`` (composed mode): the gather
    of the first batch against the table's rows, then one epoch (its step
    losses and digest)."""
    from gnn_tpu_torch.train.stepfns import to_device_batch
    ctx = _join(rank, rdv, 2, "cuda")
    out = {"device": str(ctx.device)}
    try:
        b = dw.build()
        tr = make_trainer(b, init, ctx, "cached", device=ctx.device)
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
