"""Rank workers of `tests/test_torch_halo.py` and
`tests/test_torch_fullgraph.py`: gloo ranks on the CPU, each writing what
it computed to ``out_dir``.

The ranks start with the ``spawn`` method, which imports this module
afresh in each of them, while the test process holds JAX; so this module
imports only numpy, torch and the port.
"""
import dataclasses
import os

import numpy as np
import torch

from gnn_tpu_torch.parallel.dist import close_dist, init_dist


def _join(rank, rdv, parts=1, device_type="cpu"):
    torch.set_num_threads(1)
    return init_dist(rank, rdv, device_type, "gloo", parts)


def flat(ctx):
    """A grid context's world as one flat group of ranks."""
    return dataclasses.replace(ctx, parts=1, data_group=None,
                               part_group=None)


def spmm_case(rank, rdv, out_dir, adj, feats, cot, device_type="cpu"):
    """``distributed_spmm`` of this rank's partition of ``feats``, and
    the gradient of ``sum(y * cot)`` with respect to the partition (the
    exchange's backward), on the CPU or on the card."""
    from gnn_tpu_torch.parallel.halo import (LocalHaloPlan, build_halo_plan,
                                             distributed_spmm,
                                             partition_features)
    ctx = _join(rank, rdv, device_type=device_type)
    try:
        plan, owner = build_halo_plan(adj, ctx.world_size)
        D, nl, dev = ctx.world_size, plan.n_local, ctx.device
        x = torch.from_numpy(partition_features(feats, owner, D, nl)[rank])
        x = x.to(dev).requires_grad_(True)
        c = torch.from_numpy(
            partition_features(cot, owner, D, nl)[rank]).to(dev)
        y = distributed_spmm(LocalHaloPlan.from_plan(plan, rank, dev), x,
                             ctx)
        (y * c).sum().backward()
        y, g = y.detach().cpu().numpy(), x.grad.cpu().numpy()
    finally:
        close_dist(ctx)
    np.savez(os.path.join(out_dir, f"spmm{rank}.npz"), y=y, grad=g)


def _trainer(kw, init, ctx):
    from gnn_tpu_torch.train.fullgraph import FullGraphTrainer
    tr = FullGraphTrainer(dist=ctx, device="cpu", **kw)
    tr.net.load_state_dict(init)
    return tr


def _params(out, key, tr):
    for k, p in tr.net.named_parameters():
        out[f"{key}_param_{k}"] = p.detach().numpy()
        out[f"{key}_mu_{k}"] = tr.optimizer.state[p]["exp_avg"].numpy()


def fullgraph_case(rank, rdv, out_dir, parts, kw, init, steps, clip_init):
    """From ``init``: ``steps`` training steps (losses, then the
    predictions and the parameters), on the flat world and, where
    ``parts`` > 1, on the ``data x part`` grid of the same ranks. Then
    from ``clip_init`` (None to skip): this rank's gradient of its
    partial loss, and one step (Adam's first moments)."""
    ctx = _join(rank, rdv, parts)
    out = {}
    try:
        views = {"flat": flat(ctx)}
        if parts > 1:
            views["grid"] = ctx
        for key, view in views.items():
            tr = _trainer(kw, init, view)
            out[f"{key}_losses"] = np.asarray(tr.train_steps(steps))
            out[f"{key}_pred"] = tr.predict()
            _params(out, key, tr)
        if clip_init is not None:
            tr = _trainer(kw, clip_init, flat(ctx))
            tr.local_loss().backward()
            for k, p in tr.net.named_parameters():
                out[f"clip_grad_{k}"] = p.grad.numpy().copy()
            out["clip_losses"] = np.asarray(tr.train_steps(1))
            _params(out, "clip", tr)
    finally:
        close_dist(ctx)
    np.savez(os.path.join(out_dir, f"fullgraph{rank}.npz"), **out)
