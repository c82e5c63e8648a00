"""Entry points: a forward on a tiny set-up, and one training epoch of
every sharded path on ``n`` ranks. The counterpart of the JAX package's
``__graft_entry__.py``.

``entry(device)`` returns ``(fn, example_args)``: the GraphSAGE forward
in eval mode on one tiny LADIES batch, ``fn(params, x, adjs, sampled)``
with ``params`` a ``state_dict`` (so weights carried over from the flax
model by `gnn_tpu_torch.weights.params_from_flax` drop in).

``dryrun_multichip(n, device_type)`` spawns ``n`` gloo ranks once (all on
``cuda:0`` for ``cuda``, or on the CPU) and runs every case of the JAX
dry run inside that one spawn, one epoch a case (one step a rank), each
rank counting its kernel launches a case and writing its results to the
run directory; the parent checks every loss finite and prints one line
a case. The cases: data parallelism with the placement-driven cache and
the hot format; the resident graph; the resident graph with stream
tiles (K1); GAT's hot-block attention, without and with stream tiles
(K3, K4); on ``2 x n/2`` ranks when ``n >= 4`` and even, the
part-sharded resident graph (each rank's resident bytes at most 1.06 /
P of the whole state), its full expansion, the composed cache and the
hybrid DP x cache mode; and the halo full-graph trainer, partitioned
over the ``2 x n/2`` grid when there is one, else over the ``n`` ranks.
The JAX dry run's multi-step scan case (``steps_per_dispatch`` 2 on
every rank) is not ported: grouped dispatch is ported for one rank
(`gnn_tpu_torch.train.dispatch`, a CUDA graph replay of G steps), and
its multi-rank case waits for NCCL ranks, since a graph cannot capture
gloo's host-staged collectives. The dry run says so.

    python -m gnn_tpu_torch.entry                 # on the card, 4 ranks
    python -m gnn_tpu_torch.entry --device cpu    # on the CPU
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from gnn_tpu_torch.ops.cuda_build import launch_counts

# the tiny set-up's GraphSAGE width (the JAX entry's)
NHID = 64
# a rank's resident bytes on the part-sharded grid, as a share of the
# whole state over P (the node ranges' padding)
RESIDENT_SLACK = 1.06
SCAN_NOTE = ("multi-step scan (steps_per_dispatch > 1) on several ranks "
             "not ported: grouped dispatch runs one rank (a CUDA graph "
             "replay of G steps); its multi-rank case waits for NCCL ranks "
             "(gloo's host-staged collectives cannot be captured)")


def _tiny_setup(batch_size=32, samp_num=64, n_nodes=512, n_feats=32,
                n_classes=7, orders=(1, 1)):
    """The tiny graph (512 nodes, degree 8), its GraphSAGE Laplacian and
    the sampler configuration."""
    from gnn_tpu_torch.data.synthetic import make_powerlaw_graph
    from gnn_tpu_torch.sampling.ladies import SamplerConfig
    from gnn_tpu_torch.utils.normalize import build_laplacian

    graph = make_powerlaw_graph(n_nodes, 8, n_feats, n_classes, seed=0)
    lap = build_laplacian(graph.adj_full, "graphsage")
    cfg = SamplerConfig(batch_size=batch_size, samp_num=samp_num,
                        orders=orders, num_nodes=n_nodes,
                        num_classes=n_classes)
    return graph, lap, cfg


def _net(model, nhid, graph, orders=(1, 1)):
    from gnn_tpu_torch.models.gnn import build_model
    return build_model(model, nhid, orders, graph.num_classes,
                       n_feats=graph.feats.shape[1])


def entry(device="cuda"):
    """``(fn, example_args)``: the GraphSAGE forward in eval mode on one
    tiny batch, on ``device`` (``cuda`` unless the caller passes
    ``cpu``); ``fn(*example_args)`` gives the ``[batch, classes]``
    logits."""
    from gnn_tpu_torch.device import resolve_device
    from gnn_tpu_torch.sampling.ladies import ladies_sample
    from gnn_tpu_torch.train.stepfns import prepare_adjs, to_device_batch

    dev = resolve_device(device)
    graph, lap, cfg = _tiny_setup()
    mb = ladies_sample(cfg, 0, graph.train_nodes[: cfg.batch_size], lap,
                       graph.labels)
    batch = to_device_batch(mb, dev)
    feats = torch.from_numpy(graph.feats).to(dev)
    x = feats.index_select(0, batch.input_nodes.long())
    net = _net("graphsage", NHID, graph).to(dev).eval()
    params = dict(net.state_dict())

    def fn(params, x, adjs, sampled):
        return torch.func.functional_call(net, params, (x, adjs, sampled))

    return fn, (params, x, prepare_adjs(batch, None), batch.sampled_nodes)


def _delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


class _Cases:
    """One rank's cases: each a trainer trained one epoch, its loss,
    kernel launches and what else the case records."""

    def __init__(self):
        self.out = {}

    def run(self, name, trainer, targets, **extra):
        before = launch_counts()
        try:
            m = trainer.train_epoch(targets, 0)
        finally:
            trainer.pipeline.close()
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        self.out[name] = dict(loss=m.train_loss, steps=len(m.step_losses),
                              launches=_delta(before, launch_counts()),
                              **extra)
        return trainer


def _dryrun_rank(rank, rdv, run_dir, device_type):
    """One rank of :func:`dryrun_multichip`: every case in order, then
    ``dryrun{rank}.json`` in ``run_dir``."""
    from gnn_tpu_torch.ops.hotdense import HotSpec, build_hot_dense
    from gnn_tpu_torch.ops.residentgraph import (ResidentGraph,
                                                 build_resident_graph)
    from gnn_tpu_torch.parallel import dist as tdist
    from gnn_tpu_torch.parallel.feature_cache import (CachedFeatures,
                                                      PartCachedFeatures)
    from gnn_tpu_torch.placement.engine import (compute_sample_prob,
                                                greedy_placement)
    from gnn_tpu_torch.sampling.pipeline import BatchPipeline
    from gnn_tpu_torch.train.fullgraph import FullGraphTrainer
    from gnn_tpu_torch.train.trainer import Trainer

    n_dev = rdv.world_size
    if device_type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // n_dev))
    grid = n_dev >= 4 and n_dev % 2 == 0
    part = n_dev // 2 if grid else 1
    ctx = tdist.init_dist(rank, rdv, device_type, "gloo", part)
    flat = dataclasses.replace(ctx, parts=1, data_group=None,
                               part_group=None)
    dev = ctx.device
    cases = _Cases()
    try:
        graph, lap, cfg = _tiny_setup()
        n = graph.adj_full.shape[0]
        bs = cfg.batch_size
        prob = compute_sample_prob(lap, graph.train_nodes, sum(cfg.orders))
        spec = HotSpec.from_sample_prob(prob, 128)
        hot_dense = build_hot_dense(lap, spec)
        rg = build_resident_graph(lap, spec, *hot_dense)
        cfg = dataclasses.replace(cfg, adj_format="hot", hot_spec=spec)
        cfg_r = dataclasses.replace(cfg, adj_format="resident")

        def trainer(model, c, ctx_, world, r, nhid=NHID, **kw):
            pipe = BatchPipeline(c, lap, graph.labels, pool_num=2,
                                 world_size=world, rank=r)
            return Trainer(_net(model, nhid, graph), pipe, graph.feats,
                           lr=0.01, sigmoid_loss=False, dist=ctx_,
                           device=dev, **kw)

        def dp(name, model, c, nhid=NHID, **kw):
            cases.run(name, trainer(model, c, flat, n_dev, rank, nhid, **kw),
                      graph.train_nodes[: bs * n_dev])

        # data parallelism + the placement-driven cache + the hot blocks
        placement = greedy_placement(prob, per_dev=max(n // (2 * n_dev), 8),
                                     num_devs=n_dev, alpha=1.0)
        cache = CachedFeatures(graph.feats, placement, flat)
        dp("dp_cache_hot", "graphsage", cfg, feature_source=cache,
           hot_dense=hot_dense)
        # the resident graph: the adjacency rebuilt on the device from
        # shipped node ids
        dp("resident", "graphsage", cfg_r, feature_source=cache,
           resident_graph=rg)
        # the resident graph's cold residual as packed edge tiles (K1)
        cfg_es = dataclasses.replace(cfg_r, resident_val_free=True,
                                     resident_stream_tiles=True)
        dp("resident_stream", "graphsage", cfg_es, feature_source=cache,
           resident_graph=rg)
        # GAT's hot-block attention, and with stream tiles (K3, K4)
        cfg_gat = dataclasses.replace(cfg_r, resident_val_free=True)
        dp("gat_hot_block", "gat", cfg_gat, nhid=32, resident_graph=rg)
        dp("gat_stream", "gat", dataclasses.replace(
            cfg_gat, resident_stream_tiles=True), nhid=32, resident_graph=rg)

        if grid:
            targets = graph.train_nodes[: bs * 2]

            def on_grid(name, c, **kw):
                return cases.run(name, trainer(
                    "graphsage", c, ctx, 2, ctx.data_rank,
                    resident_graph=rg, resident_parts=part, **kw), targets)

            # the part-sharded resident graph; a rank's resident bytes
            # against the whole (replicated) state's
            whole = ResidentGraph.from_host(rg, "cpu").state_bytes()
            tr = on_grid("sharded_resident", cfg_r)
            mine = tr.agg_state.state_bytes()
            cases.out["sharded_resident"].update(
                resident_bytes=sum(mine.values()),
                full_bytes=sum(v for k, v in whole.items() if k != "csr"),
                parts=part)
            # full expansion: each part expands its row-range CSR shard
            on_grid("full_expansion", dataclasses.replace(
                cfg_r, resident_ship_cold=False))
            # the composed cache: a placement over the P parts
            placement_p = greedy_placement(
                prob, per_dev=max(n // (2 * part), 8), num_devs=part,
                alpha=1.0)
            on_grid("composed", cfg_r, feature_source=PartCachedFeatures(
                graph.feats, placement_p, ctx.part, device=dev))
            # hybrid DP x cache: every rank a data rank, the cache's P
            # buffers sharded over the part groups
            hybrid = tdist.hybrid_view(ctx)
            cases.run("hybrid_cache", trainer(
                "graphsage", cfg, hybrid, n_dev, rank,
                feature_source=CachedFeatures(graph.feats, placement_p,
                                              hybrid,
                                              part=hybrid.cache_part),
                hot_dense=hot_dense), graph.train_nodes[: bs * n_dev])

        # the halo full-graph trainer, one step, over the grid's whole
        # world (or the n ranks)
        labels = np.asarray(graph.labels.todense(), np.float32)
        mask = np.zeros(n, bool)
        mask[graph.train_nodes] = True
        before = launch_counts()
        fg = FullGraphTrainer(adj=lap, feats=graph.feats, labels_dense=labels,
                              train_mask=mask, orders=(1, 1), nhid=16,
                              num_classes=graph.num_classes, lr=0.01,
                              dist=ctx)
        loss = fg.train_steps(1)[0]
        cases.out["halo"] = dict(loss=loss, steps=1,
                                 launches=_delta(before, launch_counts()),
                                 grid=f"2x{part}" if grid else None)
    finally:
        tdist.close_dist(ctx)
    with open(os.path.join(run_dir, f"dryrun{rank}.json"), "w") as f:
        json.dump({"rank": rank, "device": str(dev), "cases": cases.out}, f)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def dryrun_multichip(n_devices: int, device_type: str = "cuda",
                     run_dir=None) -> dict:
    """Spawn ``n_devices`` gloo ranks once and run every case (module
    docstring); raises unless every rank's loss of every case is finite
    and, on the grid, every rank's resident bytes are at most
    ``RESIDENT_SLACK / P`` of the whole state. Prints one line a case
    and returns ``{case: {"losses": [...], "launches": {...}, ...}}``,
    the launches summed over the ranks. ``run_dir`` keeps the ranks'
    records (default: a temporary directory, removed after)."""
    from gnn_tpu_torch.device import resolve_device
    from gnn_tpu_torch.parallel import dist as tdist

    if device_type == "cuda":
        resolve_device("cuda")
        # built once here, so the ranks do not race to build
        from gnn_tpu_torch.ops import cuda_build
        cuda_build.build_all()
    elif device_type != "cpu":
        raise ValueError(f"unsupported device type {device_type!r}")
    own = run_dir is None
    if own:
        run_dir = tempfile.mkdtemp(prefix="gnn_tpu_torch_dryrun_")
    try:
        tdist.spawn_ranks(n_devices, _dryrun_rank, (run_dir, device_type),
                          rendezvous_dir=run_dir)
        recs = []
        for r in range(n_devices):
            with open(os.path.join(run_dir, f"dryrun{r}.json")) as f:
                recs.append(json.load(f))
    finally:
        if own:
            shutil.rmtree(run_dir, ignore_errors=True)
    tag = f"dryrun_multichip({n_devices})"
    print(f"{tag} {SCAN_NOTE}", flush=True)
    out = {}
    for name, first in recs[0]["cases"].items():
        per = [rec["cases"][name] for rec in recs]
        losses = [c["loss"] for c in per]
        _check(all(math.isfinite(v) for v in losses),
               f"{name}: losses {losses}")
        launches = {}
        for c in per:
            for k, v in c["launches"].items():
                launches[k] = launches.get(k, 0) + v
        res = dict(losses=losses, launches=launches, steps=first["steps"])
        line = f"{tag} {name} OK: loss={losses[0]:.4f}"
        if "resident_bytes" in first:
            full, p = first["full_bytes"], first["parts"]
            worst = max(c["resident_bytes"] for c in per)
            _check(all(c["resident_bytes"] <= full / p * RESIDENT_SLACK
                       for c in per),
                   f"{name}: a rank's resident bytes "
                   f"{[c['resident_bytes'] for c in per]} exceed "
                   f"{RESIDENT_SLACK} x {full} / {p}")
            res.update(resident_bytes=[c["resident_bytes"] for c in per],
                       full_bytes=full, parts=p)
            line += (f" (per-rank resident bytes {worst} = "
                     f"{worst * p / max(full, 1):.2f}/P of the full state)")
        if name == "halo":
            res["grid"] = first["grid"]
            line += f" ({first['grid'] or f'{n_devices} ranks'})"
        if launches:
            line += f" launches {launches}"
        print(line, flush=True)
        out[name] = res
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--n_devices", type=int, default=4)
    args = p.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    print(f"entry forward: {tuple(out.shape)}", flush=True)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
