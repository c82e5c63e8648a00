"""Command-line trainer: the counterpart of `gnn_tpu.cli`, with the same
flags and defaults plus ``--device`` (default ``cuda``; ``cpu`` runs the
plain PyTorch versions of the kernels).

Run e.g.::

    python -m gnn_tpu_torch.cli --dataset synthetic --epoch_num 1 --test

The default run is the resident hot-block path: GraphSAGE 512 wide,
orders 1,1,1, LADIES with samp_num 8192, batch 2048, sigmoid BCE, Adam
0.01, clip 5, the K=16384 bfloat16 hot block, and the cold residual
through the edge-stream CUDA kernel (``--resident_stream auto`` = on for
``cuda``). ``--model gat`` trains the same path with hot-block attention
and the edge-stream attention kernels for the cold residual (lr 0.002
with a linear warmup). ``--adj_format blocked`` ships dense tiles and
aggregates them with the stream-SpMM kernel (K2); ``--model gat
--adj_format pattern`` (or ``coo``) ships the edge pattern and runs the
per-edge route or, where the layer's tile mask is small enough, the tile
route (SDDMM K5 + K2). ``--adj_format hot`` keeps only the hot blocks on
the card and ships each layer's hot-slot plumbing and cold COO (with its
col-sorted transpose copy) from the host; ``--sampler subgraph`` samples
one node set per batch and shares one square adjacency across the deeper
layers, on any format. Flags whose paths are not ported yet raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="GNN training on a GPU (GraphSAGE/GCN/GIN/GAT + "
                    "LADIES)")
    # --- reference flags (main.py:24-65) ---
    p.add_argument("--dataset", type=str, default="synthetic",
                   help="dataset name, GraphSAINT dir, ogbn-*, or "
                        "synthetic:nodes=..,deg=..")
    p.add_argument("--model", type=str, default="graphsage",
                   choices=["graphsage", "gcn", "gat", "gin"])
    p.add_argument("--nhid", type=int, default=512)
    p.add_argument("--epoch_num", type=int, default=4)
    p.add_argument("--pool_num", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--orders", type=str, default="1,1,1")
    p.add_argument("--samp_num", type=int, default=8192)
    p.add_argument("--cuda", type=str, default="",
                   help="accepted for reference compatibility; ignored "
                        "(use --device)")
    p.add_argument("--sigmoid_loss", dest="sigmoid_loss",
                   action="store_true", default=True)
    p.add_argument("--no_sigmoid_loss", dest="sigmoid_loss",
                   action="store_false",
                   help="train with softmax cross-entropy instead of BCE")
    p.add_argument("--local_shuffle", action="store_true")
    p.add_argument("--buffer_size", type=float, default=0.2,
                   help="fraction of nodes buffered per device")
    p.add_argument("--scale_factor", type=float, default=1.0)
    p.add_argument("--lr", type=float, default=None,
                   help="learning rate (default 0.01; 0.002 for gat)")
    p.add_argument("--lr_warmup", type=int, default=-1,
                   help="linear lr warmup steps (lr/100 -> lr); -1 = "
                        "auto: 300 for gat, 0 otherwise")
    p.add_argument("--test", action="store_true")
    p.add_argument("--alpha", type=float, default=0)
    p.add_argument("--sampler", type=str, default="ladies",
                   choices=["ladies", "subgraph"])
    p.add_argument("--pagraph", action="store_true")
    p.add_argument("--naive", action="store_true")
    p.add_argument("--random", action="store_true")
    p.add_argument("--locality_sampling", action="store_true")
    # --- extensions of the JAX package's CLI ---
    p.add_argument("--n_devices", type=int, default=0,
                   help="devices to train on (0 = all; this slice "
                        "trains on one)")
    p.add_argument("--adj_format", type=str, default="resident",
                   choices=["coo", "blocked", "hot", "resident",
                            "pattern"],
                   help="'resident' = device-resident hot block + cold "
                        "residual (default); 'hot' = the same blocks with "
                        "each layer's plumbing and cold COO shipped from "
                        "the host; 'coo' = index_add_ aggregation; "
                        "'blocked' = dense-tile stream (K2); 'pattern' = "
                        "pattern-only edges for attention models (GAT "
                        "default off the resident path)")
    p.add_argument("--hot_k", type=int, default=16384,
                   help="hot-subgraph size (top-K nodes by sample_prob) "
                        "for --adj_format hot / resident")
    p.add_argument("--resident_parts", type=int, default=0,
                   help="shard the resident state over this many "
                        "devices (not ported yet)")
    p.add_argument("--norm", type=str, default="row",
                   choices=["row", "sym"],
                   help="graph normalization: 'row' = D^-1 A, 'sym' = "
                        "D^-1/2 A D^-1/2")
    p.add_argument("--resident_stream", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="cold residual as packed tiles through the "
                        "edge-stream kernel; 'auto' = on for cuda")
    p.add_argument("--hot_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="resident hot-block dtype")
    p.add_argument("--feat_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="device feature-table dtype")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="train steps per dispatch (only 1 is ported)")
    p.add_argument("--feature_cache", action="store_true",
                   help="placement-driven sharded feature cache (not "
                        "ported yet)")
    p.add_argument("--save_dir", type=str, default="save")
    p.add_argument("--resume", action="store_true",
                   help="resume from save_dir's latest checkpoint (not "
                        "ported yet)")
    p.add_argument("--data_dir", type=str,
                   default=os.environ.get("GNN_DATA_DIR", "data"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a profiler trace of epoch 1 here (not "
                        "ported yet)")
    p.add_argument("--op_timing", action="store_true", default=False,
                   help="per-epoch spmm/communication buckets (not "
                        "ported yet)")
    p.add_argument("--no_op_timing", dest="op_timing",
                   action="store_false")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def resolve_training_defaults(args, steps_per_epoch: int = 10**9) -> int:
    """Model-dependent lr / warmup defaults (mutates args.lr; returns the
    warmup step count): GAT defaults to lr 0.002 + warmup, the others to
    the reference's 0.01; an explicit --lr always wins."""
    if args.lr is None:
        args.lr = 0.002 if args.model == "gat" else 0.01
    if args.lr_warmup >= 0:
        return args.lr_warmup
    if args.model != "gat":
        return 0
    return max(1, min(300, steps_per_epoch))


def _check_ported(args) -> None:
    """Raise NotImplementedError for flags whose paths are not ported."""
    multi = "multi-device over torch.distributed"
    resume = "resume, the locality tuner, op timing and profiling"
    todo = [
        (args.feature_cache, "--feature_cache", multi),
        (args.resident_parts > 1, "--resident_parts", multi),
        (args.n_devices > 1, "--n_devices > 1", multi),
        (args.steps_per_dispatch > 1, "--steps_per_dispatch > 1",
         "decision: no scan dispatch in eager PyTorch"),
        (args.locality_sampling, "--locality_sampling", resume),
        (args.resume, "--resume", resume),
        (bool(args.profile_dir), "--profile_dir", resume),
        (args.op_timing, "--op_timing", resume),
    ]
    for hit, flag, item in todo:
        if hit:
            raise NotImplementedError(
                f"{flag} is not ported to gnn_tpu_torch yet (ROADMAP: "
                f"{item})")


def resolve_adj_format(args) -> None:
    """The JAX package's format rules: ``pattern`` is attention-only, and
    GAT turns ``hot`` (whose shipped values it never reads) into
    ``pattern``."""
    if args.adj_format == "pattern" and args.model != "gat":
        raise SystemExit("--adj_format pattern is attention-only (the "
                         "aggregation weights are computed on device); "
                         "use coo/hot/resident for graphsage/gcn/gin")
    if args.model == "gat" and args.adj_format == "hot":
        print("--model gat ships pattern-only edges; overriding "
              "--adj_format hot -> pattern", flush=True)
        args.adj_format = "pattern"


def train(args):
    """Set up and run the training the CLI describes; returns
    ``(trainer, graph)``."""
    import numpy as np
    import torch

    from gnn_tpu_torch.data.loaders import load_dataset
    from gnn_tpu_torch.device import resolve_device
    from gnn_tpu_torch.models.gnn import build_model
    from gnn_tpu_torch.parallel.feature_cache import ReplicatedFeatures
    from gnn_tpu_torch.placement.engine import create_placement
    from gnn_tpu_torch.sampling.ladies import SamplerConfig
    from gnn_tpu_torch.sampling.pipeline import BatchPipeline
    from gnn_tpu_torch.train.metrics import MetricsRegistry
    from gnn_tpu_torch.train.trainer import Trainer
    from gnn_tpu_torch.utils.normalize import build_laplacian

    resolve_adj_format(args)
    _check_ported(args)
    device = resolve_device(args.device)
    orders = tuple(int(t) for t in args.orders.split(","))
    graph = load_dataset(args.dataset, args.data_dir)
    n = graph.adj_full.shape[0]
    lap = build_laplacian(graph.adj_full, args.model, norm=args.norm)

    strategy = ("pagraph" if args.pagraph else
                "random" if args.random else
                "naive" if args.naive else "greedy")
    per_dev = int(args.buffer_size * n)
    print("buffer_size: ", per_dev, flush=True)
    placement = create_placement(
        lap, graph.train_nodes, per_dev=per_dev, num_devs=1,
        num_conv_layers=sum(orders), alpha=args.alpha, strategy=strategy,
        cache_dir=args.save_dir, dataset=args.dataset.replace("/", "_"))

    hot_spec = None
    hot_dense = None
    resident_graph = None
    if args.adj_format in ("hot", "resident"):
        from gnn_tpu_torch.ops.hotdense import (HotSpec,
                                                build_hot_dense_cached)
        from gnn_tpu_torch.placement.engine import compute_sample_prob
        os.makedirs(args.save_dir, exist_ok=True)
        dsname = args.dataset.replace("/", "_").replace(":", "_")
        depth = sum(orders)
        prob_path = os.path.join(args.save_dir,
                                 f"{dsname}.sampprob.L{depth}.npy")
        if os.path.exists(prob_path):
            prob = np.load(prob_path)
        else:
            prob = compute_sample_prob(lap, graph.train_nodes, depth)
            np.save(prob_path, prob)
        hot_spec = HotSpec.from_sample_prob(prob, args.hot_k)
        bf16 = args.hot_dtype == "bfloat16"
        dense, dense_t = build_hot_dense_cached(
            lap, hot_spec, dtype=torch.bfloat16 if bf16 else torch.float32,
            device=device,
            cache_path=os.path.join(
                args.save_dir, f"{dsname}.hotcoo.L{depth}"
                f".K{args.hot_k}.npz"))
        print(f"hot block: K={hot_spec.k} "
              f"({2 * dense.numel() * dense.element_size() / 2**20:.0f} "
              f"MiB resident incl. transpose)", flush=True)
        if args.adj_format == "resident":
            from gnn_tpu_torch.ops.residentgraph import build_resident_graph
            resident_graph = build_resident_graph(
                lap, hot_spec, dense, dense_t,
                val_dtype="bfloat16" if bf16 else np.float32)
        else:
            hot_dense = (dense, dense_t)

    val_free = bool(resident_graph and resident_graph["val_free"])
    stream_tiles = (args.adj_format == "resident" and (
        args.resident_stream == "on"
        or (args.resident_stream == "auto" and device.type == "cuda")))
    cfg = SamplerConfig(
        batch_size=args.batch_size, samp_num=args.samp_num, orders=orders,
        num_nodes=n, num_classes=graph.num_classes, sampler=args.sampler,
        scale_factor=args.scale_factor, adj_format=args.adj_format,
        hot_spec=hot_spec, resident_val_free=val_free,
        resident_stream_tiles=stream_tiles)
    pipe = BatchPipeline(cfg, lap, graph.labels, pool_num=args.pool_num,
                         local_shuffle=args.local_shuffle, seed=args.seed)
    net = build_model(args.model, args.nhid, orders, graph.num_classes,
                      n_feats=graph.feats.shape[1], seed=args.seed)
    source = ReplicatedFeatures(
        graph.feats, device=device,
        dtype=torch.bfloat16 if args.feat_dtype == "bfloat16"
        else torch.float32)
    lr_warmup = resolve_training_defaults(
        args, steps_per_epoch=max(1, len(graph.train_nodes)
                                  // args.batch_size))
    trainer = Trainer(net, pipe, graph.feats, lr=args.lr,
                      sigmoid_loss=args.sigmoid_loss, seed=args.seed,
                      feature_source=source, resident_graph=resident_graph,
                      hot_dense=hot_dense, lr_warmup=lr_warmup,
                      device=device)
    rank_chunks = None
    if args.local_shuffle and args.pagraph:
        rank_chunks = placement.train_nodes_per_dev
    metrics = MetricsRegistry(os.path.join(args.save_dir, "metrics.jsonl"))
    try:
        trainer.fit(graph.train_nodes, graph.valid_nodes, args.epoch_num,
                    rank_chunks=rank_chunks, checkpoint_dir=args.save_dir,
                    metrics=metrics)
        if args.test:
            f1 = trainer.test(graph.test_nodes, batch_size=128)
            metrics.log(test_f1=f1)
            print("Test f1 score: %.3f" % f1, flush=True)
    finally:
        pipe.close()
    return trainer, graph


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(args, flush=True)
    train(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
