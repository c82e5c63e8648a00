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
layers, on any format. ``--locality_sampling`` skews the sampler toward
the device's placement buffer and tunes ``--scale_factor`` live;
``--resume`` continues from ``--save_dir``'s latest checkpoint;
``--op_timing`` adds the spmm / communication buckets to each epoch's
line; ``--profile_dir`` writes a profiler trace of epoch 1.

``--n_devices N`` trains N data-parallel ranks, one process each, which
the CLI starts itself (under ``torchrun`` it joins the group torchrun
set up instead): on ``cuda`` rank r on card r over NCCL, refused where
there are fewer cards than ranks; ``--dist_backend gloo`` lets ranks
share a card (the collectives go through gloo); on ``cpu`` gloo. Each
rank clips its own gradient, the clipped gradients are summed, and
every rank steps the same Adam. ``--feature_cache`` keeps on each rank
only its placement buffer of the feature table and fetches the other
input rows from peers and from host RAM.

``--resident_parts P`` (with ``--adj_format resident`` and an explicit
``--n_devices``) trains a grid of ``n_devices`` data ranks x ``P`` part
ranks, ``n_devices * P`` processes: the resident state (slot table,
rank-1 factors, the hot blocks by slot columns) is sharded over the P
part ranks of each data rank, which sample one batch together, and so
is the feature table (``PartShardedFeatures``), or, with
``--feature_cache``, the placement's P buffers (``PartCachedFeatures``;
the placement then spreads over P buffers, not over the data ranks).
Under NCCL the grid needs a card a rank; ``--dist_backend gloo`` lets
its ranks share cards.

Rank 0 alone prints, writes ``metrics.jsonl`` and checkpoints; every
rank writes ``rank{r}.json`` (its step losses and times, parameter
digests, bytes summed over its part group, feature-source shares, the
resident state's device bytes, its peak device memory after set-up and
its kernel launches) into ``--save_dir``.

``--steps_per_dispatch G`` trains G steps a dispatch: on ``cuda`` one
replay of a CUDA graph that holds G captured steps, on ``cpu`` the same
grouped loop eagerly (`gnn_tpu_torch.train.dispatch`). It runs on one
rank with the replicated feature table, on ``--adj_format resident``
for every model and on ``--adj_format hot`` / ``coo`` for GraphSAGE,
GCN and GIN. Each group is re-padded to the sticky caps of a shape book
kept in ``--save_dir``, so a rerun starts at the shapes the last run
reached. GAT on another format (``hot`` turns into ``pattern`` for GAT),
the ``blocked`` and ``pattern`` formats, ``--feature_cache`` and more
than one rank at G > 1 raise ``NotImplementedError`` before any rank
starts.

``--model gatv1`` is the published GAT (arXiv:1710.10903) at its
inductive widths: ``--nhid`` split over 4 concatenated heads in the
hidden layers, 6 averaged heads of the class count at the output,
additive attention over each row's sampled edges and itself (lr 0.005,
with gat's automatic warm-up). It runs on ``--adj_format resident``, one rank, at any
``--steps_per_dispatch``; other formats, ``--n_devices`` above 1,
``--resident_parts`` and ``--feature_cache`` raise
``NotImplementedError`` before any rank starts (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import os
import sys

from gnn_tpu_torch.utils.timing import span, spanned


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="GNN training on a GPU (GraphSAGE/GCN/GIN/GAT + "
                    "LADIES)")
    # --- reference flags (main.py:24-65) ---
    p.add_argument("--dataset", type=str, default="synthetic",
                   help="dataset name, GraphSAINT dir, ogbn-*, or "
                        "synthetic:nodes=..,deg=..")
    p.add_argument("--model", type=str, default="graphsage",
                   choices=["graphsage", "gcn", "gat", "gin", "gatv1"])
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
                   help="learning rate (default 0.01; 0.002 for gat, "
                        "0.005 for gatv1)")
    p.add_argument("--lr_warmup", type=int, default=-1,
                   help="linear lr warmup steps (lr/100 -> lr); -1 = "
                        "auto: 300 for gat and gatv1, 0 otherwise")
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
                   help="data-parallel ranks (0 = every visible card on "
                        "cuda, 1 on cpu)")
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
                   help="shard the resident state (and the features) over "
                        "this many part ranks per data rank: a grid of "
                        "n_devices x resident_parts ranks")
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
                   help="train steps per dispatch: > 1 replays a CUDA "
                        "graph of G steps per group on cuda (one rank; "
                        "resident format, or hot / coo without "
                        "attention)")
    p.add_argument("--feature_cache", action="store_true",
                   help="placement-driven sharded feature cache: each "
                        "rank holds its placement buffer, other rows come "
                        "from peers or host RAM")
    p.add_argument("--save_dir", type=str, default="save")
    p.add_argument("--resume", action="store_true",
                   help="resume from save_dir's latest checkpoint")
    p.add_argument("--data_dir", type=str,
                   default=os.environ.get("GNN_DATA_DIR", "data"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a profiler trace of epoch 1 here")
    p.add_argument("--op_timing", action="store_true", default=False,
                   help="per-epoch spmm/communication buckets")
    p.add_argument("--no_op_timing", dest="op_timing",
                   action="store_false")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--dist_backend", type=str, default="auto",
                   choices=["auto", "nccl", "gloo"],
                   help="collectives of --n_devices > 1: 'auto' = nccl on "
                        "cuda (one card per rank), gloo on cpu; 'gloo' on "
                        "cuda lets ranks share a card")
    return p


# the models with attention
ATTENTION = ("gat", "gatv1")


def resolve_training_defaults(args, steps_per_epoch: int = 10**9) -> int:
    """Model-dependent lr / warmup defaults (mutates args.lr; returns the
    warmup step count): GAT defaults to lr 0.002 + warmup, GATv1 to the
    published 0.005 + the same warmup (without one its steps diverge at
    width 1024), the others to the reference's 0.01; an explicit --lr
    always wins."""
    if args.lr is None:
        args.lr = {"gat": 0.002, "gatv1": 0.005}.get(args.model, 0.01)
    if args.lr_warmup >= 0:
        return args.lr_warmup
    if args.model not in ATTENTION:
        return 0
    return max(1, min(300, steps_per_epoch))


def _check_gatv1(args, ranks: int) -> None:
    """Raise NotImplementedError where ``--model gatv1`` has no path:
    it runs on the resident format, one rank, the replicated feature
    table (ROADMAP.md's ``gatv1-formats``, ``gatv1-ranks`` and
    ``gatv1-parts`` queue the rest)."""
    if args.model != "gatv1":
        return
    why = []
    if args.adj_format != "resident":
        why.append(f"--adj_format {args.adj_format} (ROADMAP.md: "
                   "gatv1-formats)")
    if args.resident_parts > 1:
        why.append("--resident_parts (ROADMAP.md: gatv1-parts)")
    elif ranks > 1:
        why.append(f"{ranks} ranks (ROADMAP.md: gatv1-ranks)")
    if args.feature_cache:
        why.append("--feature_cache (ROADMAP.md: gatv1-ranks)")
    if why:
        raise NotImplementedError("--model gatv1 is not ported for "
                                  + ", ".join(why))


def _check_ported(args) -> None:
    """Raise NotImplementedError for flag combinations whose paths are
    not ported: ``--model gatv1`` off its path (:func:`_check_gatv1`),
    and ``--steps_per_dispatch > 1`` beyond what
    `gnn_tpu_torch.train.dispatch.unported` allows (the Trainer asks the
    same function). Called after :func:`resolve_adj_format`."""
    _check_gatv1(args, max(args.n_devices, 1)
                 * max(args.resident_parts, 1))
    if args.steps_per_dispatch <= 1:
        return
    from gnn_tpu_torch.train.dispatch import unported
    why = unported(adj_format=args.adj_format,
                   attention=args.model in ATTENTION,
                   ranks=max(args.n_devices, 1) * max(args.resident_parts, 1),
                   replicated=not args.feature_cache)
    if why:
        raise NotImplementedError(
            "--steps_per_dispatch > 1 is not ported for " + ", ".join(why)
            + " (ROADMAP.md queues the rest)")


def grid_parts(args) -> int:
    """The part ranks per data rank (1 without ``--resident_parts``).
    Refuses what the grid cannot run, as the JAX CLI does: the resident
    format only, and a data-rank count given (the JAX package's
    ``make_hybrid_mesh`` asserts on the default)."""
    if args.resident_parts <= 1:
        return 1
    if args.adj_format != "resident":
        raise SystemExit("--resident_parts needs --adj_format resident")
    if args.n_devices <= 0:
        raise SystemExit("--resident_parts P trains n_devices x P ranks: "
                         "give the data ranks with --n_devices")
    return args.resident_parts


def resolve_adj_format(args) -> None:
    """The JAX package's format rules: ``pattern`` is attention-only, and
    GAT turns ``hot`` (whose shipped values it never reads) into
    ``pattern``; GATv1 keeps its format (:func:`_check_gatv1` refuses
    all but ``resident``)."""
    if args.adj_format == "pattern" and args.model not in ATTENTION:
        raise SystemExit("--adj_format pattern is attention-only (the "
                         "aggregation weights are computed on device); "
                         "use coo/hot/resident for graphsage/gcn/gin")
    if args.model == "gat" and args.adj_format == "hot":
        print("--model gat ships pattern-only edges; overriding "
              "--adj_format hot -> pattern", flush=True)
        args.adj_format = "pattern"


def world_size(args) -> int:
    """``--n_devices`` times the part ranks, where ``--n_devices 0``
    means every visible card on ``cuda`` and one rank on ``cpu``."""
    if args.n_devices > 0:
        return args.n_devices * grid_parts(args)
    import torch
    return torch.cuda.device_count() if args.device.startswith("cuda") \
        else 1


@spanned("setup.cli")
def _setup(args, orders, n_devices, device, say, part=None):
    """Graph, Laplacian, placement (over ``n_devices`` buffers), hot
    block and resident graph. The placement, the sample probabilities
    and the hot block's COO are cached in ``--save_dir`` (reference
    ``preprocess.py:317``). With a ``part`` of several ranks only its
    slot-column shards of the blocks are built on ``device``. A span
    ``setup.cli`` with one child a step: ``setup.load``,
    ``setup.laplacian``, ``setup.placement``, ``setup.sample_prob``,
    ``setup.hot_block``, ``setup.resident_graph``."""
    import numpy as np
    import torch

    from gnn_tpu_torch.data.loaders import load_dataset
    from gnn_tpu_torch.placement.engine import create_placement
    from gnn_tpu_torch.utils.normalize import build_laplacian

    with span("setup.load"):
        graph = load_dataset(args.dataset, args.data_dir)
    n = graph.adj_full.shape[0]
    with span("setup.laplacian"):
        lap = build_laplacian(graph.adj_full, args.model, norm=args.norm)

    strategy = ("pagraph" if args.pagraph else
                "random" if args.random else
                "naive" if args.naive else "greedy")
    per_dev = int(args.buffer_size * n)
    say("buffer_size: ", per_dev)
    with span("setup.placement"):
        placement = create_placement(
            lap, graph.train_nodes, per_dev=per_dev, num_devs=n_devices,
            num_conv_layers=sum(orders), alpha=args.alpha,
            strategy=strategy, cache_dir=args.save_dir,
            dataset=args.dataset.replace("/", "_"))

    hot_spec = hot_dense = resident_graph = None
    if args.adj_format in ("hot", "resident"):
        from gnn_tpu_torch.ops.hotdense import (HotSpec,
                                                build_hot_dense_cached,
                                                build_hot_dense_shard)
        from gnn_tpu_torch.placement.engine import compute_sample_prob
        os.makedirs(args.save_dir, exist_ok=True)
        dsname = args.dataset.replace("/", "_").replace(":", "_")
        depth = sum(orders)
        prob_path = os.path.join(args.save_dir,
                                 f"{dsname}.sampprob.L{depth}.npy")
        with span("setup.sample_prob"):
            if os.path.exists(prob_path):
                prob = np.load(prob_path)
            else:
                prob = compute_sample_prob(lap, graph.train_nodes, depth)
                np.save(prob_path, prob)
            hot_spec = HotSpec.from_sample_prob(prob, args.hot_k)
        bf16 = args.hot_dtype == "bfloat16"
        kw = dict(dtype=torch.bfloat16 if bf16 else torch.float32,
                  device=device, cache_path=os.path.join(
                      args.save_dir, f"{dsname}.hotcoo.L{depth}"
                      f".K{args.hot_k}.npz"))
        with span("setup.hot_block"):
            if part is not None and part.size > 1:
                dense, dense_t = build_hot_dense_shard(
                    lap, hot_spec, part.rank, part.size, **kw)
            else:
                dense, dense_t = build_hot_dense_cached(lap, hot_spec,
                                                        **kw)
        say(f"hot block: K={hot_spec.k} "
            f"({2 * dense.numel() * dense.element_size() / 2**20:.0f} "
            f"MiB resident incl. transpose"
            + (f", a part's {dense.shape[1]} columns" if part is not None
               and part.size > 1 else "") + ")")
        if args.adj_format == "resident":
            from gnn_tpu_torch.ops.residentgraph import build_resident_graph
            with span("setup.resident_graph"):
                resident_graph = build_resident_graph(
                    lap, hot_spec, dense, dense_t,
                    val_dtype="bfloat16" if bf16 else np.float32)
        else:
            hot_dense = (dense, dense_t)
    return graph, lap, placement, hot_spec, hot_dense, resident_graph


def train(args, ctx=None):
    """Set up and run the training the CLI describes, as one process
    (``ctx`` None) or as one rank of a group (``ctx`` a
    `DistContext`); returns ``(trainer, graph)``."""
    import numpy as np
    import torch

    from gnn_tpu_torch.device import resolve_device
    from gnn_tpu_torch.models.gnn import build_model
    from gnn_tpu_torch.parallel.dist import DistContext
    from gnn_tpu_torch.parallel.feature_cache import (CachedFeatures,
                                                      PartCachedFeatures,
                                                      PartShardedFeatures,
                                                      ReplicatedFeatures)
    from gnn_tpu_torch.placement.engine import get_per_rank_skewed_nodes
    from gnn_tpu_torch.sampling.ladies import SamplerConfig
    from gnn_tpu_torch.sampling.pipeline import BatchPipeline
    from gnn_tpu_torch.train.metrics import MetricsRegistry
    from gnn_tpu_torch.train.trainer import Trainer

    resolve_adj_format(args)
    _check_ported(args)
    parts = grid_parts(args)
    if ctx is None:
        ctx = DistContext(device=resolve_device(args.device))
    if ctx.parts != parts:
        raise ValueError(f"--resident_parts {args.resident_parts} needs a "
                         f"grid of {parts} part ranks; this rank's has "
                         f"{ctx.parts}")
    device = ctx.device
    main = ctx.is_main

    def say(*msg):
        if main:
            print(*msg, flush=True)

    orders = tuple(int(t) for t in args.orders.split(","))
    n_devices = ctx.dp
    composed = parts > 1 and args.feature_cache
    # the composed cache spreads the placement over the part ranks
    placement_devs = parts if composed else n_devices
    part = ctx.part if parts > 1 else None
    # set-up once: rank 0 builds the caches in --save_dir (and the
    # kernels), the other ranks load them after the barrier
    if main:
        if ctx.world_size > 1 and device.type == "cuda":
            from gnn_tpu_torch.ops import cuda_build
            cuda_build.build_all()
        setup = _setup(args, orders, placement_devs, device, say, part)
    ctx.barrier()
    if not main:
        setup = _setup(args, orders, placement_devs, device, say, part)
    graph, lap, placement, hot_spec, hot_dense, resident_graph = setup
    n = graph.adj_full.shape[0]

    per_rank_skew = None
    scale_factor = args.scale_factor
    if args.locality_sampling:
        import scipy.sparse as sp
        # each rank skews toward its own buffered nodes
        # (reference sampler.py:23-25,119-121)
        per_rank_skew = get_per_rank_skewed_nodes(
            graph.adj_full + sp.eye(n), placement, orders)
        # the tuner may raise the factor during training
        scale_factor = max(scale_factor, 1.0)

    val_free = bool(resident_graph and resident_graph["val_free"])
    stream_tiles = (args.adj_format == "resident" and (
        args.resident_stream == "on"
        or (args.resident_stream == "auto" and device.type == "cuda")))
    cfg = SamplerConfig(
        batch_size=args.batch_size, samp_num=args.samp_num, orders=orders,
        num_nodes=n, num_classes=graph.num_classes, sampler=args.sampler,
        scale_factor=scale_factor, adj_format=args.adj_format,
        hot_spec=hot_spec, resident_val_free=val_free,
        resident_stream_tiles=stream_tiles)
    # the grouped path's sticky shape caps, persisted per configuration
    # (the JAX CLI's book name)
    book_tag = (f"{args.dataset.replace('/', '_').replace(':', '_')}"
                f".{args.model}.{args.sampler}.o{args.orders}"
                f".s{args.samp_num}.b{args.batch_size}.{args.adj_format}"
                f".w{n_devices}")
    pipe = BatchPipeline(cfg, lap, graph.labels, pool_num=args.pool_num,
                         per_rank_skew=per_rank_skew,
                         local_shuffle=args.local_shuffle, seed=args.seed,
                         world_size=n_devices, rank=ctx.data_rank,
                         shape_book_path=os.path.join(
                             args.save_dir, f"{book_tag}.shapebook.json"))
    net = build_model(args.model, args.nhid, orders, graph.num_classes,
                      n_feats=graph.feats.shape[1], seed=args.seed)
    feat_dtype = (torch.bfloat16 if args.feat_dtype == "bfloat16"
                  else torch.float32)
    if composed:
        source = PartCachedFeatures(graph.feats, placement, ctx.part,
                                    dtype=feat_dtype, device=device)
    elif args.feature_cache:
        source = CachedFeatures(graph.feats, placement, ctx,
                                dtype=feat_dtype)
    elif parts > 1:
        source = PartShardedFeatures(graph.feats, ctx.part,
                                     dtype=feat_dtype, device=device)
    else:
        source = ReplicatedFeatures(graph.feats, device=device,
                                    dtype=feat_dtype)
    lr_warmup = resolve_training_defaults(
        args, steps_per_epoch=max(1, len(graph.train_nodes)
                                  // (args.batch_size * n_devices)))
    trainer = Trainer(net, pipe, graph.feats, lr=args.lr,
                      sigmoid_loss=args.sigmoid_loss, seed=args.seed,
                      feature_source=source, resident_graph=resident_graph,
                      hot_dense=hot_dense, lr_warmup=lr_warmup, dist=ctx,
                      resident_parts=args.resident_parts,
                      steps_per_dispatch=args.steps_per_dispatch)
    setup_peak = (torch.cuda.max_memory_allocated(device)
                  if device.type == "cuda" else 0)
    rank_chunks = None
    if args.local_shuffle and args.pagraph:
        rank_chunks = placement.train_nodes_per_dev
    metrics = MetricsRegistry(os.path.join(args.save_dir, "metrics.jsonl")) \
        if main else None
    try:
        trainer.fit(graph.train_nodes, graph.valid_nodes, args.epoch_num,
                    rank_chunks=rank_chunks, checkpoint_dir=args.save_dir,
                    locality_tuner=args.locality_sampling, metrics=metrics,
                    profile_dir=args.profile_dir or None,
                    op_timing=args.op_timing, resume=args.resume)
        train_cache = dict(getattr(source, "stats", {}))
        if args.test:
            f1 = trainer.test(graph.test_nodes, batch_size=128)
            if main:
                metrics.log(test_f1=f1)
            say("Test f1 score: %.3f" % f1)
    finally:
        pipe.close()
    _write_rank_record(args.save_dir, trainer, train_cache,
                       getattr(source, "row_bytes", 0), setup_peak)
    return trainer, graph


def _write_rank_record(save_dir, trainer, cache_stats, row_bytes,
                       setup_peak) -> None:
    """``rank{r}.json`` in ``save_dir``: this rank's place on the grid,
    its epochs (step losses, step seconds, parameter digest, bytes summed
    over the part group), the feature source's row counts over the
    batches it planned before the test sweep, the test sweep's batches,
    the resident state's and the features' device bytes, the peak device
    memory after set-up, every kernel's launches in this process and,
    under grouped dispatch, the CUDA graph captures and replayed
    launches."""
    import json

    from gnn_tpu_torch.ops.cuda_build import launch_counts
    ctx = trainer.dist
    launches = launch_counts()
    rec = {"rank": ctx.rank, "world_size": ctx.world_size,
           "data_rank": ctx.data_rank, "part_rank": ctx.part_rank,
           "parts": ctx.parts,
           "device": str(ctx.device), "backend": ctx.backend,
           "epochs": [{"epoch": m.epoch, "step_losses": m.step_losses,
                       "step_times": m.step_times,
                       "param_digest": m.param_digest,
                       "part_bytes": m.part_bytes,
                       "communication_s": m.communication_time}
                      for m in trainer.history],
           "cache": {**cache_stats, "row_bytes": row_bytes},
           "state_bytes": trainer.state_bytes(),
           "setup_max_memory": setup_peak,
           "test_batches": trainer.test_batches, "launches": launches}
    if trainer._dispatch is not None:
        # grouped dispatch: the CUDA graph captures (each with the kernel
        # launches it recorded and its replays) and the launches the
        # replays ran, which ``launches`` does not see
        rec["captures"] = trainer._dispatch.captures
        rec["replayed_launches"] = dict(
            trainer._dispatch.replayed_launches())
    with open(os.path.join(save_dir, f"rank{ctx.rank}.json"), "w") as f:
        json.dump(rec, f)


def _rank_entry(rank, rdv, args, backend) -> None:
    """One spawned rank: join the group, train, leave."""
    import torch

    from gnn_tpu_torch.parallel.dist import close_dist, init_dist
    device_type = torch.device(args.device).type
    if device_type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // rdv.world_size))
    ctx = init_dist(rank, rdv, device_type, backend, grid_parts(args))
    try:
        train(args, ctx)
    finally:
        close_dist(ctx)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(args, flush=True)
    resolve_adj_format(args)
    _check_ported(args)
    parts = grid_parts(args)
    import torch

    from gnn_tpu_torch.parallel import dist
    device_type = torch.device(args.device).type
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # started by torchrun: join its group
        if args.n_devices not in (0, int(os.environ["WORLD_SIZE"])
                                  // parts):
            raise SystemExit(f"--n_devices {args.n_devices} x "
                             f"--resident_parts {parts} under torchrun "
                             f"with WORLD_SIZE {os.environ['WORLD_SIZE']}")
        ctx = dist.init_dist_from_env(device_type, args.dist_backend,
                                      parts)
        try:
            train(args, ctx)
        finally:
            dist.close_dist(ctx)
        return 0
    n = world_size(args)
    # the ranks --n_devices 0 resolves to
    _check_gatv1(args, n)
    if n > 1 and args.steps_per_dispatch > 1:
        # --n_devices 0 on a machine of several cards
        raise NotImplementedError(
            f"--steps_per_dispatch > 1 is not ported for {n} ranks "
            f"(ROADMAP.md queues the rest)")
    if n <= 1:
        train(args)
        return 0
    # refused here, before any rank starts, where the ranks cannot run
    backend = dist.resolve_backend(device_type, args.dist_backend, n)
    dist.spawn_ranks(n, _rank_entry, (args, backend),
                     rendezvous_dir=args.save_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
