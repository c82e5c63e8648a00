"""Every place the benchmark touches the port (``gnn_tpu_torch``): the
set-up through the port's CLI, and the reaches into it that PERF.md
lists for the tracing work. Nothing else in the benchmark imports the
port, and the reference imports none of this.

The reaches, all made from this file on objects of one run:

* :func:`build` repeats the single-rank construction of ``cli.train``
  (pipeline, model, feature table, trainer), because ``cli.train`` keeps
  the set-up caches and the run's own state in one ``--save_dir`` and
  runs ``Trainer.fit`` itself;
* :class:`Feed` wraps the pipeline's ``train_epoch`` and
  ``eval_batches`` generators, to see each host batch and to span the
  trainer's wait for the next one;
* :func:`on_epoch_end` wraps ``Trainer.save`` (the last call of an epoch
  in ``Trainer.fit``) to end the window between epochs, and
  :func:`span_evaluate` spans ``Trainer.evaluate``;
* :func:`first_moment` reads Adam's state of the trainer's optimizer;
* :func:`fresh_shapes` clears the grouped dispatch's graphs
  (``Trainer._dispatch.clear()``) and replaces the pipeline's
  ``shape_book`` after the checked steps;
* :func:`build` records the native sampler's OpenMP width as the
  pipeline sets it (the LADIES draws depend on it).
"""
from __future__ import annotations

import os

import numpy as np


def cli_argv(spec: dict, device: str) -> list:
    """The port's CLI flags of a cell (`portbench.manifest.spec`): the
    configuration's model and precisions, the traffic's batch, sampler,
    dispatch and the seed of its draws (``program_seed``, the same for
    every run, so every run samples the same batches)."""
    return ["--dataset", spec["dataset"], "--model", spec["model"],
            "--nhid", str(spec["nhid"]),
            "--orders", ",".join(str(o) for o in spec["orders"]),
            "--hot_k", str(spec["hot_k"]),
            "--hot_dtype", spec["hot_dtype"],
            "--feat_dtype", spec["feat_dtype"], "--norm", spec["norm"],
            "--lr", repr(spec["lr"]),
            "--batch_size", str(spec["batch_size"]),
            "--samp_num", str(spec["samp_num"]),
            "--adj_format", spec["adj_format"],
            "--steps_per_dispatch", str(spec["steps_per_dispatch"]),
            "--sampler", spec["sampler"],
            "--pool_num", str(spec["pool_num"]),
            "--seed", str(spec["program_seed"]), "--device", device] + (
        ["--sigmoid_loss"] if spec["loss"] == "sigmoid_bce"
        else ["--no_sigmoid_loss"])


def setup(argv: list, cache_dir: str):
    """Parse the CLI flags and run the CLI's set-up with its caches
    (placement, sampling probabilities, the hot block's COO) in
    ``cache_dir``: ``(args, graph, lap, hot_spec, hot_dense,
    resident_graph, device)``."""
    from gnn_tpu_torch import cli
    from gnn_tpu_torch.device import resolve_device
    args = cli.build_parser().parse_args(argv)
    cli.resolve_adj_format(args)
    cli._check_ported(args)
    args.save_dir = cache_dir
    device = resolve_device(args.device)
    orders = tuple(int(t) for t in args.orders.split(","))
    graph, lap, _placement, hot_spec, hot_dense, resident_graph = \
        cli._setup(args, orders, 1, device, lambda *m: None)
    return args, graph, lap, hot_spec, hot_dense, resident_graph, device


def graph_arrays(graph) -> dict:
    """The dataset's raw arrays, as both sides read them."""
    lab = graph.labels.tocsr()
    return {"indptr": graph.adj_full.indptr,
            "indices": graph.adj_full.indices,
            "data": graph.adj_full.data, "label_indptr": lab.indptr,
            "label_indices": lab.indices, "num_classes": graph.num_classes,
            "train_nodes": graph.train_nodes,
            "valid_nodes": graph.valid_nodes, "feats": graph.feats}


def build(args, graph, lap, hot_spec, hot_dense, resident_graph, device,
          run_dir: str, lr_warmup: int):
    """``cli.train``'s single-rank construction, with the shape book in
    the run's own ``run_dir``: ``(trainer, pipeline, sampler width)``,
    the last the native sampler's OpenMP width as the pipeline set it (0
    where the native core did not load)."""
    import torch

    from gnn_tpu_torch import cli
    from gnn_tpu_torch.models.gnn import build_model
    from gnn_tpu_torch.parallel.dist import DistContext
    from gnn_tpu_torch.parallel.feature_cache import ReplicatedFeatures
    from gnn_tpu_torch.sampling.ladies import SamplerConfig
    from gnn_tpu_torch.sampling.pipeline import BatchPipeline
    from gnn_tpu_torch.train.trainer import Trainer

    orders = tuple(int(t) for t in args.orders.split(","))
    n = graph.adj_full.shape[0]
    # the warm-up as the configuration states it, resolved for the
    # dataset's training nodes
    args.lr_warmup = lr_warmup
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
    width = []
    from gnn_tpu_torch import native
    lib = native.get_lib()
    if lib is not None:
        # the pipeline sets the native sampler's OpenMP width once
        set_threads = lib.set_threads

        def recorded(n):
            width.append(int(n))
            set_threads(n)
        lib.set_threads = recorded
    try:
        pipe = BatchPipeline(cfg, lap, graph.labels,
                             pool_num=args.pool_num,
                             local_shuffle=args.local_shuffle,
                             seed=args.seed,
                             shape_book_path=os.path.join(
                                 run_dir, "shapebook.json"))
    finally:
        if lib is not None:
            lib.set_threads = set_threads
    net = build_model(args.model, args.nhid, orders, graph.num_classes,
                      n_feats=graph.feats.shape[1], seed=args.seed)
    source = ReplicatedFeatures(
        graph.feats, device=device,
        dtype=torch.bfloat16 if args.feat_dtype == "bfloat16"
        else torch.float32)
    lr_warmup = cli.resolve_training_defaults(
        args, steps_per_epoch=max(1, len(graph.train_nodes)
                                  // args.batch_size))
    trainer = Trainer(net, pipe, graph.feats, lr=args.lr,
                      sigmoid_loss=args.sigmoid_loss, seed=args.seed,
                      feature_source=source, resident_graph=resident_graph,
                      hot_dense=hot_dense, lr_warmup=lr_warmup,
                      dist=DistContext(device=device),
                      steps_per_dispatch=args.steps_per_dispatch)
    return trainer, pipe, (width[-1] if width else 0)


def fresh_shapes(trainer, pipe, run_dir: str) -> None:
    """Forget the padded shapes that the checked steps met: the grouped
    dispatch's graphs and static buffers, and the pipeline's shape book
    (its file in ``run_dir`` too). The window's caps and captures then
    follow the traffic alone, not the rows a seed checked."""
    from gnn_tpu_torch.sampling.pipeline import ShapeBook
    if trainer._dispatch is not None:
        trainer._dispatch.clear()
    path = os.path.join(run_dir, "shapebook.json")
    if os.path.exists(path):
        os.unlink(path)
    pipe.shape_book = ShapeBook(path)


def load_params(trainer, params: dict) -> None:
    """The benchmark's initial parameters into the trainer's model, name
    for name."""
    trainer.net.load_state_dict(params, strict=True)


def params(trainer) -> dict:
    return {k: v.detach().clone() for k, v in
            trainer.net.state_dict().items()}


def first_moment(trainer, beta1: float) -> dict:
    """Adam's first moment of each parameter over ``1 - beta1``: after
    one step, the clipped gradient as the optimizer got it (zeros where
    the optimizer holds no state)."""
    import torch
    state = trainer.optimizer.state
    out = {}
    for name, p in trainer.net.named_parameters():
        m = state.get(p, {}).get("exp_avg")
        out[name] = (torch.zeros_like(p) if m is None
                     else m.detach() / (1.0 - beta1))
    return out


def batch_view(mb, epoch: int) -> dict:
    """A host batch as the reference reads it: the valid input nodes,
    each layer's valid rows as positions among the level below, the
    targets, the padded rows of each layer's output (the shapes of the
    dropout draws) and the trainer's epoch."""
    n_rows = [a.n_valid_rows for a in mb.adjs]
    return {"input_nodes": np.array(mb.input_nodes[: mb.n_input]),
            "positions": [np.array(s[:r]) for s, r in
                          zip(mb.sampled_nodes, n_rows)],
            "targets": np.array(mb.batch_nodes[: int(mb.label_mask.sum())]),
            "caps": [len(s) for s in mb.sampled_nodes], "epoch": epoch}


def tile_counts(mb) -> list:
    """Per layer of a host batch, what the edge-stream kernels read:
    ``e`` cold edges, ``nb`` tile entries holding edges, ``r`` / ``c``
    valid rows and columns (None for a layer without stream tiles)."""
    out = []
    for a in mb.adjs:
        off = getattr(a, "es_off", None)
        if off is None:
            out.append(None)
            continue
        nb = a.es_rc.shape[0]
        cnt = np.asarray(off[1, :nb], np.int64)
        out.append({"e": int(cnt.sum()), "nb": int(np.count_nonzero(cnt)),
                    "r": int(a.n_valid_rows), "c": int(a.n_valid_cols)})
    return out


class Feed:
    """The pipeline's batch generators, wrapped: every training batch
    (and, with ``eval_too``, every evaluation batch) goes to ``sink(mb,
    kind)`` as the trainer takes it; the trainer's wait for the next
    training batch is a profiler span ``portbench.sampler_wait``."""

    def __init__(self, pipe, sink, eval_too: bool = False):
        import torch
        self._rf = torch.profiler.record_function
        self.sink = sink
        train, evals = pipe.train_epoch, pipe.eval_batches

        def train_epoch(*a, **kw):
            it = train(*a, **kw)
            while True:
                with self._rf("portbench.sampler_wait"):
                    mb = next(it, None)
                if mb is None:
                    return
                self.sink(mb, "train")
                yield mb

        def eval_batches(*a, **kw):
            for mb in evals(*a, **kw):
                if eval_too:
                    self.sink(mb, "eval")
                yield mb

        pipe.train_epoch = train_epoch
        pipe.eval_batches = eval_batches


def on_epoch_end(trainer, hook) -> None:
    """Call ``hook(epoch)`` after each of ``Trainer.fit``'s rolling
    checkpoints (the last act of an epoch); ``hook`` may raise to end the
    fit."""
    import torch
    save = trainer.save

    def saved(ckpt_dir, step=0):
        with torch.profiler.record_function("portbench.checkpoint"):
            out = save(ckpt_dir, step)
        hook(step - 1)
        return out

    trainer.save = saved


def span_evaluate(trainer) -> None:
    import torch
    evaluate = trainer.evaluate

    def spanned(*a, **kw):
        with torch.profiler.record_function("portbench.val_pass"):
            return evaluate(*a, **kw)

    trainer.evaluate = spanned


def window_epochs(trainer, first_epoch: int) -> list:
    """The trainer's per-epoch records from epoch ``first_epoch`` on:
    ``{steps, losses, sample_wait_s, data_movement_s, execution_s,
    captures}``."""
    return [{"epoch": m.epoch, "steps": len(m.step_losses),
             "losses": list(m.step_losses),
             "sample_wait_s": m.sample_wait_time,
             "data_movement_s": m.data_movement_time,
             "execution_s": m.execution_time, "captures": m.captures}
            for m in trainer.history if m.epoch >= first_epoch]
