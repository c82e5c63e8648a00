"""One run of one cell: set-up, the checked first steps, warm-up, the
measured window, and the comparison that decides ``correct``.

Set-up builds the port's trainer through its CLI (`portbench.program`),
loads the benchmark's initial parameters (made on the device from the
seed), and trains the first steps through the window's own call on
distinct training nodes: one step (Adam's state after it gives the first
gradient), then ``max(G, 2)`` steps (one replay of the G-step graph at
``--steps_per_dispatch G``). The shapes that those steps met are then
forgotten (`program.fresh_shapes`), so that the window's captures and
peak memory do not follow the seed. Then ``Trainer.fit`` trains as the CLI
does, epoch after epoch: its first ``warmup_epochs`` epochs belong to
set-up (they fill the shape book and capture the graphs), and the window
is the whole epochs after them (train, val pass, best-model bookkeeping
and the rolling checkpoint), up to the first epoch end at or past
``--seconds``. With ``--trace 1`` the window is followed by
``profile_epochs`` whole epochs under ``torch.profiler``.

Once the window has closed and the peak memory is read, the program's
state is freed and the reference follows the checked steps on the same
batches from the same parameters (`portbench.reference`); `check`
compares the two."""
from __future__ import annotations

import gc
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from portbench import check, manifest, program
from portbench import trace as tracemod
from portbench.counts import step as stepcount
from portbench.reference import graph as refgraph
from portbench.reference import train as reftrain

# top-level module names no run may hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "gnn_tpu")
# the checked steps' trainer epochs (apart from Trainer.fit's 0, 1, ...)
CHECK_EPOCH = 1_000_000
# window batches kept for the step count: one in this many
SAMPLE_EVERY = 16
# the most of them the count reads
SAMPLED = 24


class NoCard(RuntimeError):
    """The run cannot measure: no card, or fewer than the cell needs."""


class _WindowClosed(Exception):
    pass


def cache_dir(*parts) -> str:
    """A fixed directory inside the checkout for what a run may reuse."""
    path = os.path.join(manifest.HERE, ".cache", *parts)
    os.makedirs(path, exist_ok=True)
    return path


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules, compared
    whole (``gnn_tpu_torch`` is not ``gnn_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class RunState:
    """What the hooks see and set while ``Trainer.fit`` runs."""

    def __init__(self):
        self.phase = "check"
        self.epoch = None
        self.check_batches = []
        self.window_sample = []
        self.window_batches = 0
        self.slice_tiles = []
        self.slice_eval_tiles = []
        self.t_window = [None, None]
        self.window_epochs = 0
        self.slice_epochs = 0
        self.prof = None
        self.span = None


def run_cell(cell: dict, cfg: dict, tr: dict, seed: int,
             seconds: float, trace: bool, limits: dict, *,
             device: str = "cuda", t_start: float = None,
             require_card: bool = True, metric_names=None) -> dict:
    """Run one cell (its ``BENCHMARK.json`` entry, configuration and
    traffic) once; returns the result line's object (``checks`` last).
    ``metric_names``: the metrics the line reports (the cell's
    end-to-end metrics, or with ``trace`` its per-layer ones)."""
    t_start = time.perf_counter() if t_start is None else t_start
    if require_card:
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            raise NoCard(f"{torch.cuda.device_count()} cards, the cell "
                         f"needs {cell['chips']}")
    # the configuration's dense products: float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = manifest.spec(cfg, tr)
    spec["config"] = cell["config"]
    run_dir = tempfile.mkdtemp(prefix="portbench-run-")
    try:
        return _run(spec, seed, seconds, trace, limits, device,
                    t_start, run_dir, metric_names)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def setup_static(spec, device) -> dict:
    """The CLI's set-up of a configuration (its caches in the checkout's
    fixed directory of the configuration), and the warm-up resolved for
    the dataset's training nodes (in ``spec``)."""
    argv = program.cli_argv(spec, device)
    args, graph, lap, hot_spec, hot_dense, rgraph, dev = program.setup(
        argv, cache_dir("configs", spec["config"]))
    if (graph.feats.shape[1], graph.num_classes) != (spec["n_feats"],
                                                     spec["classes"]):
        raise ValueError("the dataset's widths are not the configuration's")
    n_train = len(graph.train_nodes)
    spec["lr_warmup_steps"] = (
        min(spec["lr_warmup_max"], n_train // spec["batch_size"])
        if spec["lr_warmup_max"] > 0 else 0)
    return {"args": args, "graph": graph, "lap": lap, "hot_spec": hot_spec,
            "hot_dense": hot_dense, "rgraph": rgraph, "dev": dev}


def new_trainer(static, spec, seed, run_dir):
    """``(trainer, pipeline, sampler width, initial parameters)`` of one
    run: the port's trainer holding the benchmark's parameters, made
    from ``seed``."""
    s = static
    trainer, pipe, width = program.build(
        s["args"], s["graph"], s["lap"], s["hot_spec"], s["hot_dense"],
        s["rgraph"], s["dev"], run_dir, spec["lr_warmup_steps"])
    params0 = reftrain.make_params(spec, seed, s["dev"])
    program.load_params(trainer, params0)
    return trainer, pipe, width, params0


def _run(spec, seed, seconds, trace, limits, device, t_start,
         run_dir, metric_names):
    st = RunState()
    # --- set-up: the CLI's set-up, the trainer, the parameters ---------
    t0 = time.perf_counter()
    static = setup_static(spec, device)
    graph, dev = static["graph"], static["dev"]
    trainer, pipe, width, params0 = new_trainer(static, spec, seed, run_dir)
    del static
    try:
        t_prepared = time.perf_counter()
        out = _train(st, trainer, pipe, graph, spec, seed, seconds, trace,
                     dev, run_dir)
    finally:
        pipe.close()
    prog = out.pop("prog")
    out["spans"] = {"setup.prepare": t_prepared - t0,
                    "setup.warmup": st.t_window[0] - t_prepared}
    # --- the window has closed: the peak, the loaded modules -----------
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    leaked = forbidden_modules()
    if leaked:
        raise RuntimeError("modules loaded that the port may not use: "
                           + ", ".join(leaked))
    del trainer, pipe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # --- the reference -------------------------------------------------
    rg = reference_graph(graph, spec)
    nums, fault = compare(spec, rg, st.check_batches, graph.feats, dev,
                          params0, prog)
    correct = check.verdict(nums, limits)
    # --- metrics -------------------------------------------------------
    win = out["window"]
    metrics = {}
    if trace:
        rec = dict(out, spec=spec)
        rec["work"] = _work(rg, spec, st.window_sample)
        for m in metric_names:
            value = manifest.reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"train_nodes_per_s": win["nodes"] / win["seconds"],
                  "peak_mem_gib": peak / 2 ** 30,
                  "setup_s": st.t_window[0] - t_start}
        for m in metric_names:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    losses = [x for e in win["epochs"] for x in e["losses"]]
    result = {
        "correct": bool(correct), "attempted": len(losses),
        "failed": int(sum(1 for x in losses if not math.isfinite(x))),
        "metrics": metrics,
        "device": _device(dev, peak, out.get("slice") if trace else None),
    }
    if trace:
        sl = out["slice"]
        result["breakdown"] = {"device_ops": sl["device_ops"],
                               "idle_gaps": sl["idle_gaps"]}
    result["context"] = {
        "sampler_width": width, "steps_checked": len(prog["losses"]),
        "window_epochs": len(win["epochs"]), "window_steps": win["steps"],
        "power_limit_w": _power_limit(), "batch_fault": fault,
        "graph_entries": int(graph.adj_full.nnz)}
    result["checks"] = {k: {"value": nums[k], "limit": limits[k]}
                        for k in check.NUMBERS}
    return result


def checked_steps(st, trainer, graph, spec, seed) -> dict:
    """The first steps through the window's own call, on distinct
    training nodes drawn from ``seed``: one step, Adam's state, then
    ``max(G, 2)`` steps. Returns the program's side of the comparison;
    the batches land in ``st.check_batches`` (a `Feed`'s sink puts them
    there while ``st.phase`` is ``check``)."""
    order = np.random.default_rng(seed).permutation(graph.train_nodes)
    batch, group = spec["batch_size"], spec["steps_per_dispatch"]
    second = max(group, 2)
    st.epoch = CHECK_EPOCH
    m1 = trainer.train_epoch(order[:batch], CHECK_EPOCH)
    first_grad = program.first_moment(trainer, spec["adam"]["beta1"])
    st.epoch = CHECK_EPOCH + 1
    m2 = trainer.train_epoch(order[batch:batch * (1 + second)],
                             CHECK_EPOCH + 1)
    return {"losses": list(m1.step_losses) + list(m2.step_losses),
            "first_grad": first_grad, "params": program.params(trainer)}


def reference_graph(graph, spec) -> refgraph.RefGraph:
    a = program.graph_arrays(graph)
    return refgraph.RefGraph(
        a["indptr"], a["indices"], a["data"], a["label_indptr"],
        a["label_indices"], a["num_classes"], a["train_nodes"],
        norm=spec["norm"], hot_k=spec["hot_k"], depth=len(spec["orders"]))


def compare(spec, rg, batches, feats, dev, params0, prog):
    """``(numbers, batch fault)`` of the program's checked steps against
    the reference's."""
    try:
        steps = reftrain.prepare(spec, rg, batches, feats, dev)
    except refgraph.BatchFault as e:
        return {k: float("inf") for k in check.NUMBERS}, str(e)
    ref = reftrain.follow(spec, params0, steps)
    return check.numbers(prog, ref, params0), ""


def _train(st, trainer, pipe, graph, spec, seed, seconds, trace, dev,
           run_dir):
    """The checked steps, then ``Trainer.fit`` to the window's end."""
    from gnn_tpu_torch.train.metrics import MetricsRegistry
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def sink(mb, kind):
        if st.phase == "check" and kind == "train":
            st.check_batches.append(program.batch_view(mb, st.epoch))
        elif st.phase == "window" and kind == "train" and trace:
            if st.window_batches % SAMPLE_EVERY == 0:
                st.window_sample.append(program.batch_view(mb, 0))
            st.window_batches += 1
        elif st.phase == "slice":
            (st.slice_tiles if kind == "train"
             else st.slice_eval_tiles).append(program.tile_counts(mb))

    program.Feed(pipe, sink, eval_too=trace)
    prog = checked_steps(st, trainer, graph, spec, seed)
    program.fresh_shapes(trainer, pipe, run_dir)
    # --- warm-up epochs, then the window -------------------------------
    warm = spec["warmup_epochs"]
    if warm < 1:
        raise ValueError("a cell warms up for one epoch at least")
    st.phase = "warmup"

    def at_epoch_end(epoch):
        sync()
        now = time.perf_counter()
        if epoch == warm - 1:
            st.phase = "window"
            st.t_window[0] = now
            return
        if st.phase == "window" and now - st.t_window[0] >= seconds:
            st.t_window[1] = now
            st.window_epochs = epoch - warm + 1
            if not trace:
                raise _WindowClosed
            st.phase = "slice"
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            st.prof = profile(activities=acts)
            st.prof.start()
            st.span = torch.profiler.record_function("portbench.slice")
            st.span.__enter__()
            return
        if st.phase == "slice":
            st.slice_epochs += 1
            if st.slice_epochs >= spec["profile_epochs"]:
                st.span.__exit__(None, None, None)
                st.prof.stop()
                raise _WindowClosed

    program.on_epoch_end(trainer, at_epoch_end)
    program.span_evaluate(trainer)
    try:
        trainer.fit(graph.train_nodes, graph.valid_nodes, 1 << 30,
                    checkpoint_dir=run_dir,
                    metrics=MetricsRegistry(os.path.join(run_dir,
                                                         "metrics.jsonl")))
    except _WindowClosed:
        pass
    sync()
    epochs = program.window_epochs(trainer, warm)
    win_epochs = epochs[: st.window_epochs]
    out = {"prog": prog,
           "window": {"seconds": st.t_window[1] - st.t_window[0],
                      "epochs": win_epochs,
                      "steps": sum(e["steps"] for e in win_epochs),
                      "nodes": st.window_epochs * len(graph.train_nodes)}}
    if trace:
        dev_ev, host_ev, (t0, t1) = tracemod.profile_events(
            st.prof, "portbench.slice")
        sl = tracemod.reduce_slice(dev_ev, host_ev, t0, t1)
        sl_epochs = epochs[st.window_epochs:]
        sl["steps"] = sum(e["steps"] for e in sl_epochs)
        sl["tiles"] = st.slice_tiles
        sl["eval_tiles"] = st.slice_eval_tiles
        out["slice"] = sl
        st.prof = None
    return out


def _work(rg, spec, sample) -> dict:
    """A training step's operations in seconds at the card's peaks, the
    mean over an even sample of the window's batches."""
    if not sample:
        return {"step_s_at_peak": None, "sampled": 0}
    idx = np.unique(np.linspace(0, len(sample) - 1,
                                min(SAMPLED, len(sample))).astype(int))
    secs = []
    for i in idx:
        lv = refgraph.levels(sample[i])
        layers = []
        for l, o in enumerate(spec["orders"]):
            if o == 0:
                layers.append({"r": len(lv[l + 1]), "c": len(lv[l]),
                               "nnz": 0, "nnz_hot": 0})
                continue
            lay = rg.layer(lv[l + 1], lv[l], spec["samp_num"])
            layers.append({"r": len(lv[l + 1]), "c": len(lv[l]),
                           "nnz": lay["nnz"], "nnz_hot": lay["nnz_hot"]})
        secs.append(stepcount.step_seconds_at_peak(spec, layers,
                                                   len(lv[-1])))
    return {"step_s_at_peak": float(np.mean(secs)), "sampled": len(secs)}


def _device(dev, peak, sl) -> dict:
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if sl is not None:
        out["busy_s"] = sl["busy_s"]
        out["window_s"] = sl["window_s"]
    return out


def _power_limit():
    """The card's power limit in watts, as ``nvidia-smi`` reads it (None
    where it cannot)."""
    import subprocess
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(res.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None
