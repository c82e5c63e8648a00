"""Grouped dispatch (``--steps_per_dispatch G``): G training steps a
dispatch, the counterpart of the grouped loop of `gnn_tpu.train.dispatch`.

The JAX trainer runs a group as one jitted ``lax.scan`` of G optimizer
steps. On the card a group is one replay of a CUDA graph that holds G
captured steps: the host's per-kernel launch cost, which sets the
default path's step (PERF.md §5), is paid once a capture instead of
once a step. A graph replays fixed kernels on fixed addresses, so

* a group's batches are re-padded to common shapes on the host
  (`BatchPipeline.train_epoch_grouped`, the sticky `ShapeBook`), and
  the shapes are the graph's key (:func:`group_key`);
* every value that varies within a key rides in a tensor of the static
  input buffers: the batches' arrays and their counts
  (`gnn_tpu_torch.ops.sparse.COUNT_FIELDS`, 0-d tensors), the G steps'
  learning rates (``lr[G]``, Adam with ``capturable=True``), and the
  dropout generator's seed and offset (registered with the graph, so a
  replay draws the masks eager steps would draw);
* a group is staged through pinned host buffers into the static device
  buffers with ``non_blocking`` copies and replayed, and the losses stay
  on the card until the epoch ends, when one copy reads them all.

A capture runs ``WARMUP_STEPS`` eager steps on a side stream first (they
load the kernel libraries, set their attributes and create Adam's
state), then restores the parameters, Adam's state and the generator,
and captures. The graph cache keeps at most ``MAX_BUCKETS`` padded
shapes, each with at most two graphs (G steps, and one step for a short
tail), so at most ``2 * MAX_BUCKETS`` graphs live; the least recently
used shape goes first. Each capture is logged with its seconds.

The tail group (``n_valid < G`` steps) replays the one-step graph of its
shape ``n_valid`` times, each time after copying the next batch into
slot 0 on the card: the parameters update exactly ``n_valid`` times, and
no step is computed and thrown away (the JAX scan masks its padded
steps instead).

What runs grouped (:func:`unported` says why the rest does not): one
rank with a replicated feature table, on the resident format for every
model (GAT's cold residual launches K3/K4 inside the graph, as the
default path launches K1) and on the shipped ``hot`` and ``coo`` formats
for the models without attention (their cold residual is chunked
``index_add_`` over the group's padded edges). A capture records the
kernel launches its steps make (the wrappers' ``captured`` counters,
by ``module.key``), and :meth:`GroupedDispatch.replayed_launches`
multiplies them by the graph's replays.

On a CPU device the same grouped loop runs the steps eagerly. On the
card a failed capture or replay raises: nothing falls back to eager
steps or to the CPU.
"""
from __future__ import annotations

import collections
import dataclasses
import zlib
from typing import List

import numpy as np
import torch

from gnn_tpu_torch.ops.cuda_build import launch_counts
from gnn_tpu_torch.ops.sparse import COUNT_FIELDS
from gnn_tpu_torch.train.stepfns import DeviceBatch, to_device_batch
from gnn_tpu_torch.utils.timing import count, span

# eager steps before a capture (the CUDA graph documentation's example
# warms up three)
WARMUP_STEPS = 3
# padded shapes whose static buffers and graphs stay live
MAX_BUCKETS = 2


# the (adjacency format, attention) pairs grouped dispatch runs: every
# model on the resident format, the models without attention on the
# shipped hot and coo formats
GROUPED_FORMATS = frozenset({("resident", False), ("resident", True),
                             ("hot", False), ("coo", False)})


def unported(*, adj_format: str, attention: bool, ranks: int,
             replicated: bool) -> List[str]:
    """Why grouped dispatch cannot run a configuration (empty when it
    can): the adjacency format and whether the model has attention
    (``attention``: GAT or GATv1) must be one of :data:`GROUPED_FORMATS`,
    on one rank
    with a replicated feature table. The CLI asks before any rank
    starts, `Trainer` when it is built; ROADMAP.md queues the rest."""
    why = []
    if ranks > 1:
        why.append(f"{ranks} ranks")
    if (adj_format, attention) not in GROUPED_FORMATS:
        why.append(f"GAT on the {adj_format} format" if attention
                   else f"the {adj_format} format")
    if not replicated:
        why.append("a feature source other than the replicated table")
    return why


def _adj_leaves(adj, host: bool) -> list:
    """An adjacency's array fields and counts, in field order; a count is
    an int64 0-d array on the host."""
    out = []
    for f in dataclasses.fields(adj):
        v = getattr(adj, f.name)
        if v is None:
            continue
        if f.name in COUNT_FIELDS:
            out.append(np.asarray(v, np.int64) if host else v)
        elif isinstance(v, np.ndarray if host else torch.Tensor):
            out.append(v)
    return out


def batch_leaves(batch, host: bool) -> list:
    """Every array a step reads from a batch (a host `MiniBatch` or a
    `DeviceBatch`), in one fixed order; an adjacency that several layers
    share counts once."""
    out = [batch.input_nodes, batch.input_mask, batch.labels,
           batch.label_mask, *batch.sampled_nodes]
    seen = set()
    for a in batch.adjs:
        if a is not None and id(a) not in seen:
            seen.add(id(a))
            out += _adj_leaves(a, host)
    return out


def group_key(mb) -> tuple:
    """A host batch's padded shapes: every leaf's shape and type, and
    every adjacency's shape fields (``nrows``, pads, tile dims). Batches
    with one key fill one set of static buffers."""
    adjs = []
    for a in mb.adjs:
        if a is None:
            adjs.append(None)
            continue
        adjs.append((type(a).__name__,) + tuple(
            (f.name, getattr(a, f.name)) for f in dataclasses.fields(a)
            if f.name not in COUNT_FIELDS
            and not isinstance(getattr(a, f.name), np.ndarray)))
    return (tuple((x.shape, x.dtype.str) for x in batch_leaves(mb, True)),
            tuple(adjs))


class _Bucket:
    """The static buffers of one padded shape: ``G`` device batches (the
    graphs' inputs), pinned host copies of their leaves, the steps'
    learning rates ``lr[G]`` and losses ``loss[G]``, and the graphs by
    step count."""

    def __init__(self, mbs, device):
        self.slots: List[DeviceBatch] = [to_device_batch(mb, device)
                                         for mb in mbs]
        self.dev = [batch_leaves(b, False) for b in self.slots]
        self.pinned = [[torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        for t in leaves] for leaves in self.dev]
        g = len(mbs)
        self.lr_host = torch.empty(g, pin_memory=True)
        self.lr = torch.zeros(g, device=device)
        self.loss = torch.zeros(g, device=device)
        # step count -> (graph, its capture record)
        self.graphs = {}
        # the last copy out of the pinned buffers (they are refilled
        # only after it)
        self.copied = None

    def stage(self, mbs, lrs) -> None:
        """Fill the slots from host batches ``mbs`` and their learning
        rates, through the pinned buffers, once the card has finished
        reading them (a span ``dispatch.card_wait``); counts the bytes
        copied into them (``dispatch.stage_bytes``)."""
        if self.copied is not None:
            with span("dispatch.card_wait"):
                self.copied.synchronize()
        n_bytes = 0
        for mb, pins, devs in zip(mbs, self.pinned, self.dev):
            for x, p, d in zip(batch_leaves(mb, True), pins, devs):
                np.copyto(p.numpy(), x)
                d.copy_(p, non_blocking=True)
                n_bytes += x.nbytes
        count("dispatch.stage_bytes", n_bytes)
        self.lr_host.numpy()[: len(lrs)] = lrs
        self.lr.copy_(self.lr_host, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()

    def move_to_slot0(self, j: int):
        """Slot ``j``'s batch and learning rate into slot 0 (on the
        card, in stream order)."""
        for d0, dj in zip(self.dev[0], self.dev[j]):
            d0.copy_(dj)
        self.lr[0].copy_(self.lr[j])


class GroupedDispatch:
    """The grouped epoch loop of one `Trainer` (one rank, a replicated
    feature table). ``captures`` lists every capture: its step count,
    a digest of its shapes, its seconds, the kernel launches it recorded
    (by ``module.key``, as `cuda_build.launch_counts` names them) and the
    graph's replays so far."""

    def __init__(self, trainer, group: int):
        if group < 2:
            raise ValueError(f"grouped dispatch needs G >= 2, got {group}")
        self.tr = trainer
        self.G = group
        self.on_card = trainer.device.type == "cuda"
        self._buckets: "collections.OrderedDict[tuple, _Bucket]" = \
            collections.OrderedDict()
        self.captures: List[dict] = []

    # --- the card: capture and replay -----------------------------------

    def _bucket(self, key, mbs) -> _Bucket:
        b = self._buckets.get(key)
        if b is not None:
            self._buckets.move_to_end(key)
            return b
        if len(self._buckets) >= MAX_BUCKETS:
            _, old = self._buckets.popitem(last=False)
            # no replay of the evicted graphs may still run when their
            # buffers and pools are freed
            torch.cuda.synchronize(self.tr.device)
            print(f"cuda graph cache: dropped the least recently used "
                  f"shapes ({len(old.graphs)} graphs)", flush=True)
        b = _Bucket(mbs, self.tr.device)
        self._buckets[key] = b
        return b

    def _state(self):
        """The tensors a warm-up step changes: parameters and Adam's
        state."""
        tensors = [p.data for p in self.tr.net.parameters()]
        for st in self.tr.optimizer.state.values():
            tensors += [v for v in st.values() if torch.is_tensor(v)]
        return tensors

    def _capture(self, b: _Bucket, n_steps: int, key) -> None:
        """Warm up on a side stream, restore what it changed, and capture
        ``n_steps`` steps over slots ``0 .. n_steps - 1`` into a graph
        (a span ``dispatch.capture``: ``dispatch.capture_warmup``, then
        ``dispatch.capture_record``)."""
        with span("dispatch.capture") as whole:
            graph, rec = self._warm_and_record(b, n_steps, key)
        rec["seconds"] = whole.seconds
        b.graphs[n_steps] = graph, rec
        rec["live_graphs"] = self.live_graphs()
        self.captures.append(rec)
        print(f"cuda graph capture: {n_steps} steps, shapes {rec['key']}, "
              f"{rec['seconds']:.2f}s ({rec['live_graphs']} live graphs)",
              flush=True)

    def _warm_and_record(self, b: _Bucket, n_steps: int, key):
        """The capture's two parts: ``(graph, its record)``."""
        tr = self.tr
        had_state = len(tr.optimizer.state) > 0
        saved = [t.clone() for t in self._state()]
        gen_state = tr.generator.get_state()
        side = torch.cuda.Stream(tr.device)
        side.wait_stream(torch.cuda.current_stream(tr.device))
        with span("dispatch.capture_warmup"), torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                tr._step(b.slots[0])
        torch.cuda.current_stream(tr.device).wait_stream(side)
        with torch.no_grad():
            if had_state:
                for t, s in zip(self._state(), saved):
                    t.copy_(s)
            else:
                # Adam's state did not exist: a fresh one is all zeros
                for p, s in zip(tr.net.parameters(), saved):
                    p.data.copy_(s)
                for st in tr.optimizer.state.values():
                    for v in st.values():
                        if torch.is_tensor(v):
                            v.zero_()
        tr.generator.set_state(gen_state)
        before = collections.Counter(launch_counts("captured"))
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(tr.generator)
        lr_float = [g["lr"] for g in tr.optimizer.param_groups]
        try:
            with span("dispatch.capture_record"), torch.cuda.graph(graph):
                for i in range(n_steps):
                    for g in tr.optimizer.param_groups:
                        g["lr"] = b.lr[i]
                    b.loss[i].copy_(tr._step(b.slots[i]))
        finally:
            for g, lr in zip(tr.optimizer.param_groups, lr_float):
                g["lr"] = lr
        recorded = collections.Counter(launch_counts("captured"))
        recorded.subtract(before)
        return graph, {"steps": n_steps, "seconds": 0.0,
                       "key": f"{zlib.crc32(repr(key).encode()):08x}",
                       "launches": {k: v for k, v in recorded.items() if v},
                       "replays": 0}

    def _replay(self, b: _Bucket, n_steps: int, key, timed: list) -> None:
        """Replay the ``n_steps``-step graph of ``b`` (captured first if
        missing) between two CUDA events, which go to ``timed``."""
        if n_steps not in b.graphs:
            self._capture(b, n_steps, key)
        graph, rec = b.graphs[n_steps]
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        graph.replay()
        ev[1].record()
        timed.append(ev)
        rec["replays"] += 1

    def _run_group_on_card(self, mbs, n_valid, lrs, losses, timed):
        """Stage and replay one group; returns its spans
        ``(dispatch.stage, dispatch.replay)``."""
        key = group_key(mbs[0])
        if any(group_key(mb) != key for mb in mbs[1:]):
            raise ValueError("a group's batches differ in padded shapes: "
                             "re-pad them with unify_group")
        with span("dispatch.stage") as stage:
            b = self._bucket(key, mbs)
            b.stage(mbs, lrs)
        with span("dispatch.replay") as replay:
            if n_valid == self.G:
                self._replay(b, self.G, key, timed)
                losses.append(b.loss.clone())
            else:
                for j in range(n_valid):
                    if j:
                        b.move_to_slot0(j)
                    self._replay(b, 1, key, timed)
                    losses.append(b.loss[:1].clone())
        return stage, replay

    def replayed_launches(self) -> collections.Counter:
        """The kernel launches inside the replays so far, by
        ``module.key``: each graph's captured launches times its replays
        (a wrapper's own counter sees a capture once, in its module's
        ``captured``, and a replay never)."""
        out = collections.Counter()
        for rec in self.captures:
            for k, v in rec["launches"].items():
                out[k] += v * rec["replays"]
        return out

    def clear(self) -> None:
        """Drop every graph and static buffer (the state they captured
        was replaced)."""
        if self._buckets:
            torch.cuda.synchronize(self.tr.device)
        self._buckets.clear()

    def live_graphs(self) -> int:
        return sum(len(b.graphs) for b in self._buckets.values())

    # --- the epoch ------------------------------------------------------

    def train_epoch(self, train_nodes, epoch: int, rank_chunks=None,
                    keep_last_batch: bool = False):
        """One epoch in groups of G steps; returns its `EpochMetrics`.
        Each step's time is its group's time divided over the group's
        steps, capture seconds left out: on the card the interval
        between the ends of the group's replays and of the group before
        (CUDA events; the host runs a group or two ahead of the card),
        on the CPU the group's host time. The losses are read once, at
        the end. On the card the replays' device seconds (CUDA events
        around each ``graph.replay()``) go to the counter
        ``dispatch.replay_device_s``. The buckets sum the clock reads of
        the spans: ``pipeline.next`` waits; on the card the self time of
        ``dispatch.stage`` moves, and the self time of
        ``dispatch.replay`` (its captures left out) and every
        ``dispatch.card_wait`` execute; on the CPU ``train.to_device``
        moves and ``train.step`` and the loss read execute."""
        from gnn_tpu_torch.train.metrics import EpochMetrics
        tr = self.tr
        # the buckets, in ns
        n_sample = n_move = n_exec = n_capture = 0
        losses, times, shares, ends, timed = [], [], [], [], []
        n_caps = len(self.captures)
        last = None
        with span("train.epoch") as whole:
            if self.on_card:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            groups = iter(tr.pipeline.train_epoch_grouped(
                train_nodes, rank_chunks, epoch=epoch, group=self.G))
            while True:
                with span("pipeline.next") as nxt:
                    got = next(groups, None)
                n_sample += nxt.ns
                if got is None:
                    break
                mbs, n_valid = got
                shares += [tr.pipeline.skew_share(mb)
                           for mb in mbs[:n_valid]]
                if tr.attn_counts is not None:
                    for mb in mbs[:n_valid]:
                        tr.attn_counts.staged(mb)
                if self.on_card:
                    lrs = [tr._lr_at(tr.n_updates + j)
                           for j in range(n_valid)]
                    stage, replay = self._run_group_on_card(
                        mbs, n_valid, lrs, losses, timed)
                    tr.n_updates += n_valid
                    ends.append((torch.cuda.Event(enable_timing=True),
                                 n_valid, replay.child_ns / 1e9))
                    ends[-1][0].record()
                    # the stage's one child is its wait for the card, the
                    # replay's its captures
                    n_move += stage.ns - stage.child_ns
                    n_exec += replay.ns - replay.child_ns + stage.child_ns
                    n_capture += replay.child_ns
                else:
                    for mb in mbs[:n_valid]:
                        with span("train.to_device") as move:
                            batch = to_device_batch(mb, tr.device)
                        n_move += move.ns
                        with span("train.step") as step:
                            losses.append(tr.train_step(batch).reshape(1))
                        n_exec += step.ns
                    times += [(step.t1 - nxt.t1) / 1e9 / n_valid] * n_valid
                last = mbs[n_valid - 1]
            # one read of every loss (it waits for the last replay)
            with span("dispatch.card_wait") as wait:
                step_losses = (torch.cat(losses).cpu().tolist() if losses
                               else [])
                # and of what the replays counted on the card
                if tr.attn_counts is not None:
                    tr.attn_counts.epoch_end()
            n_exec += wait.ns
            prev = start if self.on_card else None
            for ev, n, cap in ends:
                dt = prev.elapsed_time(ev) / 1e3 - cap
                times += [max(dt, 0.0) / n] * n
                prev = ev
            if timed:
                count("dispatch.replay_device_s",
                      sum(a.elapsed_time(b) for a, b in timed) / 1e3)
        tr.last_batch = (to_device_batch(last, tr.device)
                         if keep_last_batch and last is not None else None)
        caps = self.captures[n_caps:]
        return EpochMetrics(
            epoch=epoch,
            train_loss=(float(np.mean(step_losses)) if step_losses
                        else float("nan")),
            valid_loss=float("nan"), valid_f1=float("nan"),
            data_movement_time=n_move / 1e9, execution_time=n_exec / 1e9,
            sample_wait_time=n_sample / 1e9, total_time=whole.seconds,
            skew_share=float(np.mean(shares)) if shares else float("nan"),
            step_losses=step_losses, step_times=times,
            captures=len(caps), capture_time=n_capture / 1e9)
