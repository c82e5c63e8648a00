"""Training orchestration, on one device or as one of several
data-parallel ranks: the counterpart of `gnn_tpu.train.trainer`.

Each step matches the JAX package's recipe (reference ``main.py``):
gather the input features on the device, rebuild the batch's resident
adjacencies, forward, masked BCE/CE loss, backward, global-norm clip
``min(1, 5 / (norm + 1e-6))`` of this rank's gradient, then the clipped
gradients SUMMED across the ranks (one ``all_reduce``; not DDP, which
averages, and before any clip), Adam (optax's and PyTorch's Adam apply
the same formula), with the optional linear warmup ``lr/100 -> lr`` over
``lr_warmup`` updates. Every rank then holds the same parameters; a
step's logged loss is the mean across ranks. ``fit`` runs a val pass per
epoch, keeps the best model at a +1e-2 improvement and saves a rolling
latest checkpoint; it resumes from that checkpoint, runs the live
locality scale-factor tuner, the op-timing buckets and a profiler trace
of the second epoch. Across ranks, rank 0 takes each decision (the val
F1 that picks the best model, the tuner's factor) and broadcasts it, and
rank 0 alone writes checkpoints, metrics and traces.

On the ``data x part`` grid (``resident_parts`` P > 1) the resident
state is this part's shard (`gnn_tpu_torch.parallel.shardedresident`)
and the part ranks of a data group train on one batch, with the
dropout masks of their data rank. The card's kernels sum in a
run-dependent order and lite mode computes the cold residual on every
part, so the parts' gradients differ in their last bits: the step sums
the clipped gradients over the whole grid and scales them by ``1 / P``
(the sum over data ranks of the mean over part ranks), which leaves
every rank with the same parameters and equals the JAX step, whose
parts agree bit for bit, wherever the parts agree. The logged loss is
the mean over the grid.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
from typing import List, Optional

import numpy as np
import torch

from gnn_tpu_torch.device import resolve_device
from gnn_tpu_torch.parallel.dist import (DistContext, broadcast_from_main,
                                         part_bytes)
from gnn_tpu_torch.parallel.feature_cache import ReplicatedFeatures
from gnn_tpu_torch.train.evalloop import EvalMixin
from gnn_tpu_torch.train.loss import masked_loss
from gnn_tpu_torch.train.metrics import EpochMetrics
from gnn_tpu_torch.train.optiming import OpTimingMixin
from gnn_tpu_torch.train.stepfns import (clip_by_global_norm, prepare_adjs,
                                         sum_gradients_, to_device_batch)
from gnn_tpu_torch.utils.timing import RECORDER, span, spanned


class Trainer(EvalMixin, OpTimingMixin):
    """End-to-end trainer mirroring ``main.py``'s behavior on one device
    (``cuda`` unless the caller passes ``device="cpu"``) or, with
    ``dist``, as one rank of a data-parallel group on ``dist.device``
    (the pipeline and the feature source are that rank's). With
    ``resident_parts`` P > 1, one rank of a ``data x P`` grid
    (``dist.parts == P``): the resident graph (a `build_resident_graph`
    dict whose blocks are whole or this part's column shards) is sharded
    over the part group, and the pipeline is the data rank's."""

    @spanned("setup.trainer")
    def __init__(self, net, pipeline, feats: np.ndarray, lr: float = 0.01,
                 sigmoid_loss: bool = True, seed: int = 0,
                 feature_source=None, resident_graph=None,
                 hot_dense=None, lr_warmup: int = 0,
                 grad_clip: float = 5.0, device="cuda",
                 dist: Optional[DistContext] = None,
                 resident_parts: int = 0, steps_per_dispatch: int = 1):
        if dist is None:
            dist = DistContext(device=resolve_device(device))
        parts = max(int(resident_parts), 1)
        if parts > 1 and resident_graph is None:
            raise ValueError("resident_parts needs resident_graph")
        if dist.parts != parts:
            raise ValueError(f"resident_parts={resident_parts} needs a grid "
                             f"of {parts} part ranks (got {dist.parts}); "
                             f"join with init_dist(..., parts={parts})")
        if parts > 1 and (pipeline.world_size, pipeline.rank) != (
                dist.dp, dist.data_rank):
            raise ValueError("on a grid the pipeline is the data rank's: "
                             f"rank {dist.data_rank} of {dist.dp}")
        self.dist = dist
        self.device = dist.device
        self.net = net.to(self.device)
        self.pipeline = pipeline
        self.feature_source = (feature_source if feature_source is not None
                               else ReplicatedFeatures(feats,
                                                       device=self.device))
        self.n_feats = feats.shape[1]
        self.sigmoid_loss = sigmoid_loss
        self.lr = lr
        self.lr_warmup = int(lr_warmup)
        self.grad_clip = grad_clip
        self.steps_per_dispatch = max(int(steps_per_dispatch), 1)
        from gnn_tpu_torch.models.gat import AttentionCounts
        # attention's counters (None: the net has no attention)
        self.attn_counts = AttentionCounts.of(self.net, sharded=parts > 1)
        if self.steps_per_dispatch > 1:
            from gnn_tpu_torch.train.dispatch import unported
            # the format is the sampler's: the coo format has neither a
            # resident graph nor hot blocks
            why = unported(
                adj_format=pipeline.cfg.adj_format,
                attention=self.attn_counts is not None,
                ranks=dist.world_size,
                replicated=isinstance(self.feature_source,
                                      ReplicatedFeatures))
            if why:
                raise NotImplementedError(
                    "steps_per_dispatch > 1 is not ported for "
                    + ", ".join(why) + " (ROADMAP.md)")
        # grouped dispatch on the card captures Adam's step into a CUDA
        # graph, which needs its state and step count on the device
        self._capturable = (self.steps_per_dispatch > 1
                            and self.device.type == "cuda")
        self.optimizer = torch.optim.Adam(self.net.parameters(),
                                          lr=self._lr_at(0),
                                          capturable=self._capturable)
        self.n_updates = 0
        # resident-graph mode: slot table, rank-1 factors and hot blocks
        # live on the device; batches carry ResidentLayerRefs. Hot format
        # (``hot_dense=(dense, dense_t)``): only the blocks live there;
        # batches carry host-packed HotDenseAdj layers
        self.agg_state = None
        if parts > 1:
            # full expansion (the pipeline's resident_ship_cold=False)
            # reads row-range CSR shards; lite mode needs no device CSR
            from gnn_tpu_torch.parallel.shardedresident import \
                shard_resident_state
            self.agg_state = shard_resident_state(
                resident_graph, dist.part, self.device,
                ship_csr=not pipeline.cfg.resident_ship_cold)
        elif resident_graph is not None:
            from gnn_tpu_torch.ops.residentgraph import ResidentGraph
            self.agg_state = ResidentGraph.from_host(resident_graph,
                                                     self.device)
        elif hot_dense is not None:
            self.agg_state = tuple(torch.as_tensor(d).to(self.device)
                                   for d in hot_dense)
        self._seed = seed
        # dropout draws from this generator, reseeded from (seed, epoch,
        # data rank): the data ranks draw different masks, as the JAX
        # package folds in the replica index, and the part ranks of one
        # data rank the same
        self.generator = torch.Generator(device=self.device)
        self._dispatch = None
        if self.steps_per_dispatch > 1:
            from gnn_tpu_torch.train.dispatch import GroupedDispatch
            self._dispatch = GroupedDispatch(self, self.steps_per_dispatch)
        self.best_val = -1.0
        self.best_params = None
        self.history: List[EpochMetrics] = []
        self.test_batches = 0

    def _lr_at(self, count: int) -> float:
        """optax.linear_schedule(lr/100, lr, warmup) at update ``count``."""
        if self.lr_warmup <= 0:
            return self.lr
        frac = min(count, self.lr_warmup) / self.lr_warmup
        return self.lr / 100.0 + (self.lr - self.lr / 100.0) * frac

    def train_step(self, batch) -> torch.Tensor:
        """One optimizer step on a device batch at the lr of update
        ``n_updates``; returns the loss (across ranks, their mean)."""
        for group in self.optimizer.param_groups:
            group["lr"] = self._lr_at(self.n_updates)
        loss = self._step(batch)
        self.n_updates += 1
        return loss

    def _step(self, batch) -> torch.Tensor:
        """Forward, loss, backward, clip, the sum across ranks and Adam at
        the param groups' lr; no host sync (grouped dispatch captures it
        into a CUDA graph)."""
        x = self.feature_source.gather(batch.input_nodes, batch.input_mask,
                                       batch.feat_plan)
        adjs = prepare_adjs(batch, self.agg_state)
        out = self.net(x, adjs, batch.sampled_nodes,
                       generator=self.generator)
        loss = masked_loss(out, batch.labels, batch.label_mask,
                           self.sigmoid_loss)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm(self.net.parameters(), self.grad_clip)
        loss = loss.detach()
        if self.dist.world_size > 1:
            # the loss rides in the gradients' buffer: one collective
            total = loss.reshape(1).clone()
            sum_gradients_(self.net.parameters(), [total], self.dist)
            loss = total[0] / self.dist.dp
        self.optimizer.step()
        return loss

    def state_bytes(self) -> dict:
        """Bytes on the device of the resident graph's tensors (by name)
        and of the feature source's table or buffer (``features``)."""
        g = self.agg_state
        out = g.state_bytes() if hasattr(g, "state_bytes") else {}
        fs = self.feature_source
        table = getattr(fs, "table", None)
        out["features"] = (table if table is not None else fs.buffer).nbytes
        return out

    def param_digest(self) -> str:
        """SHA-1 of the parameters' bytes (ranks must agree bit for
        bit)."""
        h = hashlib.sha1()
        for name, v in self.net.state_dict().items():
            h.update(name.encode())
            h.update(v.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
        return h.hexdigest()

    def train_epoch(self, train_nodes, epoch: int, rank_chunks=None,
                    keep_last_batch: bool = False) -> EpochMetrics:
        """One epoch of training steps, in groups of
        ``steps_per_dispatch`` (`gnn_tpu_torch.train.dispatch`) when it is
        above 1. ``keep_last_batch`` keeps the epoch's last device batch
        as ``self.last_batch`` (the op-timing probe's operands); otherwise
        ``last_batch`` is None."""
        # epoch-deterministic randomness (sampling seeds, dropout)
        RECORDER.epoch = epoch
        self.generator.manual_seed(self._seed * 1_000_003 + epoch
                                   + (self.dist.data_rank << 32))
        self.net.train()
        if self._dispatch is not None:
            return self._dispatch.train_epoch(train_nodes, epoch,
                                              rank_chunks, keep_last_batch)
        # the buckets sum the spans' clock reads (ns)
        n_sample = n_move = n_exec = 0
        losses, times, shares = [], [], []
        bytes_before = sum(part_bytes.values())
        with span("train.epoch") as whole:
            batches = iter(self.pipeline.train_epoch(
                train_nodes, rank_chunks, epoch=epoch))
            while True:
                with span("pipeline.next") as nxt:
                    mb = next(batches, None)
                n_sample += nxt.ns
                if mb is None:
                    break
                shares.append(self.pipeline.skew_share(mb))
                if self.attn_counts is not None:
                    self.attn_counts.staged(mb)
                with span("train.to_device") as move:
                    batch = to_device_batch(mb, self.device,
                                            self.feature_source)
                n_move += move.ns
                with span("train.step") as step:
                    # waits for the device
                    losses.append(float(self.train_step(batch)))
                n_exec += step.ns
                times.append((step.t1 - nxt.t1) / 1e9)
            # what the epoch's forwards counted on the device (its steps
            # waited for the device already)
            if self.attn_counts is not None:
                self.attn_counts.epoch_end()
        self.last_batch = batch if keep_last_batch and losses else None
        return EpochMetrics(
            epoch=epoch,
            train_loss=float(np.mean(losses)) if losses else float("nan"),
            valid_loss=float("nan"), valid_f1=float("nan"),
            data_movement_time=n_move / 1e9, execution_time=n_exec / 1e9,
            sample_wait_time=n_sample / 1e9, total_time=whole.seconds,
            skew_share=float(np.mean(shares)) if shares else float("nan"),
            part_bytes=sum(part_bytes.values()) - bytes_before,
            step_losses=losses, step_times=times)

    def fit(self, train_nodes, valid_nodes, epochs: int, rank_chunks=None,
            log: bool = True, checkpoint_dir: Optional[str] = None,
            locality_tuner: bool = False, metrics=None,
            profile_dir: Optional[str] = None, op_timing: bool = False,
            resume: bool = False):
        """Train for ``epochs`` epochs with a val pass after each.
        ``resume=True`` picks up from ``checkpoint_dir``'s latest
        checkpoint (params, optimizer state, update count, next epoch,
        best-val watermark, and the best params from the best
        checkpoint); every epoch's randomness derives from (seed, epoch),
        so the remaining epochs replay the uninterrupted run's.
        ``locality_tuner`` feeds each epoch after the first trained one to
        a `ScaleFactorTuner`; ``op_timing`` fills the spmm and
        communication buckets; ``profile_dir`` gets a trace of epoch 1.
        Across ranks, every rank calls ``fit`` alike: rank 0 alone logs,
        writes ``metrics`` (pass None elsewhere), checkpoints (a barrier
        follows each write) and traces, and its val F1 and tuner factor
        hold on every rank; each epoch's record carries the parameters'
        digest."""
        from gnn_tpu_torch.train.checkpoint import (checkpoint_path,
                                                    load_checkpoint,
                                                    save_checkpoint)
        from gnn_tpu_torch.train.metrics import (ScaleFactorTuner,
                                                 device_memory_stats)
        main = self.dist.is_main
        log = log and main
        tuner = (ScaleFactorTuner(self.pipeline.cfg.scale_factor)
                 if locality_tuner and main else None)
        start_epoch = 0
        if resume and checkpoint_dir is not None and os.path.exists(
                checkpoint_path(checkpoint_dir, "latest")):
            start_epoch = self.restore(checkpoint_dir)
            # the final test sweep runs the best params (main.py:218-235),
            # so they must survive the resume too
            if os.path.exists(checkpoint_path(checkpoint_dir, "best")):
                bp, _, _, bv, _ = load_checkpoint(checkpoint_dir, "best")
                self.best_params = {k: v.to(self.device)
                                    for k, v in bp.items()}
                self.best_val = max(self.best_val, bv)
            if log:
                print(f"resumed from {checkpoint_dir} at epoch "
                      f"{start_epoch} (best val F1 {self.best_val:.3f})",
                      flush=True)
        # nothing is primed past the last epoch
        self.pipeline.final_epoch = epochs - 1
        for epoch in range(start_epoch, epochs):
            # profile the second epoch (the first pays one-time set-up)
            with (profile_trace(profile_dir, self.device, epoch)
                  if profile_dir is not None and epoch == 1 and main
                  else contextlib.nullcontext()):
                m = self.train_epoch(train_nodes, epoch, rank_chunks,
                                     keep_last_batch=op_timing)
            if op_timing:
                with span("fit.op_timing"):
                    fwd, bwd, comm = self.measure_op_buckets(
                        self.last_batch)
                self.last_batch = None
                steps = len(m.step_losses)
                m.spmm_fwd_time = fwd * steps
                m.spmm_bwd_time = bwd * steps
                m.communication_time = comm * steps
            f1, vloss = self.evaluate(valid_nodes, 128, "val")
            # live scale-factor controller (reference main.py:200-212);
            # the first trained epoch pays one-time set-up in its
            # execution bucket, which would read as a tiny ratio and stop
            # the controller, so it is skipped
            scale_factor = new_sf = self.pipeline.cfg.scale_factor
            if tuner is not None and epoch > start_epoch:
                new_sf = tuner.update(m.data_movement_time,
                                      m.execution_time)
            f1, vloss, new_sf = broadcast_from_main([f1, vloss, new_sf],
                                                    self.dist)
            m.valid_f1, m.valid_loss = f1, vloss
            if self.dist.world_size > 1:
                m.param_digest = self.param_digest()
            self.history.append(m)
            if new_sf != self.pipeline.cfg.scale_factor:
                self.pipeline.cfg = dataclasses.replace(
                    self.pipeline.cfg, scale_factor=new_sf)
            # best-model selection at +1e-2 improvement (main.py:197-199)
            if f1 > self.best_val + 1e-2:
                with span("fit.best_copy"):
                    self.best_val = f1
                    self.best_params = {k: v.detach().clone() for k, v in
                                        self.net.state_dict().items()}
                    if checkpoint_dir is not None:
                        if main:
                            save_checkpoint(
                                checkpoint_dir, self.best_params,
                                step=epoch, opt_state=self._opt_state(),
                                n_updates=self.n_updates,
                                best_val=self.best_val)
                        self.dist.barrier()
            if checkpoint_dir is not None:
                # rolling crash-recovery checkpoint (next epoch)
                self.save(checkpoint_dir, step=epoch + 1)
            # the epoch's spans and counters, its checkpoint's included
            totals = RECORDER.totals(epoch)
            m.spans, m.counts = totals["spans"], totals["counts"]
            with span("fit.log"):
                if log:
                    print(m.format(scale_factor), flush=True)
                if metrics is not None:
                    metrics.log(epoch=epoch, train_loss=m.train_loss,
                                valid_loss=m.valid_loss,
                                valid_f1=m.valid_f1,
                                sample_wait_s=m.sample_wait_time,
                                data_movement_s=m.data_movement_time,
                                execution_s=m.execution_time,
                                spmm_fwd_s=m.spmm_fwd_time,
                                spmm_bwd_s=m.spmm_bwd_time,
                                communication_s=m.communication_time,
                                scale_factor=scale_factor,
                                skew_share=m.skew_share,
                                total_s=m.total_time,
                                step_losses=m.step_losses,
                                step_times=m.step_times,
                                captures=m.captures,
                                capture_s=m.capture_time,
                                device_memory=device_memory_stats(),
                                spans=m.spans, counts=m.counts)
        return self.history

    @spanned("checkpoint.save")
    def save(self, ckpt_dir: str, step: int = 0):
        """The latest checkpoint, the full training state: params,
        optimizer state, update count, ``step`` and the best-val
        watermark. Rank 0 writes it (every rank holds the same state);
        the ranks meet at a barrier after the write. Returns its path."""
        from gnn_tpu_torch.train.checkpoint import (checkpoint_path,
                                                    save_checkpoint)
        if self.dist.is_main:
            save_checkpoint(ckpt_dir, self.net.state_dict(), step=step,
                            opt_state=self._opt_state(),
                            n_updates=self.n_updates, name="latest",
                            best_val=self.best_val)
        self.dist.barrier()
        return checkpoint_path(ckpt_dir, "latest")

    def restore(self, ckpt_dir: str) -> int:
        """Load params, optimizer state, update count and the best-val
        watermark from the latest checkpoint; returns its step."""
        from gnn_tpu_torch.train.checkpoint import load_checkpoint
        params, step, opt_state, best_val, n_updates = load_checkpoint(
            ckpt_dir, "latest")
        self.net.load_state_dict(params)
        if opt_state is not None:
            self.optimizer.load_state_dict(opt_state)
            if self._capturable:
                for group in self.optimizer.param_groups:
                    group["capturable"] = True
                for st in self.optimizer.state.values():
                    st["step"] = st["step"].to(self.device)
            self.n_updates = n_updates
            if self._dispatch is not None:
                # captured graphs read the replaced state tensors
                self._dispatch.clear()
        self.best_val = max(self.best_val, best_val)
        return step

    def _opt_state(self) -> dict:
        """Adam's state dict in the eager layout whatever the dispatch
        (``capturable`` off, each step count a CPU tensor), so a
        checkpoint resumes at any ``steps_per_dispatch``."""
        sd = self.optimizer.state_dict()
        if not self._capturable:
            return sd
        return {"state": {k: {n: v.detach().cpu() if n == "step" else v
                              for n, v in st.items()}
                          for k, st in sd["state"].items()},
                "param_groups": [dict(g, capturable=False)
                                 for g in sd["param_groups"]]}



@contextlib.contextmanager
def profile_trace(profile_dir: str, device: torch.device, epoch: int):
    """``torch.profiler`` over the body, CPU activity and, on the card,
    CUDA activity; writes a Chrome trace ``trace_epoch{epoch}.json`` into
    ``profile_dir``. On the card a trace without CUDA events (CUPTI gave
    none) raises instead of being written."""
    from torch.profiler import ProfilerActivity, profile
    on_card = device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if on_card:
            torch.cuda.synchronize()
    if on_card and not any(
            e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events()):
        raise RuntimeError("torch.profiler recorded no CUDA activity "
                           "(CUPTI); no trace written")
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir,
                                          f"trace_epoch{epoch}.json"))
