"""Training orchestration on one device: the counterpart of
`gnn_tpu.train.trainer`.

Each step matches the JAX package's recipe (reference ``main.py``):
gather the input features on the device, rebuild the batch's resident
adjacencies, forward, masked BCE/CE loss, backward, global-norm clip
``min(1, 5 / (norm + 1e-6))``, Adam (optax's and PyTorch's Adam apply
the same formula), with the optional linear warmup ``lr/100 -> lr`` over
``lr_warmup`` updates. ``fit`` runs a val pass per epoch, keeps the best
model at a +1e-2 improvement and saves a rolling latest checkpoint.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from gnn_tpu_torch.device import resolve_device
from gnn_tpu_torch.parallel.feature_cache import ReplicatedFeatures
from gnn_tpu_torch.train.evalloop import EvalMixin
from gnn_tpu_torch.train.loss import masked_loss
from gnn_tpu_torch.train.metrics import EpochMetrics
from gnn_tpu_torch.train.stepfns import (clip_by_global_norm, prepare_adjs,
                                         to_device_batch)


class Trainer(EvalMixin):
    """End-to-end trainer mirroring ``main.py``'s behavior on one
    device (``cuda`` unless the caller passes ``device="cpu"``)."""

    def __init__(self, net, pipeline, feats: np.ndarray, lr: float = 0.01,
                 sigmoid_loss: bool = True, seed: int = 0,
                 feature_source=None, resident_graph=None,
                 hot_dense=None, lr_warmup: int = 0,
                 grad_clip: float = 5.0, device="cuda"):
        self.device = resolve_device(device)
        self.net = net.to(self.device)
        self.pipeline = pipeline
        self.feature_source = (feature_source if feature_source is not None
                               else ReplicatedFeatures(feats,
                                                       device=self.device))
        self.sigmoid_loss = sigmoid_loss
        self.lr = lr
        self.lr_warmup = int(lr_warmup)
        self.grad_clip = grad_clip
        self.optimizer = torch.optim.Adam(self.net.parameters(),
                                          lr=self._lr_at(0))
        self.n_updates = 0
        # resident-graph mode: slot table, rank-1 factors and hot blocks
        # live on the device; batches carry ResidentLayerRefs. Hot format
        # (``hot_dense=(dense, dense_t)``): only the blocks live there;
        # batches carry host-packed HotDenseAdj layers
        self.agg_state = None
        if resident_graph is not None:
            from gnn_tpu_torch.ops.residentgraph import ResidentGraph
            self.agg_state = ResidentGraph.from_host(resident_graph,
                                                     self.device)
        elif hot_dense is not None:
            self.agg_state = tuple(torch.as_tensor(d).to(self.device)
                                   for d in hot_dense)
        self._seed = seed
        # dropout draws from this generator, reseeded from (seed, epoch)
        self.generator = torch.Generator(device=self.device)
        self.best_val = -1.0
        self.best_params = None
        self.history: List[EpochMetrics] = []

    def _lr_at(self, count: int) -> float:
        """optax.linear_schedule(lr/100, lr, warmup) at update ``count``."""
        if self.lr_warmup <= 0:
            return self.lr
        frac = min(count, self.lr_warmup) / self.lr_warmup
        return self.lr / 100.0 + (self.lr - self.lr / 100.0) * frac

    def train_step(self, batch) -> torch.Tensor:
        """One optimizer step on a device batch; returns the loss."""
        x = self.feature_source.gather(batch.input_nodes, batch.input_mask)
        adjs = prepare_adjs(batch, self.agg_state)
        out = self.net(x, adjs, batch.sampled_nodes,
                       generator=self.generator)
        loss = masked_loss(out, batch.labels, batch.label_mask,
                           self.sigmoid_loss)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm(self.net.parameters(), self.grad_clip)
        for group in self.optimizer.param_groups:
            group["lr"] = self._lr_at(self.n_updates)
        self.optimizer.step()
        self.n_updates += 1
        return loss.detach()

    def train_epoch(self, train_nodes, epoch: int,
                    rank_chunks=None) -> EpochMetrics:
        # epoch-deterministic randomness (sampling seeds, dropout)
        self.generator.manual_seed(self._seed * 1_000_003 + epoch)
        self.net.train()
        t_sample = t_move = t_exec = 0.0
        losses, times = [], []
        t_start = t0 = time.perf_counter()
        for mb in self.pipeline.train_epoch(train_nodes, rank_chunks,
                                            epoch=epoch):
            t1 = time.perf_counter()
            t_sample += t1 - t0
            batch = to_device_batch(mb, self.device)
            t2 = time.perf_counter()
            t_move += t2 - t1
            loss = float(self.train_step(batch))   # waits for the device
            t0 = time.perf_counter()
            t_exec += t0 - t2
            losses.append(loss)
            times.append(t0 - t1)
        return EpochMetrics(
            epoch=epoch,
            train_loss=float(np.mean(losses)) if losses else float("nan"),
            valid_loss=float("nan"), valid_f1=float("nan"),
            data_movement_time=t_move, execution_time=t_exec,
            sample_wait_time=t_sample,
            total_time=time.perf_counter() - t_start,
            step_losses=losses, step_times=times)

    def fit(self, train_nodes, valid_nodes, epochs: int, rank_chunks=None,
            log: bool = True, checkpoint_dir: Optional[str] = None,
            metrics=None):
        """Train for ``epochs`` epochs with a val pass after each."""
        from gnn_tpu_torch.train.checkpoint import save_checkpoint
        from gnn_tpu_torch.train.metrics import device_memory_stats
        for epoch in range(epochs):
            m = self.train_epoch(train_nodes, epoch, rank_chunks)
            f1, vloss = self.evaluate(valid_nodes, 128, "val")
            m.valid_f1, m.valid_loss = f1, vloss
            self.history.append(m)
            if log:
                print(m.format(self.pipeline.cfg.scale_factor), flush=True)
            if metrics is not None:
                metrics.log(epoch=epoch, train_loss=m.train_loss,
                            valid_loss=m.valid_loss, valid_f1=m.valid_f1,
                            sample_wait_s=m.sample_wait_time,
                            data_movement_s=m.data_movement_time,
                            execution_s=m.execution_time,
                            total_s=m.total_time,
                            step_losses=m.step_losses,
                            step_times=m.step_times,
                            device_memory=device_memory_stats())
            # best-model selection at +1e-2 improvement (main.py:197-199)
            if f1 > self.best_val + 1e-2:
                self.best_val = f1
                self.best_params = {k: v.detach().clone() for k, v in
                                    self.net.state_dict().items()}
                if checkpoint_dir is not None:
                    save_checkpoint(checkpoint_dir, self.best_params,
                                    step=epoch,
                                    opt_state=self.optimizer.state_dict(),
                                    best_val=self.best_val)
            if checkpoint_dir is not None:
                # rolling crash-recovery checkpoint (next epoch)
                save_checkpoint(checkpoint_dir, self.net.state_dict(),
                                step=epoch + 1,
                                opt_state=self.optimizer.state_dict(),
                                name="latest", best_val=self.best_val)
        return self.history
