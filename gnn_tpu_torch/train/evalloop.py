"""Evaluation: val batches and the full-sweep test (reference
``main.py:178-199, 217-241``), the counterpart of
`gnn_tpu.train.evalloop`. The test sweep runs with the BEST params.

The val pass is one batch, the same on every rank (drawn from the
shared stream, skewed as rank 0's), with its features gathered on the
host path; on the ``data x part`` grid, where no rank holds the whole
state, every rank runs it through the training path's feature gather
and the sharded forward. The test sweep runs sharded over the data
ranks: each evaluates its share of the batches
(`BatchPipeline.eval_batches_sharded`) through the training path's
feature gather, skips fillers, and one ``all_reduce`` over the data
ranks sums ``(f1 * n, n, loss, batches)`` (the part ranks of a data
rank evaluate the same batches in lockstep); the F1 stays the
reference's per-batch micro-F1 weighted by valid rows
(``main.py:226-241``)."""
from __future__ import annotations

import torch

from gnn_tpu_torch.parallel.dist import sum_across_ranks
from gnn_tpu_torch.train.loss import calc_f1, masked_loss, predict_proba
from gnn_tpu_torch.train.stepfns import prepare_adjs, to_device_batch
from gnn_tpu_torch.utils.timing import span


class EvalMixin:
    """Evaluation methods of `Trainer` (reads Trainer state only)."""

    @torch.no_grad()
    def evaluate(self, target_nodes, batch_size: int = 128,
                 mode: str = "val"):
        """(micro-F1 weighted by valid rows, mean loss) over the eval
        batches: ``val`` on every rank alike, ``test`` sharded over the
        ranks. Sets ``test_batches``, the batches this rank evaluated in
        the last test sweep. A span ``eval.val`` (``eval.test``):
        ``eval.sample`` draws or waits for each batch, ``eval.forward``
        gathers, runs the model and reads the probabilities back,
        ``eval.f1`` scores them."""
        was_training = self.net.training
        self.net.eval()
        total_f1 = 0.0
        total_n = 0
        total_loss = 0.0
        n_batches = 0
        src = self.feature_source
        try:
            with span(f"eval.{'val' if mode == 'val' else 'test'}"):
                batches = iter(self.pipeline.eval_batches(
                    target_nodes, batch_size, mode))
                while True:
                    with span("eval.sample"):
                        mb = next(batches, None)
                    if mb is None:
                        break
                    mask = mb.label_mask.astype(bool)
                    with span("eval.forward"):
                        if mode == "val" and self.dist.parts == 1:
                            batch = to_device_batch(mb, self.device)
                            x = src.host_gather(mb.input_nodes,
                                                mb.input_mask)
                        else:
                            # every rank gathers, fillers too: the
                            # cache's exchange needs all of them
                            batch = to_device_batch(mb, self.device, src)
                            x = src.gather(batch.input_nodes,
                                           batch.input_mask,
                                           batch.feat_plan)
                        if not mask.any():
                            continue
                        adjs = prepare_adjs(batch, self.agg_state)
                        out = self.net(x, adjs, batch.sampled_nodes)
                        loss = float(masked_loss(out, batch.labels,
                                                 batch.label_mask,
                                                 self.sigmoid_loss))
                        proba = predict_proba(
                            out, self.sigmoid_loss).cpu().numpy()
                    with span("eval.f1"):
                        labels = mb.labels
                        f1_mic, _ = calc_f1(labels[mask],
                                            proba[: labels.shape[0]][mask],
                                            self.sigmoid_loss)
                    n = int(mask.sum())
                    total_f1 += f1_mic * n
                    total_n += n
                    total_loss += loss
                    n_batches += 1
        finally:
            self.net.train(was_training)
        if mode != "val":
            self.test_batches = n_batches
            total_f1, total_n, total_loss, n_batches = sum_across_ranks(
                [total_f1, total_n, total_loss, n_batches],
                self.dist.data_view())
        return (total_f1 / max(total_n, 1),
                total_loss / max(n_batches, 1))

    def test(self, test_nodes, batch_size: int = 128,
             use_best: bool = True):
        """Full-sweep weighted micro-F1, evaluated with the best params
        (the reference intended this but ran the last model,
        ``main.py:235``)."""
        if use_best and self.best_params is not None:
            saved = {k: v.detach().clone()
                     for k, v in self.net.state_dict().items()}
            self.net.load_state_dict(self.best_params)
            try:
                f1, _ = self.evaluate(test_nodes, batch_size, "test")
            finally:
                self.net.load_state_dict(saved)
            return f1
        f1, _ = self.evaluate(test_nodes, batch_size, "test")
        return f1
