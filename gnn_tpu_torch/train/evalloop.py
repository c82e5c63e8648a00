"""Evaluation: val batches and the full-sweep test (reference
``main.py:178-199, 217-241``), the single-device part of
`gnn_tpu.train.evalloop`. The test sweep runs with the BEST params."""
from __future__ import annotations

import torch

from gnn_tpu_torch.train.loss import calc_f1, masked_loss, predict_proba
from gnn_tpu_torch.train.stepfns import prepare_adjs, to_device_batch


class EvalMixin:
    """Evaluation methods of `Trainer` (reads Trainer state only)."""

    @torch.no_grad()
    def evaluate(self, target_nodes, batch_size: int = 128,
                 mode: str = "val"):
        """(micro-F1 weighted by valid rows, mean loss) over the eval
        batches."""
        was_training = self.net.training
        self.net.eval()
        total_f1 = 0.0
        total_n = 0
        total_loss = 0.0
        n_batches = 0
        try:
            for mb in self.pipeline.eval_batches(target_nodes, batch_size,
                                                 mode):
                batch = to_device_batch(mb, self.device)
                x = self.feature_source.gather(batch.input_nodes,
                                               batch.input_mask)
                adjs = prepare_adjs(batch, self.agg_state)
                out = self.net(x, adjs, batch.sampled_nodes)
                loss = masked_loss(out, batch.labels, batch.label_mask,
                                   self.sigmoid_loss)
                proba = predict_proba(out, self.sigmoid_loss).cpu().numpy()
                labels = mb.labels
                mask = mb.label_mask.astype(bool)
                f1_mic, _ = calc_f1(labels[mask],
                                    proba[: labels.shape[0]][mask],
                                    self.sigmoid_loss)
                n = int(mask.sum())
                total_f1 += f1_mic * n
                total_n += n
                total_loss += float(loss)
                n_batches += 1
        finally:
            self.net.train(was_training)
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
