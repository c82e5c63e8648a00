"""Loss and metrics (reference ``utils.py:129-149``): the counterpart of
`gnn_tpu.train.loss`, with padding masks so padded rows contribute
nothing. ``calc_f1`` is computed in numpy (the same micro/macro F1 as
scikit-learn's ``f1_score``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def masked_loss(preds: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, sigmoid_loss: bool) -> torch.Tensor:
    """sigmoid: BCE-with-logits summed over classes, mean over valid
    rows; softmax: cross-entropy with (one-hot) targets, mean over valid
    rows."""
    n_valid = mask.sum().clamp_min(1.0)
    w = mask / n_valid
    if sigmoid_loss:
        per_elt = (preds.clamp_min(0) - preds * labels
                   + torch.log1p(torch.exp(-preds.abs())))
        return (per_elt * w[:, None]).sum()
    logp = F.log_softmax(preds, dim=1)
    ce = -(labels * logp).sum(dim=1)
    return (ce * w).sum()


def _f1(tp, fp, fn):
    den = 2 * tp + fp + fn
    return np.where(den > 0, 2 * tp / np.maximum(den, 1), 0.0)


def calc_f1(y_true: np.ndarray, y_pred: np.ndarray, is_sigmoid: bool):
    """(micro, macro) F1: sigmoid thresholds at 0.5 (multi-label, macro
    over all classes); softmax argmaxes both sides (multi-class, macro
    over the labels present in either)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if is_sigmoid:
        t = y_true > 0
        p = y_pred > 0.5
        tp = (t & p).sum(axis=0).astype(np.float64)
        fp = (~t & p).sum(axis=0).astype(np.float64)
        fn = (t & ~p).sum(axis=0).astype(np.float64)
    else:
        t = np.argmax(y_true, axis=1)
        p = np.argmax(y_pred, axis=1)
        labels = np.union1d(t, p)
        tp = np.array([np.sum((t == c) & (p == c)) for c in labels],
                      np.float64)
        fp = np.array([np.sum((t != c) & (p == c)) for c in labels],
                      np.float64)
        fn = np.array([np.sum((t == c) & (p != c)) for c in labels],
                      np.float64)
    micro = float(_f1(tp.sum(), fp.sum(), fn.sum()))
    macro = float(np.mean(_f1(tp, fp, fn))) if len(tp) else 0.0
    return micro, macro


def predict_proba(logits: torch.Tensor, sigmoid_loss: bool) -> torch.Tensor:
    """``main.py:193``: sigmoid for multilabel, softmax otherwise."""
    if sigmoid_loss:
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=1)
