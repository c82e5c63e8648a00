"""The operations one training step requires, counted from a batch's
sampled layers and charged at the peak of the precision the
configuration states for each (``step_mfu``). The count is of the
mathematics, whatever implements it: the dense layers at their widths
over the valid rows, ``2 * nnz * F`` for each aggregation over the
layer's true edges (no padding, no dense hot-slot product), and the
backward pass as twice the forward pass's products. A model's forward
count lives in ``model_<name>.py`` beside this file."""
from __future__ import annotations

import importlib

from portbench.counts.peaks import PEAK_FLOPS


def model_counts(model: str):
    """The counting module of a configuration's ``model``."""
    return importlib.import_module(f"portbench.counts.model_{model}")


def seconds_at_peak(flops_by_precision: dict) -> float:
    """Seconds the card needs for these operations at its published
    peaks, each at the peak of its precision."""
    return sum(f / PEAK_FLOPS[p] for p, f in flops_by_precision.items())


def step_seconds_at_peak(config: dict, layers: list, batch_rows: int
                         ) -> float:
    """A training step's operations (forward and a backward of twice its
    products) in seconds at peak. ``layers``: per sampled layer, bottom
    up, ``{"r": rows, "c": cols, "nnz": edges, "nnz_hot": hot-hot
    edges}`` (valid counts)."""
    fwd = model_counts(config["model"]).forward_flops(config, layers,
                                                     batch_rows)
    return 3.0 * seconds_at_peak(fwd)
