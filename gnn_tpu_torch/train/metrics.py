"""Metrics registry / structured logging, the locality scale-factor
tuner and the per-epoch metrics record: the counterpart of
`gnn_tpu.train.metrics`.

The reference's observability is one per-epoch print
(``main.py:196``); the registry keeps the same measurements as
structured records, optionally appended to a JSONL file.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


class MetricsRegistry:
    def __init__(self, jsonl_path: Optional[str] = None):
        self.records: List[Dict[str, Any]] = []
        self.jsonl_path = jsonl_path
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)

    def log(self, **fields) -> Dict[str, Any]:
        rec = {"ts": time.time(), **fields}
        self.records.append(rec)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec


def device_memory_stats() -> Dict[str, int]:
    """Peak bytes allocated by PyTorch on each CUDA device (empty on a
    machine without one)."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": int(torch.cuda.max_memory_allocated(i))
            for i in range(torch.cuda.device_count())}


# the tuner stops once the factor reaches this
MAX_SCALE_FACTOR = 16.0


class ScaleFactorTuner:
    """The locality-sampling scale-factor controller the reference left
    commented out (``main.py:200-212``), live: double the factor while
    data movement dominates (ratio >= 0.2), bisect back when it
    undershoots (< 0.1), stop at ``MAX_SCALE_FACTOR`` or once the ratio
    is in the band."""

    def __init__(self, initial: float = 1.0):
        self.scale_factor = initial
        self.active = True
        # the bisection's lower bound starts at the initial factor, not
        # 0: with initial > 1 and an immediate ratio < 0.1, (0 + sf) / 2
        # would halve below the visited range
        self._before = initial
        self._after = initial

    def update(self, movement_time: float, execution_time: float) -> float:
        if not self.active or execution_time <= 0:
            return self.scale_factor
        ratio = movement_time / execution_time
        if self.scale_factor >= MAX_SCALE_FACTOR:
            self.active = False
        elif ratio >= 0.2:
            self._before = self.scale_factor
            self.scale_factor *= 2
        elif ratio < 0.1 and self.scale_factor != 1.0:
            self._after = self.scale_factor
            self.scale_factor = (self._before + self._after) / 2
        else:
            self.active = False
        return self.scale_factor


@dataclasses.dataclass
class EpochMetrics:
    """The reference's per-epoch timing line (`main.py:196`), carrying all
    of its buckets: spmm fwd/bwd time (`custom_sparse_ops.py:11-12`),
    data-movement, communication, and execution time. The spmm and
    communication buckets stay NaN unless ``fit(op_timing=True)`` fills
    them (`gnn_tpu_torch.train.optiming`: isolated ops on the epoch's
    last batch, times the step count; communication is 0.0 on one
    device; the gradient all-reduce and a batch's feature exchange
    across ranks). ``skew_share`` is the mean share of a batch's layer-0 input
    nodes in the locality skew set (NaN without locality sampling).
    ``step_losses``/``step_times`` hold each training step's loss and
    host-clock seconds (the step ends with the loss read back; under
    grouped dispatch, a group's seconds divided over its steps). The
    three buckets sum the clock reads of the epoch's spans
    (`gnn_tpu_torch.utils.timing`): ``sample_wait_time`` the
    ``pipeline.next`` spans; eagerly, ``data_movement_time`` the
    ``train.to_device`` and ``execution_time`` the ``train.step`` spans;
    grouped on the card, the self time of ``dispatch.stage`` and
    ``dispatch.replay`` less ``dispatch.capture`` plus
    ``dispatch.card_wait``."""

    epoch: int
    train_loss: float
    valid_loss: float
    valid_f1: float
    data_movement_time: float
    execution_time: float
    sample_wait_time: float
    spmm_fwd_time: float = float("nan")
    spmm_bwd_time: float = float("nan")
    communication_time: float = float("nan")
    # true wall time of the training loop INCLUDING the end-of-epoch
    # device sync (async dispatch means the per-step buckets alone
    # under-count queued device work)
    total_time: float = float("nan")
    skew_share: float = float("nan")
    # SHA-1 of the parameters after the epoch (multi-rank runs; every
    # rank must hold the same)
    param_digest: str = ""
    # bytes this rank reduced over its part group in the epoch's training
    # steps (part-sharded runs; 0 elsewhere)
    part_bytes: int = 0
    # CUDA graphs captured in the epoch and their seconds (grouped
    # dispatch on the card), kept out of the step times
    captures: int = 0
    capture_time: float = 0.0
    # the epoch's span and counter totals
    # (`gnn_tpu_torch.utils.timing.Recorder.totals`), filled by
    # ``Trainer.fit`` at the epoch's end
    spans: Dict[str, dict] = dataclasses.field(default_factory=dict)
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    step_losses: List[float] = dataclasses.field(default_factory=list)
    step_times: List[float] = dataclasses.field(default_factory=list)

    def format(self, scale_factor: float = 1.0) -> str:
        ratio = (self.data_movement_time / self.execution_time
                 if self.execution_time else 0.0)
        buckets = ""
        if np.isfinite(self.total_time):
            buckets += f"(total {self.total_time:.2f}s)"
        if np.isfinite(self.spmm_fwd_time):
            buckets += (f"(spmm {self.spmm_fwd_time:.2f}s/"
                        f"{self.spmm_bwd_time:.2f}s)"
                        f"(comm {self.communication_time:.2f}s)")
        return (f"Epoch: {self.epoch} ({self.sample_wait_time:.2f}s)"
                f"({self.data_movement_time:.2f}s)"
                f"({self.execution_time:.2f}s) {buckets}"
                f"Train Loss: {self.train_loss:.2f}    "
                f"Valid Loss: {self.valid_loss:.2f} "
                f"Valid F1: {self.valid_f1:.3f}    "
                f"scale_factor: {scale_factor:.3f}     "
                f"ratio: {ratio:.3f}")
