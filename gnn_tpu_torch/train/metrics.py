"""Metrics registry / structured logging and the per-epoch metrics
record: the counterpart of `gnn_tpu.train.metrics` (the locality
scale-factor tuner waits, ROADMAP queue 2).

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


@dataclasses.dataclass
class EpochMetrics:
    """The reference's per-epoch timing line (`main.py:196`), carrying all
    of its buckets: spmm fwd/bwd time (`custom_sparse_ops.py:11-12`),
    data-movement, communication, and execution time. The port fills
    the sampling, movement, execution and total buckets; the spmm and
    communication buckets stay NaN until ``--op_timing`` is ported.
    ``step_losses``/``step_times`` hold each training step's loss and
    host-clock seconds (the step ends with the loss read back)."""

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
