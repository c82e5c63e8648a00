"""Device-resident input features: the one-device part of
`gnn_tpu.parallel.feature_cache`.

:class:`ReplicatedFeatures` keeps the whole feature table on the card
and gathers each batch's input rows with ``index_select``. The
placement-driven sharded cache waits for the multi-device slice
(ROADMAP queue 3).
"""
from __future__ import annotations

import numpy as np
import torch


class ReplicatedFeatures:
    """Whole feature table resident on ``device``. ``dtype`` bfloat16
    halves its memory and gather bytes; rows are cast back to float32
    right after the gather."""

    def __init__(self, feats: np.ndarray, dtype=torch.float32,
                 device="cpu"):
        self.dtype = dtype
        self.table = torch.from_numpy(
            np.ascontiguousarray(feats, np.float32)).to(device).to(dtype)

    def gather(self, input_nodes: torch.Tensor,
               input_mask: torch.Tensor) -> torch.Tensor:
        x = self.table.index_select(0, input_nodes.long()).float()
        return x * input_mask[:, None]
