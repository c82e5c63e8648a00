"""Parameter exchange with the JAX package's flax models.

:func:`params_from_flax` turns a flax ``GNN`` parameter tree into a
``state_dict`` for `gnn_tpu_torch.models.gnn.GNN`: flax's
``Dense.kernel`` is ``[in, out]`` and becomes ``Linear.weight`` as its
transpose; ``scale``, ``offset`` and ``eps`` copy as they are. The
encoder's ``gcs_{i}`` become ``encoder.layers.{i}``: a GAT layer's
``gcs_{i}/{q,k,v,self}/{kernel,bias}`` become ``encoder.layers.{i}.{q,k,v,
self}.{weight,bias}`` and an order-0 GAT layer's bare ``gcs_{i}/{kernel,
bias}`` become ``encoder.layers.{i}.{weight,bias}``. Takes numpy arrays
(or anything ``np.asarray`` accepts), so it needs no JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_flax(flax_params) -> Dict[str, torch.Tensor]:
    """flax ``{"params": {...}}`` (or the inner dict) -> torch
    ``state_dict``."""
    tree = flax_params.get("params", flax_params)
    out = {}
    for path, v in _flatten(tree):
        a = np.array(v, np.float32)          # a writable copy
        parts = list(path)
        if parts[0] == "encoder":
            i = int(parts[1].split("_")[1])          # gcs_{i}
            parts = ["encoder", "layers", str(i)] + parts[2:]
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            a = a.T
        out[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(a))
    return out
