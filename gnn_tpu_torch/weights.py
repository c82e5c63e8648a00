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

:func:`fullgraph_params_from_jax` does the same for the full-graph
trainer's plain parameter dict (`gnn_tpu.train.fullgraph.
init_fullgraph_params`): ``gcs_{i}/{kernel,bias}`` become
``gcs.{i}.linear.{weight,bias}``, ``gcs_{i}/{scale,offset}`` become
``gcs.{i}.{scale,offset}`` and ``head/{kernel,bias}`` become
``head.{weight,bias}``, for
`gnn_tpu_torch.train.fullgraph.FullGraphGCN`.
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


def fullgraph_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The full-graph trainer's ``{"gcs_{i}": {...}, "head": {...}}``
    -> torch ``state_dict`` of ``FullGraphGCN``."""
    out = {}
    for path, v in _flatten(params):
        a = np.array(v, np.float32)          # a writable copy
        layer, leaf = path
        if layer == "head":
            prefix = "head."
        else:
            prefix = f"gcs.{int(layer.split('_')[1])}."
            if leaf in ("kernel", "bias"):
                prefix += "linear."
        if leaf == "kernel":
            leaf, a = "weight", a.T
        out[prefix + leaf] = torch.from_numpy(np.ascontiguousarray(a))
    return out
