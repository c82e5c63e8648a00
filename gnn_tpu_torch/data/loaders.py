"""Dataset loaders (a copy of `gnn_tpu.data.loaders`; reference `preprocess.py:17-143`).

Same on-disk formats and return structure as the reference:

* **GraphSAINT format** (`load_graphsaint_data`, `preprocess.py:17-52`):
  ``adj_full.npz`` (scipy sparse), ``role.json`` (train/val/test ids),
  ``feats.npy``, ``class_map.json``; features standardized by a scaler
  fit on train-node features only.

* **OGB node-prediction datasets** (`load_ogbn_data`,
  `preprocess.py:55-97`): edge index symmetrized into a CSR adjacency,
  labels densified to an indicator CSR. Requires the optional ``ogb``
  package — gated, with a clear error when absent.

* Labels are stored as a sparse CSR indicator matrix [N, C] (multi-hot
  for multilabel graphs), exactly like the reference (`preprocess.py:36-46`).

The data root comes from ``$GNN_DATA_DIR`` (reference `main.py:263-265`).
A ``synthetic:`` scheme generates hermetic benchmark graphs.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import scipy.sparse as sp

from gnn_tpu_torch.data.synthetic import GraphData, make_powerlaw_graph


def load_graphsaint_data(graph_name: str, root_dir: str) -> GraphData:
    """GraphSAINT-format directory loader (`preprocess.py:17-52`)."""
    base = os.path.join(root_dir, graph_name)
    adj_full = sp.load_npz(os.path.join(base, "adj_full.npz")).astype(
        np.float32).tocsr()
    with open(os.path.join(base, "role.json")) as f:
        role = json.load(f)
    feats = np.load(os.path.join(base, "feats.npy")).astype(np.float32)
    with open(os.path.join(base, "class_map.json")) as f:
        class_map = {int(k): v for k, v in json.load(f).items()}
    assert len(class_map) == feats.shape[0]

    train_nodes = np.array(role["tr"])
    # standardize features with a scaler fit on train nodes only
    mu = feats[train_nodes].mean(axis=0)
    sd = feats[train_nodes].std(axis=0)
    sd[sd == 0] = 1.0
    feats = (feats - mu) / sd

    n = adj_full.shape[0]
    first = next(iter(class_map.values()))
    if isinstance(first, list):
        num_classes = len(first)
        dense = np.zeros((n, num_classes), np.int32)
        for k, v in class_map.items():
            dense[k] = v
    else:
        vals = np.fromiter((class_map[i] for i in range(n)), dtype=np.int64)
        offset = vals.min()
        num_classes = int(vals.max() - offset + 1)
        dense = np.zeros((n, num_classes), np.int32)
        dense[np.arange(n), vals - offset] = 1
    labels = sp.csr_matrix(dense)

    print("feat dim: ", feats.shape, flush=True)
    print("label dim: ", labels.shape, flush=True)
    return GraphData(adj_full=adj_full, labels=labels,
                     feats=feats.astype(np.float32),
                     num_classes=num_classes, train_nodes=train_nodes,
                     valid_nodes=np.array(role["va"]),
                     test_nodes=np.array(role["te"]))


def load_mag240M(root_dir: str) -> GraphData:
    """MAG240M-LSC loader (`preprocess.py:100-143`); needs `ogb.lsc`.

    Paper-paper citation graph symmetrized to CSR, paper features,
    labels densified to an indicator CSR over the valid (labeled) rows.
    """
    try:
        from ogb.lsc import MAG240MDataset
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "MAG240M needs the optional 'ogb' package (ogb.lsc), which "
            "is not installed in this environment.") from e
    data = MAG240MDataset(root=root_dir)
    row, col = data.edge_index("paper", "paper")
    n = data.num_papers
    rows = np.concatenate([row, col])
    cols = np.concatenate([col, row])
    adj_full = sp.csr_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)), shape=(n, n))
    adj_full.data[:] = 1.0
    feats = np.asarray(data.paper_feat, np.float32)
    y = np.asarray(data.paper_label, np.float64)
    valid = ~np.isnan(y)
    offset = int(np.nanmin(y))
    num_classes = int(np.nanmax(y) - offset + 1)
    li = np.flatnonzero(valid)
    labels = sp.csr_matrix(
        (np.ones(len(li), np.int32),
         (li, y[li].astype(np.int64) - offset)), shape=(n, num_classes))
    split = data.get_idx_split()
    print("feat dim: ", feats.shape, flush=True)
    print("label dim: ", labels.shape, flush=True)
    return GraphData(adj_full=adj_full, labels=labels, feats=feats,
                     num_classes=num_classes,
                     train_nodes=np.asarray(split["train"]),
                     valid_nodes=np.asarray(split["valid"]),
                     test_nodes=np.asarray(split["test"]))


def load_ogbn_data(graph_name: str, root_dir: str) -> GraphData:
    """OGB loader (`preprocess.py:55-97`); needs the `ogb` package."""
    if graph_name == "mag240m_kddcup2021":
        return load_mag240M(root_dir)
    try:
        from ogb.nodeproppred import NodePropPredDataset
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "OGB datasets need the optional 'ogb' package, which is not "
            "installed in this environment. Use a GraphSAINT-format "
            "directory or synthetic:... instead.") from e
    dataset = NodePropPredDataset(graph_name, root=root_dir)
    split = dataset.get_idx_split()
    graph, y = dataset[0]
    n = graph["num_nodes"]
    row, col = graph["edge_index"]
    rows = np.concatenate([row, col])
    cols = np.concatenate([col, row])
    adj_full = sp.csr_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)), shape=(n, n))
    adj_full.data[:] = 1.0
    feats = np.asarray(graph["node_feat"], np.float32)

    y = np.asarray(y).reshape(-1).astype(np.float64)
    valid_lbl = ~np.isnan(y)
    offset = int(np.nanmin(y))
    num_classes = int(np.nanmax(y) - offset + 1)
    li = np.flatnonzero(valid_lbl)
    labels = sp.csr_matrix(
        (np.ones(len(li), np.int32),
         (li, y[li].astype(np.int64) - offset)), shape=(n, num_classes))

    print("feat dim: ", feats.shape, flush=True)
    print("label dim: ", labels.shape, flush=True)
    return GraphData(adj_full=adj_full, labels=labels, feats=feats,
                     num_classes=num_classes,
                     train_nodes=np.asarray(split["train"]),
                     valid_nodes=np.asarray(split["valid"]),
                     test_nodes=np.asarray(split["test"]))


def _save_graph_cache(path: str, g: GraphData) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    lab = g.labels.tocsr()
    with open(tmp, "wb") as f:
        np.savez(f, adj_data=g.adj_full.data,
                 adj_indices=g.adj_full.indices,
                 adj_indptr=g.adj_full.indptr,
                 lab_data=lab.data, lab_indices=lab.indices,
                 lab_indptr=lab.indptr, lab_shape=lab.shape,
                 feats=g.feats, num_classes=g.num_classes,
                 train_nodes=g.train_nodes, valid_nodes=g.valid_nodes,
                 test_nodes=g.test_nodes)
    os.replace(tmp, path)


def _load_graph_cache(path: str):
    if not os.path.exists(path):
        return None
    try:
        z = np.load(path)
        n = len(z["adj_indptr"]) - 1
        adj = sp.csr_matrix(
            (z["adj_data"], z["adj_indices"], z["adj_indptr"]),
            shape=(n, n))
        labels = sp.csr_matrix(
            (z["lab_data"], z["lab_indices"], z["lab_indptr"]),
            shape=tuple(z["lab_shape"]))
        return GraphData(adj_full=adj, labels=labels, feats=z["feats"],
                         num_classes=int(z["num_classes"]),
                         train_nodes=z["train_nodes"],
                         valid_nodes=z["valid_nodes"],
                         test_nodes=z["test_nodes"])
    except Exception as e:
        print(f"synthetic graph cache {path} unusable ({e}); regenerating",
              flush=True)
        return None


def load_dataset(name: str, root_dir: str | None = None) -> GraphData:
    """Dispatch like `main.py:262-265`, plus a synthetic scheme:
    ``synthetic:nodes=100000,deg=50,feats=602,classes=41[,multilabel]``."""
    if name.startswith("synthetic"):
        kw = dict(num_nodes=100_000, avg_degree=50, num_feats=602,
                  num_classes=41, seed=0, multilabel=False,
                  homophily=0.0)
        if ":" in name:
            for part in name.split(":", 1)[1].split(","):
                if part == "multilabel":
                    kw["multilabel"] = True
                    continue
                k, v = part.split("=")
                if k == "homophily":
                    kw["homophily"] = float(v)
                    continue
                key = {"nodes": "num_nodes", "deg": "avg_degree",
                       "feats": "num_feats", "classes": "num_classes",
                       "seed": "seed"}[k]
                kw[key] = int(v)
        # disk-cache big generated graphs: generation is deterministic in
        # the spec, costs ~a minute at Reddit scale, and every benchmark
        # run pays it otherwise (cache ~750 MB, loads in seconds)
        cache_root = os.environ.get(
            "GNN_TPU_TORCH_SYNTH_CACHE",
            os.path.join(tempfile.gettempdir(), "gnn_tpu_torch_synth"))
        if kw["num_nodes"] >= 100_000 and cache_root:
            # default homophily stays out of the tag so pre-knob caches
            # remain valid
            tag_kw = {k: v for k, v in kw.items()
                      if not (k == "homophily" and v == 0.0)}
            tag = "_".join(f"{k}={v}" for k, v in sorted(tag_kw.items()))
            path = os.path.join(cache_root, f"{tag}.npz")
            g = _load_graph_cache(path)
            if g is not None:
                return g
            g = make_powerlaw_graph(**kw)
            _save_graph_cache(path, g)
            return g
        return make_powerlaw_graph(**kw)
    if root_dir is None:
        root_dir = os.environ.get("GNN_DATA_DIR", "data")
    if "ogbn" in name or "mag240m" in name:
        return load_ogbn_data(name, root_dir)
    return load_graphsaint_data(name, root_dir)
