#!/usr/bin/env python3
"""Probe the cold residual's aggregation on one NVIDIA GPU: the COO
``index_add_``, the edge-stream SpMM (K1) forward and transpose, and the
segment-grid SpMM (K6) forward on the pack and transpose on the
(cols, rows)-swapped pack with the factors swapped.

    python3 tools/torch_edgestream_probe.py [--iters 16] [CLI flags]

Samples one batch of the configuration `gnn_tpu_torch.cli` would train
(its defaults unless CLI flags are given) with the port's sampler on the
resident stream-tile path, rebuilds it on the card, and prints one line
per aggregating layer and direction: each kernel's error against the COO
result (relative to its magnitude) and its time by CUDA events (median of
5 rounds of ``--iters`` back-to-back calls). ``chip_smoke.py`` runs the
same functions.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def default_batch(save_dir, device, argv=()):
    """One batch of the CLI's configuration (defaults unless ``argv``;
    ``--sampler`` is honoured) on the resident stream-tile path, its
    layers rebuilt on ``device``. The sample probabilities and the hot
    COO are cached in ``save_dir`` under the CLI's names, so a later CLI
    run there reuses them. Returns
    ``(adjs, widths, ctx)``: the materialized layers, each layer's input
    width, and the set-up (``args``, ``orders``, ``graph``, ``lap``,
    ``targets``)."""
    import numpy as np
    import torch

    from gnn_tpu_torch import cli
    from gnn_tpu_torch.data.loaders import load_dataset
    from gnn_tpu_torch.ops.hotdense import HotSpec, build_hot_dense_cached
    from gnn_tpu_torch.ops.residentgraph import (ResidentGraph,
                                                 build_resident_graph)
    from gnn_tpu_torch.placement.engine import compute_sample_prob
    from gnn_tpu_torch.sampling.ladies import SAMPLERS, SamplerConfig
    from gnn_tpu_torch.train.stepfns import prepare_adjs, to_device_batch
    from gnn_tpu_torch.utils.normalize import build_laplacian

    a = cli.build_parser().parse_args(list(argv))
    orders = tuple(int(t) for t in a.orders.split(","))
    graph = load_dataset(a.dataset, a.data_dir)
    lap = build_laplacian(graph.adj_full, a.model, norm=a.norm)
    depth = sum(orders)
    dsname = a.dataset.replace("/", "_").replace(":", "_")
    prob_path = os.path.join(save_dir, f"{dsname}.sampprob.L{depth}.npy")
    if os.path.exists(prob_path):
        prob = np.load(prob_path)
    else:
        prob = compute_sample_prob(lap, graph.train_nodes, depth)
        np.save(prob_path, prob)
    spec = HotSpec.from_sample_prob(prob, a.hot_k)
    dense, dense_t = build_hot_dense_cached(
        lap, spec, dtype=torch.bfloat16, device=device,
        cache_path=os.path.join(save_dir,
                                f"{dsname}.hotcoo.L{depth}.K{a.hot_k}.npz"))
    host = build_resident_graph(lap, spec, dense, dense_t,
                                val_dtype="bfloat16")
    cfg = SamplerConfig(batch_size=a.batch_size, samp_num=a.samp_num,
                        orders=orders, num_nodes=lap.shape[0],
                        num_classes=graph.num_classes, sampler=a.sampler,
                        adj_format="resident", hot_spec=spec,
                        resident_val_free=host["val_free"],
                        resident_stream_tiles=True)
    targets = np.random.default_rng(1).permutation(graph.train_nodes)
    mb = SAMPLERS[a.sampler](cfg, 7, targets[: a.batch_size], lap,
                              graph.labels)
    adjs = prepare_adjs(to_device_batch(mb, device),
                        ResidentGraph.from_host(host, device))
    widths = [graph.feats.shape[1]] + [(1 + o) * a.nhid
                                       for o in orders[:-1]]
    ctx = types.SimpleNamespace(args=a, orders=orders, graph=graph, lap=lap,
                                targets=targets)
    return adjs, widths, ctx


def seg_cases(adjs, widths):
    """Per aggregating layer with stream tiles: its cold residual as K1's
    pack and K6's tables. Each case holds ``tiles`` (the forward pack),
    ``seg`` (its ``seg_ptr`` on the card), ``tiles_t`` / ``seg_t`` (the
    swapped pack for the transpose), the factors ``rv`` / ``nf``, the
    decoded cold edges ``rows`` / ``cols`` and the layer's width ``f``."""
    import numpy as np
    import torch

    from gnn_tpu_torch.ops.edgestream import (ECAP, EdgeTiles, decode_edges,
                                              pack_edge_tiles, segment_tiles)

    def to_dev(t, dev):
        return EdgeTiles(**{k: (torch.from_numpy(np.ascontiguousarray(v))
                                .to(dev) if isinstance(v, np.ndarray)
                                else v) for k, v in t.__dict__.items()})

    cases = []
    for l, (adj, f) in enumerate(zip(adjs, widths)):
        if adj is None or getattr(adj, "es_rc", None) is None:
            continue
        dev = adj.es_rc.device
        tiles = EdgeTiles(coords=adj.es_coords, blk_rc=adj.es_rc,
                          off=adj.es_off, t_order=adj.es_ord,
                          nrows=adj.nrows, ncols=adj.ncols, bm=adj.es_bm,
                          bk=adj.es_bk, ecap=ECAP, vals=None)
        rows, cols, w = decode_edges(tiles)
        rows, cols = rows[w != 0], cols[w != 0]
        seg = torch.from_numpy(segment_tiles(
            tiles.blk_rc.cpu().numpy(), tiles.off.cpu().numpy())).to(dev)
        t_np = pack_edge_tiles(cols.cpu().numpy(), rows.cpu().numpy(),
                               adj.ncols, adj.nrows, bm=adj.es_bk,
                               bk=adj.es_bm, ecap=ECAP)
        seg_t = torch.from_numpy(segment_tiles(t_np.blk_rc, t_np.off)).to(
            dev)
        cases.append(types.SimpleNamespace(
            layer=l, tiles=tiles, seg=seg, tiles_t=to_dev(t_np, dev),
            seg_t=seg_t, rv=adj.es_rv, nf=adj.es_nf, rows=rows, cols=cols,
            f=f))
    return cases


def n_segments(seg_ptr, nb):
    """Segments of a ``seg_ptr`` that are not trailing padding."""
    return int((seg_ptr[:-1] < nb).sum())


def run_probe(cases, iters=16, seed=0, log=print):
    """Time and check the COO ``index_add_``, K1 and K6 on each case, both
    directions. Returns one record per (layer, direction): the sizes, the
    segment count, K1's and K6's max abs error against the COO result
    and its magnitude, and the three times in ms."""
    import torch

    from gnn_tpu_torch.ops.edgestream import (edge_stream_spmm,
                                              edge_stream_spmm_seg)
    from gnn_tpu_torch.ops.sparse import _coo_aggregate
    from gnn_tpu_torch.utils.timing import cuda_time_ms

    recs = []
    for c in cases:
        dev = c.rv.device
        gen = torch.Generator(device=dev).manual_seed(seed + c.layer)
        wts = c.rv[c.rows] * c.nf[c.cols]
        for transpose in (False, True):
            n_in = c.tiles.nrows if transpose else c.tiles.ncols
            n_out = c.tiles.ncols if transpose else c.tiles.nrows
            x = torch.randn((n_in, c.f), generator=gen, device=dev)
            dst, src = (c.cols, c.rows) if transpose else (c.rows, c.cols)
            if transpose:
                seg_fn = (lambda: edge_stream_spmm_seg(
                    c.tiles_t, c.seg_t, x, c.nf, c.rv))
                nb, segp = c.tiles_t.blk_rc.shape[0], c.seg_t
            else:
                seg_fn = (lambda: edge_stream_spmm_seg(
                    c.tiles, c.seg, x, c.rv, c.nf))
                nb, segp = c.tiles.blk_rc.shape[0], c.seg
            fns = {
                "coo": lambda: _coo_aggregate(dst, src, wts, x, n_out),
                "k1": lambda: edge_stream_spmm(c.tiles, x, c.rv, c.nf,
                                               transpose),
                "k6": seg_fn}
            ref = fns["coo"]()
            out = {k: fns[k]() for k in ("k1", "k6")}
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            rec = dict(layer=c.layer,
                       direction="transpose" if transpose else "forward",
                       R=c.tiles.nrows, C=c.tiles.ncols, F=c.f,
                       edges=int(c.rows.shape[0]),
                       segments=n_segments(segp, nb), scale=scale)
            for k, y in out.items():
                rec[f"{k}_err"] = float((y - ref).abs().max())
                rec[f"{k}_finite"] = bool(torch.isfinite(y).all())
            for k, fn in fns.items():
                rec[f"{k}_ms"] = cuda_time_ms(fn, reps=iters)
            log(f"probe layer {c.layer} {rec['direction']:9s} "
                f"R={rec['R']} C={rec['C']} F={c.f} cold_edges="
                f"{rec['edges']} segments={rec['segments']} rel err K1 "
                f"{rec['k1_err'] / max(scale, 1e-30):.2e} K6 "
                f"{rec['k6_err'] / max(scale, 1e-30):.2e}  ms: coo "
                f"{rec['coo_ms']:.4f} K1 {rec['k1_ms']:.4f} K6 "
                f"{rec['k6_ms']:.4f}")
            recs.append(rec)
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=16)
    own, rest = ap.parse_known_args()

    import subprocess

    import torch
    if not torch.cuda.is_available():
        print("torch.cuda is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    save_dir = tempfile.mkdtemp(prefix="gnn_tpu_torch_probe_")
    try:
        adjs, widths, _ = default_batch(save_dir, torch.device("cuda"),
                                        rest)
        recs = run_probe(seg_cases(adjs, widths), iters=own.iters,
                         log=lambda m: print(m, flush=True))
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    return 0 if all(r["k1_finite"] and r["k6_finite"] for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
