#!/usr/bin/env python3
"""Drive the PyTorch port (gnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final result line):

1. versions, and the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from ``gnn_tpu_torch/csrc`` (one
   nvcc per source, all started together);
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes. The resident paths' shapes come from one batch of
   the default configuration (synthetic 100k nodes / degree 50 / 602
   features / 41 classes, batch 2048, samp_num 8192, orders 1,1,1, hot_k
   16384; GraphSAGE and GAT sample the same row-normalized graph, so
   their batches are the same): the edge-stream SpMM (K1) forward and
   transpose at each aggregating layer's width, plus one per-edge-values
   case, and apart from their sums the subgraph path's three layers (one
   batch of ``--sampler subgraph``: the square layer shared by layers 0
   and 1 at both widths, and the top layer); each K1 / K6 case prints its
   thread-block count; the segment-grid SpMM (K6) on the same three cold
   residuals,
   forward on the pack and transpose on the (cols, rows)-swapped pack,
   against its plain version and against K1 (the same function); the
   four edge-stream attention kernels (K3 row max, K4 terms, bwd_q,
   bwd_kv) at each GAT layer's width (512, one head), plus one 4-head
   case and one case at 50x magnitudes, each with its thread blocks and
   cluster size. The stream SpMM (K2) runs at the
   three layers of one blocked batch (50k nodes / degree 30, batch 512,
   samp_num 2048; widths 602 / 1024 / 1024) over ``block_*`` and over
   the transposed ``block_*_t``, and K2 in both orientations and the
   stream SDDMM (K5) at GAT's tile layer of one default pattern batch
   (2048 x 10240, all 1280 tiles, width 512), plus a 4-head case, a case
   with empty row tiles and one with BlockedAdj padding tiles. Each case
   prints its error, the kernel's time (CUDA events), the plain version's
   time, the bound (the larger of the bytes over the memory rate and the
   float32 flops over the float32 rate) and, where one PyTorch call
   computes the same function, that call's time (a yardstick the port
   never calls): ``torch.sparse.mm`` over a CSR of K1's and K6's
   weighted edges, over a BSR of K2's tiles (a CSR of their nonzeros
   where the card's PyTorch refuses BSR), ``torch.sparse.sampled_addmm``
   over a CSR of every entry of K5's tiles;
4. a small input (3000 nodes) through the whole training path on the
   card and on the CPU, where the CPU path is the one the tests hold
   against the JAX package: the step losses must agree. Cases: GraphSAGE
   and GAT on the resident path, GraphSAGE on the blocked format, GAT on
   the pattern transport (the tile route on every layer), GraphSAGE on
   the hot format, GraphSAGE and GAT on the resident path with the
   subgraph sampler, and GraphSAGE on the resident path with full
   expansion (``resident_ship_cold=False``); then GAT on the resident
   path over four epochs (``Trainer.fit``): each epoch's train loss, val
   loss and val F1, and the test F1, must agree;
5. the main paths, each with every launch counter set to 0 just before
   the run and read just after. Through ``gnn_tpu_torch.cli.main``: the
   defaults plus ``--n_devices 1 --epoch_num 1 --test`` (GraphSAGE), the
   same with ``--model gat``, ``--adj_format blocked`` on the 50k-node
   graph (one epoch and the val pass, no test sweep: each batch packs
   about 0.3 GB of tiles on the host), ``--model gat --adj_format
   pattern`` at the defaults (one epoch, val, test sweep), and, one
   epoch and the val pass each, ``--adj_format hot`` and ``--sampler
   subgraph`` at the defaults (the subgraph run must launch K1 in both
   directions every step); every run's loss must fall. Then the probe
   path (``tools/torch_edgestream_probe.py``'s
   functions on one default batch: the COO, K1 and K6 on each layer's
   cold residual, both directions), which must launch K6;
6. a ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 (non-tensor
# core) flop/s; the kernel adds float32 products on CUDA cores
MEM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# relative tolerance: the kernel sums float32 products in another order
# (set by shared-memory int atomics) than the plain version (index_add_);
# a row sums at most a few thousand terms, so differences stay near 1e-6
# of the output's magnitude — 1e-4 leaves room without hiding a wrong edge
REL_TOL = 1e-4
# step losses of the small-input run on the card vs on the CPU
AGREE_RTOL = 1e-3
KERNEL_SOURCES = ["edge_stream", "edge_attention", "stream_spmm"]
# every kernel of the port: JSON name, (module, launch-counter key), its
# source, the TPU kernel it replaces
KERNELS = [
    ("edge_stream_spmm.forward", ("edgestream", "forward"),
     "gnn_tpu_torch/csrc/edge_stream.cu",
     "gnn_tpu/ops/pallas_edgestream.py:572"),
    ("edge_stream_spmm.transpose", ("edgestream", "transpose"),
     "gnn_tpu_torch/csrc/edge_stream.cu",
     "gnn_tpu/ops/pallas_edgestream.py:572"),
    ("cold_attention_rowmax", ("esattn", "rowmax"),
     "gnn_tpu_torch/csrc/edge_attention.cu",
     "gnn_tpu/ops/pallas_esattn.py:321"),
    ("cold_attention_terms", ("esattn", "terms"),
     "gnn_tpu_torch/csrc/edge_attention.cu",
     "gnn_tpu/ops/pallas_esattn.py:429"),
    ("cold_attention_terms.bwd_q", ("esattn", "bwd_q"),
     "gnn_tpu_torch/csrc/edge_attention.cu",
     "gnn_tpu/ops/pallas_esattn.py:429"),
    ("cold_attention_terms.bwd_kv", ("esattn", "bwd_kv"),
     "gnn_tpu_torch/csrc/edge_attention.cu",
     "gnn_tpu/ops/pallas_esattn.py:429"),
    ("stream_spmm.forward", ("spmm", "forward"),
     "gnn_tpu_torch/csrc/stream_spmm.cu", "gnn_tpu/ops/pallas_spmm.py:132"),
    ("stream_spmm.transpose", ("spmm", "transpose"),
     "gnn_tpu_torch/csrc/stream_spmm.cu", "gnn_tpu/ops/pallas_spmm.py:132"),
    ("stream_sddmm", ("sddmm", "sddmm"),
     "gnn_tpu_torch/csrc/stream_spmm.cu", "gnn_tpu/ops/pallas_sddmm.py:36"),
    ("edge_stream_spmm_seg", ("edgestream", "seg"),
     "gnn_tpu_torch/csrc/edge_stream.cu",
     "gnn_tpu/ops/pallas_edgestream.py:373"),
]
ATTN_KEYS = ["rowmax", "terms", "bwd_q", "bwd_kv"]
# the blocked main path: the JAX package's records' smaller configuration
# for this format (50k nodes, samp_num 2048)
BLOCKED_ARGS = ["--adj_format", "blocked", "--dataset",
                "synthetic:nodes=50000,deg=30", "--samp_num", "2048",
                "--batch_size", "512"]


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps=10, rounds=5):
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events (after warm-up)."""
    from gnn_tpu_torch.utils.timing import cuda_time_ms
    return cuda_time_ms(fn, reps, rounds)


def load_probe():
    """``tools/torch_edgestream_probe.py`` as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "torch_edgestream_probe.py")
    spec = importlib.util.spec_from_file_location("torch_edgestream_probe",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_kernels():
    from gnn_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:
        list(ex.map(cuda_build.build, KERNEL_SOURCES))
    for name in KERNEL_SOURCES:
        cuda_build.load(name)
    return time.perf_counter() - t0


def main_path_batch(save_dir, device):
    """One batch of the default configuration, its layers rebuilt on the
    device (the probe's set-up, the same one `gnn_tpu_torch.cli` runs),
    and the same targets on the pattern transport (GAT's tile layer)."""
    from gnn_tpu_torch.sampling.ladies import SamplerConfig, ladies_sample
    from gnn_tpu_torch.train.stepfns import to_device_batch

    adjs, widths, ctx = load_probe().default_batch(save_dir, device)
    a = ctx.args
    pcfg = SamplerConfig(batch_size=a.batch_size, samp_num=a.samp_num,
                         orders=ctx.orders, num_nodes=ctx.lap.shape[0],
                         num_classes=ctx.graph.num_classes,
                         adj_format="pattern")
    pattern = to_device_batch(ladies_sample(
        pcfg, 7, ctx.targets[: a.batch_size], ctx.lap, ctx.graph.labels),
        device).adjs
    return adjs, widths, pattern


def blocked_batch(device):
    """One batch of the blocked main path (``BLOCKED_ARGS``) on the
    device, and its layers' widths."""
    import numpy as np

    from gnn_tpu_torch import cli
    from gnn_tpu_torch.data.loaders import load_dataset
    from gnn_tpu_torch.sampling.ladies import SamplerConfig, ladies_sample
    from gnn_tpu_torch.train.stepfns import to_device_batch
    from gnn_tpu_torch.utils.normalize import build_laplacian

    a = cli.build_parser().parse_args(BLOCKED_ARGS)
    orders = tuple(int(t) for t in a.orders.split(","))
    graph = load_dataset(a.dataset, a.data_dir)
    lap = build_laplacian(graph.adj_full, a.model)
    cfg = SamplerConfig(batch_size=a.batch_size, samp_num=a.samp_num,
                        orders=orders, num_nodes=lap.shape[0],
                        num_classes=graph.num_classes, adj_format="blocked")
    tgt = np.random.default_rng(1).permutation(graph.train_nodes)
    mb = ladies_sample(cfg, 7, tgt[: a.batch_size], lap, graph.labels)
    widths = [graph.feats.shape[1]] + [(1 + o) * a.nhid
                                       for o in orders[:-1]]
    return to_device_batch(mb, device).adjs, widths


def check_edge_stream(adjs, widths, device, sub_adjs, sub_widths):
    """Phase 3: the edge-stream SpMM kernel (K1) against its plain
    version: the default batch's layers (the sums), the layer-1 tiles
    with per-edge values, and the subgraph path's layers (printed apart,
    outside the sums)."""
    import torch

    from gnn_tpu_torch.ops.edgestream import (EdgeTiles, ECAP, decode_edges,
                                              edge_stream_spmm,
                                              edge_stream_spmm_ref,
                                              launch_blocks)
    gen = torch.Generator(device=device).manual_seed(0)
    totals = {d: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                      max_abs_err=0.0, bytes=0.0, flops=0.0)
              for d in ("forward", "transpose")}
    def tiles_of(adj):
        return EdgeTiles(coords=adj.es_coords, blk_rc=adj.es_rc,
                         off=adj.es_off, t_order=adj.es_ord,
                         nrows=adj.nrows, ncols=adj.ncols, bm=adj.es_bm,
                         bk=adj.es_bk, ecap=ECAP, vals=None)

    # the last field: "sum" (the default batch: in the sums), "err" (in
    # the worst error only), "apart" (printed only)
    cases = [(f"layer{l}", tiles_of(adj), adj.es_rv, adj.es_nf, f, "sum")
             for l, (adj, f) in enumerate(zip(adjs, widths))]
    # per-edge values ride the layer-1 tiles (weighted-graph payload)
    t1 = cases[1][1]
    vals = torch.rand(tuple(t1.coords.shape), generator=gen,
                      device=device) + 0.5
    cases.append(("layer1+vals", EdgeTiles(**{**t1.__dict__, "vals": vals}),
                  cases[1][2], cases[1][3], widths[1], "err"))
    cases += [(f"subgraph{l}", tiles_of(adj), adj.es_rv, adj.es_nf, f,
               "apart")
              for l, (adj, f) in enumerate(zip(sub_adjs, sub_widths))]
    for name, tiles, rv, nf, f, use in cases:
        rows, cols, w = decode_edges(tiles)
        e = int(rows.shape[0])
        nb = int(tiles.blk_rc.shape[0])
        for transpose in (False, True):
            d = "transpose" if transpose else "forward"
            n_in = tiles.nrows if transpose else tiles.ncols
            n_out = tiles.ncols if transpose else tiles.nrows
            x = torch.randn((n_in, f), generator=gen, device=device)
            y = edge_stream_spmm(tiles, x, rv, nf, transpose)
            ref = edge_stream_spmm_ref(tiles, x, rv, nf, transpose)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            scale = float(ref.abs().max())
            if not torch.isfinite(y).all() or err > REL_TOL * scale + 1e-6:
                fail(f"edge_stream_spmm {d} {name}: max abs err {err:.3e} "
                     f"vs max |ref| {scale:.3e}")
            ms = time_ms(lambda: edge_stream_spmm(tiles, x, rv, nf,
                                                  transpose))
            plain_ms = time_ms(lambda: edge_stream_spmm_ref(
                tiles, x, rv, nf, transpose), reps=3)
            # library yardstick: cuSPARSE CSR SpMM over the same weights
            wt = w * rv[rows] * nf[cols]
            r_, c_ = (cols, rows) if transpose else (rows, cols)
            csr = torch.sparse_coo_tensor(
                torch.stack([r_, c_]), wt, (n_out, n_in)
            ).coalesce().to_sparse_csr()
            lib_y = torch.sparse.mm(csr, x)
            lib_err = float((lib_y - ref).abs().max())
            library_ms = time_ms(lambda: torch.sparse.mm(csr, x))
            nbytes = (2 * e + 16 * nb + 4 * (n_in + n_out) * f
                      + 4 * (tiles.nrows + tiles.ncols)
                      + (4 * e if tiles.vals is not None else 0))
            flops = 2 * e * f + (n_in + n_out) * f
            t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
            t_flops = flops / F32_FLOPS_PER_S * 1e3
            bound_ms = max(t_bytes, t_flops)
            log(f"K1 {d:9s} {name:12s} R={tiles.nrows} C={tiles.ncols} "
                f"F={f} cold_edges={e} entries={nb} "
                f"blocks={launch_blocks(tiles, f, transpose)} "
                f"max_abs_err={err:.3e} max_rel_err={err / scale:.3e} "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={library_ms:.4f} (lib err {lib_err:.2e}) "
                f"bound_ms={bound_ms:.4f} "
                f"({'bytes' if t_bytes >= t_flops else 'operations'})")
            t = totals[d]
            if use != "apart":
                t["max_abs_err"] = max(t["max_abs_err"], err)
            if use == "sum":
                t["ms"] += ms
                t["plain_ms"] += plain_ms
                t["library_ms"] += library_ms
                t["bound_ms"] += bound_ms
                t["bytes"] += nbytes / MEM_BYTES_PER_S
                t["flops"] += flops / F32_FLOPS_PER_S
    return totals


def check_seg(adjs, widths, device):
    """Phase 3: the segment-grid SpMM (K6) against its plain version and
    against K1 on the same tiles (the same function), at the default
    batch's cold residuals: forward on the pack, transpose on the
    (cols, rows)-swapped pack with the factors swapped (the probe's
    cases). Returns the sums over one probe pass (every layer, both
    directions)."""
    import torch

    from gnn_tpu_torch.ops.edgestream import (edge_stream_spmm,
                                              edge_stream_spmm_seg,
                                              edge_stream_spmm_seg_ref,
                                              launch_blocks)
    probe = load_probe()
    gen = torch.Generator(device=device).manual_seed(3)
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               max_abs_err=0.0, bytes=0.0, flops=0.0)
    for c in probe.seg_cases(adjs, widths):
        e = int(c.rows.shape[0])
        for transpose in (False, True):
            d = "transpose" if transpose else "forward"
            tiles, seg, rv, nf = ((c.tiles_t, c.seg_t, c.nf, c.rv)
                                  if transpose else
                                  (c.tiles, c.seg, c.rv, c.nf))
            n_in, n_out, f = tiles.ncols, tiles.nrows, c.f
            x = torch.randn((n_in, f), generator=gen, device=device)
            kern = lambda: edge_stream_spmm_seg(tiles, seg, x, rv, nf)
            plain = lambda: edge_stream_spmm_seg_ref(tiles, seg, x, rv, nf)
            y, ref = kern(), plain()
            k1 = edge_stream_spmm(c.tiles, x, c.rv, c.nf, transpose)
            torch.cuda.synchronize()
            label = f"layer{c.layer} {d}"
            err, rel = _max_err(y, ref, label, "edge_stream_spmm_seg")
            err_k1, rel_k1 = _max_err(y, k1, label,
                                      "edge_stream_spmm_seg vs K1")
            del y, ref, k1
            nb = int(tiles.blk_rc.shape[0])
            ns = probe.n_segments(seg, nb)
            ms = time_ms(kern)
            plain_ms = time_ms(plain, reps=3)
            # library yardstick: cuSPARSE CSR SpMM over the same weights
            r_, c_ = (c.cols, c.rows) if transpose else (c.rows, c.cols)
            csr = torch.sparse_coo_tensor(
                torch.stack([r_, c_]), c.rv[c.rows] * c.nf[c.cols],
                (n_out, n_in)).coalesce().to_sparse_csr()
            library_ms = time_ms(lambda: torch.sparse.mm(csr, x))
            del csr
            nbytes = (2 * e + 16 * nb + 4 * ns + 4 * (n_in + n_out) * f
                      + 4 * (n_in + n_out))
            flops = 2 * e * f + (n_in + n_out) * f
            t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
            t_flops = flops / F32_FLOPS_PER_S * 1e3
            bound_ms = max(t_bytes, t_flops)
            log(f"K6 {d:9s} layer{c.layer} R={n_out} C={n_in} F={f} "
                f"cold_edges={e} entries={nb} segments={ns} "
                f"blocks={launch_blocks(tiles, f)} "
                f"max_abs_err={err:.3e} max_rel_err={rel:.3e} "
                f"vs K1 max_rel_err={rel_k1:.3e} ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                f"bound_ms={bound_ms:.4f} "
                f"({'bytes' if t_bytes >= t_flops else 'operations'})")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["library_ms"] += library_ms
            tot["bound_ms"] += bound_ms
            tot["bytes"] += t_bytes
            tot["flops"] += t_flops
    torch.cuda.empty_cache()
    return tot


def _max_err(y, ref, name, what):
    """``(max abs err, max rel err)`` of a kernel's output against its
    plain version; fails on a non-finite output or an error above
    REL_TOL of the output's magnitude + 1e-6."""
    import torch
    err = float((y - ref).abs().max()) if y.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    if not torch.isfinite(y).all() or err > REL_TOL * scale + 1e-6:
        fail(f"{what} {name}: max abs err {err:.3e} vs max |ref| "
             f"{scale:.3e}")
    return err, err / max(scale, 1e-30)


def check_attention(adjs, device, nhid):
    """Phase 3: the four edge-stream attention kernels (K3, K4 and its two
    backward passes) against their plain versions at the GAT layers'
    shapes: q [R, nhid], k and v [C, nhid] of each layer's cold tiles,
    one head; plus a 4-head case on layer 1 and a 50x-magnitude case on
    layer 1 (there only the row max is compared, and every output must
    be finite: at scores of ~1e4, one float32 rounding step of a score
    moves exp(s - row_max) by ~1e-3)."""
    import torch

    from gnn_tpu_torch.ops import esattn as ea
    gen = torch.Generator(device=device).manual_seed(1)
    totals = {key: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                        max_rel_err=0.0, bytes=0.0, flops=0.0)
              for key in ATTN_KEYS}
    cases = [(f"layer{l}", adj, 1, 1.0) for l, adj in enumerate(adjs)]
    cases += [("layer1 H=4", adjs[1], 4, 1.0), ("layer1 x50", adjs[1], 1,
                                                50.0)]
    for name, adj, H, mag in cases:
        main = H == 1 and mag == 1.0
        t = (adj.es_coords, adj.es_rc, adj.es_off, adj.es_ord)
        kw = dict(n_heads=H, bm=adj.es_bm, bk=adj.es_bk)
        R, C, n = adj.nrows, adj.ncols, nhid

        def rnd(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=device) * scale
        # the softmax scale 1/sqrt(d) is folded into q, as on the path
        q = rnd(R, n, scale=mag / (n // H) ** 0.5)
        k, v = rnd(C, n, scale=mag), rnd(C, n)
        gd, gn = rnd(R, H), rnd(R, n)
        rows, _ = ea.live_edges(*t[:3], adj.es_bm, adj.es_bk)
        e, nb = int(rows.shape[0]), int(t[1].shape[0])
        rm_ref = ea.cold_attention_rowmax_ref(*t[:3], q, k, **kw)
        has = rm_ref > ea.NEG_SENTINEL / 2
        rm = torch.where(has, rm_ref, torch.zeros_like(rm_ref))
        fns = {
            "rowmax": (lambda: ea.cold_attention_rowmax(*t[:3], q, k, **kw),
                       lambda: ea.cold_attention_rowmax_ref(*t[:3], q, k,
                                                            **kw)),
            "terms": (lambda: ea.cold_attention_terms(*t, q, k, v, rm, **kw),
                      lambda: ea.cold_attention_terms_ref(*t, q, k, v, rm,
                                                          **kw)),
            "bwd_q": (lambda: ea.cold_attention_bwd_q(*t, q, k, v, rm, gd,
                                                      gn, **kw),
                      lambda: ea.cold_attention_bwd_q_ref(*t, q, k, v, rm,
                                                          gd, gn, **kw)),
            "bwd_kv": (lambda: ea.cold_attention_bwd_kv(*t, q, k, v, rm, gd,
                                                        gn, **kw),
                       lambda: ea.cold_attention_bwd_kv_ref(*t, q, k, v, rm,
                                                            gd, gn, **kw)),
        }
        # bytes each function must move besides the coords (2 B/edge) and
        # the entry tables (16 B/entry), and its float32 flops
        qkv = 4 * (R * n + 2 * C * n)
        io = {"rowmax": (4 * (R * n + C * n) + 4 * R * H, 2 * e * n),
              "terms": (qkv + 4 * R * H + 4 * (R * H + R * n), 4 * e * n),
              "bwd_q": (qkv + 4 * (2 * R * H + R * n) + 4 * R * n,
                        6 * e * n),
              "bwd_kv": (qkv + 4 * (2 * R * H + R * n) + 4 * nb
                         + 8 * C * n, 8 * e * n)}
        for key in ATTN_KEYS:
            kern, plain = fns[key]
            got, want = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = []
            for i, (y, ref) in enumerate(zip(got, want)):
                if not torch.isfinite(y[has] if key == "rowmax" else y).all():
                    fail(f"{key} {name}: non-finite output {i}")
                if key == "rowmax":
                    if not (y[~has] == ea.NEG_SENTINEL).all():
                        fail(f"{key} {name}: rows without a cold edge do "
                             f"not read NEG_SENTINEL")
                    errs.append(_max_err(y[has], ref[has], name, key))
                elif mag == 1.0:
                    errs.append(_max_err(y, ref, name, key))
            err = max((a for a, _ in errs), default=0.0)
            rel = max((b for _, b in errs), default=0.0)
            nbytes = 2 * e + 16 * nb + io[key][0]
            t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
            t_flops = io[key][1] / F32_FLOPS_PER_S * 1e3
            bound_ms = max(t_bytes, t_flops)
            tot = totals[key]
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["max_rel_err"] = max(tot["max_rel_err"], rel)
            n_tiles = C // adj.es_bk if key == "bwd_kv" else R // adj.es_bm
            blocks, cluster = ea.launch_blocks(adj.es_coords, n_tiles, n)
            line = (f"{key:6s} {name:10s} R={R} C={C} n_out={n} H={H} "
                    f"cold_edges={e} entries={nb} blocks={blocks} "
                    f"cluster={cluster} max_abs_err={err:.3e} "
                    f"max_rel_err={rel:.3e}")
            if main:
                ms = time_ms(kern)
                plain_ms = time_ms(plain, reps=2, rounds=3)
                line += (f" ms={ms:.4f} plain_ms={plain_ms:.4f} "
                         f"bound_ms={bound_ms:.4f} "
                         f"({'bytes' if t_bytes >= t_flops else 'operations'})")
                tot["ms"] += ms
                tot["plain_ms"] += plain_ms
                tot["bound_ms"] += bound_ms
                tot["bytes"] += t_bytes
                tot["flops"] += t_flops
            log(line)
            del got, want
        torch.cuda.empty_cache()
    return totals


def _library_spmm(dense, bm, bk, x):
    """The yardstick for K2: one ``torch.sparse.mm`` over a BSR tensor of
    the same ``(bm, bk)`` tiles, or over a CSR of their nonzeros where the
    card's PyTorch refuses BSR. Returns ``(fn, label)``."""
    import torch
    try:
        bsr = dense.to_sparse_bsr((bm, bk))
        torch.sparse.mm(bsr, x)
        torch.cuda.synchronize()
        return (lambda: torch.sparse.mm(bsr, x)), "BSR"
    except (RuntimeError, NotImplementedError, TypeError) as e:
        log(f"  (torch.sparse.mm refuses BSR here: {str(e)[:100]}; CSR)")
        torch.cuda.synchronize()
        csr = dense.to_sparse_csr()
        return (lambda: torch.sparse.mm(csr, x)), "CSR"


def _stream_dense(stream, transpose):
    """The stream's matrix (or its transpose), dense, on its device."""
    import torch
    n_rt, n_ct = stream.nrows // stream.bm, stream.ncols // stream.bk
    d = torch.zeros((n_rt, n_ct, stream.bm, stream.bk),
                    device=stream.vals.device)
    rc = stream.blk_rc.long()
    d.index_put_((rc >> 16, rc & 0xFFFF), stream.vals, accumulate=True)
    d = d.permute(0, 2, 1, 3).reshape(stream.nrows, stream.ncols)
    return d.t().contiguous() if transpose else d


def check_tile_kernels(blocked, bwidths, pattern, device, nhid):
    """Phase 3: the stream SpMM (K2, both orientations) and SDDMM (K5)
    against their plain versions: at the three blocked layers over
    ``block_*`` and over ``block_*_t``; at GAT's tile layer of one default
    pattern batch (attention-like tile values: the layer's 0/1 mask times
    positive random numbers), one head and four; a stream whose odd row
    tiles have no entry; a blocked layer with padding tiles. Returns, per
    kernel, the per-step sums over one step of each main path that runs
    it (``mult`` = launches of that case per step)."""
    import torch

    from gnn_tpu_torch.models.gat import _coo_to_tilewise
    from gnn_tpu_torch.ops import sddmm as tsd
    from gnn_tpu_torch.ops import spmm as tsm
    gen = torch.Generator(device=device).manual_seed(2)
    names = ("stream_spmm.forward", "stream_spmm.transpose", "stream_sddmm")
    totals = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                      max_abs_err=0.0, bytes=0.0, flops=0.0) for n in names}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)

    cases = []   # (label, kernel name, stream, F, transpose, mult)
    for l, (adj, f) in enumerate(zip(blocked, bwidths)):
        for t, (cols, vals, bm, bk) in enumerate(
                ((adj.block_cols, adj.block_vals, adj.bm, adj.bk),
                 (adj.block_cols_t, adj.block_vals_t, adj.bk, adj.bm))):
            rc, v = tsm._blocked_to_stream_arrays(cols, vals)
            nrows = cols.shape[0] * bm
            ncols = adj.ncols if t == 0 else adj.nrows
            # the backward runs over block_*_t on layers 1 and 2 only (the
            # features take no gradient)
            mult = 1 if t == 0 or l > 0 else 0
            cases.append((f"blocked L{l} {'block_*' if t == 0 else 'block_*_t'}",
                          "stream_spmm.forward",
                          tsm.StreamBlocks(blk_rc=rc, vals=v, nrows=nrows,
                                           ncols=ncols, bm=bm, bk=bk),
                          f, False, mult))
    top = pattern[-1]
    blk_rc, t_order, mask = _coo_to_tilewise(top)
    att = mask * (torch.rand(mask.shape, generator=gen, device=device)
                  + 0.5) / 64.0
    gat = tsm.StreamBlocks(blk_rc=blk_rc, vals=att, nrows=top.nrows,
                           ncols=top.ncols, bm=128, bk=128, t_order=t_order)
    for heads in (1, 4):
        f = nhid // heads
        main = 2 if heads == 1 else 0   # launches per step of each
        cases.append((f"GAT tile H={heads}", "stream_spmm.forward", gat, f,
                      False, main))
        cases.append((f"GAT tile H={heads}", "stream_spmm.transpose", gat, f,
                      True, main))
        cases.append((f"GAT tile H={heads}", "stream_sddmm", gat, f, False,
                      main))
    # every odd row tile without an entry: those rows must read 0
    keep = ((blk_rc >> 16) % 2) == 0
    holes = tsm.StreamBlocks(blk_rc=blk_rc[keep].contiguous(),
                             vals=att[keep].contiguous(), nrows=top.nrows,
                             ncols=top.ncols, bm=128, bk=128)
    cases.append(("empty row tiles", "stream_spmm.forward", holes, nhid,
                  False, 0))
    cases.append(("empty row tiles", "stream_spmm.transpose", holes, nhid,
                  True, 0))
    # BlockedAdj padding: three more zero tiles at column tile 0 per row
    b2 = blocked[2]
    n_rt = b2.block_cols.shape[0]
    rc, v = tsm._blocked_to_stream_arrays(
        torch.cat([b2.block_cols, b2.block_cols.new_zeros((n_rt, 3))], 1),
        torch.cat([b2.block_vals,
                   b2.block_vals.new_zeros((n_rt, 3, b2.bm, b2.bk))], 1))
    cases.append(("blocked L2 + 3 pad tiles/row", "stream_spmm.forward",
                  tsm.StreamBlocks(blk_rc=rc, vals=v, nrows=b2.nrows,
                                   ncols=b2.ncols, bm=b2.bm, bk=b2.bk),
                  bwidths[2], False, 0))

    for label, name, st, f, transpose, mult in cases:
        nb, bm, bk = st.blk_rc.shape[0], st.bm, st.bk
        if name == "stream_sddmm":
            xa, ya = rnd(st.nrows, f), rnd(st.ncols, f)
            kern = lambda: tsd.stream_sddmm(st.blk_rc, xa, ya, bm, bk)
            plain = lambda: tsd.sddmm_reference(st.blk_rc, xa, ya, bm, bk)
            nbytes = 4 * nb + 4 * (st.nrows + st.ncols) * f + 4 * nb * bm * bk
            # every entry of the tiles, as a CSR for sampled_addmm
            occ = torch.zeros((st.nrows // bm, st.ncols // bk), device=device)
            rc = st.blk_rc.long()
            occ[rc >> 16, rc & 0xFFFF] = 1.0
            pat = occ.repeat_interleave(bm, 0).repeat_interleave(bk, 1)
            csr = pat.to_sparse_csr()
            del pat, occ
            yt = ya.t()
            lib = lambda: torch.sparse.sampled_addmm(csr, xa, yt, beta=0.0)
            lib_label = "sampled_addmm"
        else:
            n_in = st.nrows if transpose else st.ncols
            n_out = st.ncols if transpose else st.nrows
            xa = rnd(n_in, f)
            kern = lambda: tsm.stream_spmm(st, xa, transpose)
            plain = lambda: tsm.stream_spmm_ref(st, xa, transpose)
            nbytes = (4 * nb * bm * bk + 4 * nb * (2 if transpose else 1)
                      + 4 * (n_in + n_out) * f)
            dense = _stream_dense(st, transpose)
            lib, lib_label = _library_spmm(dense, bk if transpose else bm,
                                           bm if transpose else bk, xa)
            del dense
        flops = 2 * nb * bm * bk * f
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err, rel = _max_err(got, want, label, name)
        if label == "empty row tiles" and not transpose:
            odd = got.reshape(-1, 128, f)[1::2]
            if torch.count_nonzero(odd):
                fail(f"{name} {label}: rows of row tiles without an entry "
                     f"are not 0")
        del got, want
        ms = time_ms(kern)
        plain_ms = time_ms(plain, reps=3)
        library_ms = time_ms(lib, reps=3)
        t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
        t_flops = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_flops)
        log(f"{name:21s} {label:28s} {'T' if transpose else ' '} "
            f"R={st.nrows} C={st.ncols} F={f} tiles={nb} "
            f"max_abs_err={err:.3e} max_rel_err={rel:.3e} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"({lib_label}) bound_ms={bound_ms:.4f} "
            f"({'bytes' if t_bytes >= t_flops else 'operations'})")
        tot = totals[name]
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["ms"] += mult * ms
        tot["plain_ms"] += mult * plain_ms
        tot["library_ms"] += mult * library_ms
        tot["bound_ms"] += mult * bound_ms
        tot["bytes"] += mult * t_bytes
        tot["flops"] += mult * t_flops
        if name == "stream_sddmm":
            del csr
        torch.cuda.empty_cache()
    return totals


def _small_trainer(dev, model, adj_format="resident", sampler="ladies",
                   ship_cold=True):
    """Phase 4's small input (3000 nodes) and a `Trainer` over it on
    ``dev``: same batches and initial weights on every device, dropout
    0; on the resident and hot paths a float32 hot block, on the resident
    path stream tiles on (off under full expansion, ``ship_cold=False``,
    which rebuilds the cold COO on the device). Returns ``(trainer,
    pipeline, graph)``; the caller closes the pipeline."""
    import torch

    from gnn_tpu_torch.data.synthetic import make_powerlaw_graph
    from gnn_tpu_torch.models.gnn import build_model
    from gnn_tpu_torch.ops.hotdense import HotSpec, build_hot_dense
    from gnn_tpu_torch.ops.residentgraph import build_resident_graph
    from gnn_tpu_torch.placement.engine import compute_sample_prob
    from gnn_tpu_torch.sampling.ladies import SamplerConfig
    from gnn_tpu_torch.sampling.pipeline import BatchPipeline
    from gnn_tpu_torch.train.trainer import Trainer
    from gnn_tpu_torch.utils.normalize import build_laplacian

    g = make_powerlaw_graph(3000, 12, 40, 7, seed=0)
    lap = build_laplacian(g.adj_full, model)
    resident = adj_format == "resident"
    spec = HotSpec.from_sample_prob(
        compute_sample_prob(lap, g.train_nodes, 2), 512) \
        if adj_format in ("hot", "resident") else None
    rg = hot = None
    if spec is not None:
        d, dt = build_hot_dense(lap, spec, torch.float32, dev)
        if resident:
            rg = build_resident_graph(lap, spec, d, dt)
        else:
            hot = (d, dt)
    cfg = SamplerConfig(batch_size=128, samp_num=256, orders=(1, 1),
                        num_nodes=lap.shape[0], num_classes=7,
                        sampler=sampler, adj_format=adj_format,
                        hot_spec=spec, resident_val_free=resident,
                        resident_ship_cold=ship_cold,
                        resident_stream_tiles=resident and ship_cold)
    pipe = BatchPipeline(cfg, lap, g.labels, pool_num=2, seed=0)
    net = build_model(model, 64, (1, 1), 7, n_feats=40, dropout=0.0, seed=0)
    tr = Trainer(net, pipe, g.feats, lr=0.01, sigmoid_loss=False,
                 resident_graph=rg, hot_dense=hot, device=dev)
    return tr, pipe, g


def check_agreement(model, adj_format="resident", sampler="ladies",
                    ship_cold=True):
    """Phase 4: a small input through the port's whole training path on
    the card (CUDA kernels, cuBLAS) and on the CPU (plain versions — the
    path the CPU tests hold against the JAX package), one epoch and a val
    pass (`_small_trainer`). The step losses must agree to AGREE_RTOL
    (float32 sums in another order, carried through Adam steps)."""
    import numpy as np

    label = (f"{model} {adj_format}"
             + (f" {sampler}" if sampler != "ladies" else "")
             + ("" if ship_cold else " full expansion"))
    out = {}
    for dev in ("cuda", "cpu"):
        tr, pipe, g = _small_trainer(dev, model, adj_format, sampler,
                                     ship_cold)
        try:
            m = tr.train_epoch(g.train_nodes, epoch=0)
            f1, vloss = tr.evaluate(g.valid_nodes, 128, "val")
        finally:
            pipe.close()
        out[dev] = (np.asarray(m.step_losses), f1, vloss)
    lc, lp = out["cuda"][0], out["cpu"][0]
    rel = float(np.max(np.abs(lc - lp) / np.abs(lp)))
    log(f"agreement {label} (3000 nodes, {len(lc)} steps): "
        f"cuda losses "
        f"{lc[0]:.5f}..{lc[-1]:.5f}, cpu {lp[0]:.5f}..{lp[-1]:.5f}, max "
        f"rel diff {rel:.2e}; val F1 cuda {out['cuda'][1]:.4f} cpu "
        f"{out['cpu'][1]:.4f}; val loss cuda {out['cuda'][2]:.5f} cpu "
        f"{out['cpu'][2]:.5f}")
    if not (np.all(np.isfinite(lc)) and rel <= AGREE_RTOL):
        fail(f"{label}: cuda and cpu training disagree: max rel diff "
             f"{rel:.3e}")
    if not lc[-1] < lc[0]:
        fail(f"{label}: small-input loss did not fall: {lc}")


def check_multi_epoch(epochs=4):
    """Phase 4: GAT on the resident path over ``epochs`` epochs of the
    small input (`Trainer.fit`, a val pass after each epoch, then the
    test sweep with the best params), on the card and on the CPU. Each
    epoch's train loss, val loss and val F1, and the test F1, must agree
    to AGREE_RTOL."""
    import numpy as np

    out = {}
    for dev in ("cuda", "cpu"):
        tr, pipe, g = _small_trainer(dev, "gat")
        try:
            hist = tr.fit(g.train_nodes, g.valid_nodes, epochs, log=False)
            test_f1 = tr.test(g.test_nodes, 128)
        finally:
            pipe.close()
        out[dev] = np.array([[m.train_loss, m.valid_loss, m.valid_f1]
                             for m in hist] + [[test_f1] * 3])
    c, p = out["cuda"], out["cpu"]
    rel = np.abs(c - p) / np.maximum(np.abs(p), 1e-12)
    for name, col in (("train loss", 0), ("val loss", 1), ("val F1", 2)):
        log(f"multi-epoch GAT resident (3000 nodes, {epochs} epochs) "
            f"{name}: cuda " + " ".join(f"{x:.5f}" for x in c[:-1, col])
            + " cpu " + " ".join(f"{x:.5f}" for x in p[:-1, col])
            + f" max rel diff {rel[:-1, col].max():.2e}")
    log(f"multi-epoch GAT resident test F1: cuda {c[-1, 0]:.5f} cpu "
        f"{p[-1, 0]:.5f} rel diff {rel[-1, 0]:.2e}")
    if not (np.all(np.isfinite(c)) and rel.max() <= AGREE_RTOL):
        fail(f"multi-epoch GAT: cuda and cpu disagree: max rel diff "
             f"{rel.max():.3e}")
    if not c[-2, 0] < c[0, 0]:
        fail(f"multi-epoch GAT: train loss did not fall: {c[:-1, 0]}")


# phase 4's cases: (model, adj_format, sampler, ship_cold)
AGREEMENTS = [
    ("graphsage", "resident", "ladies", True),
    ("gat", "resident", "ladies", True),
    ("graphsage", "blocked", "ladies", True),
    ("gat", "pattern", "ladies", True),
    ("graphsage", "hot", "ladies", True),
    ("graphsage", "resident", "subgraph", True),
    ("graphsage", "resident", "ladies", False),
    ("gat", "resident", "subgraph", True),
]


# the main paths: CLI arguments, and the kernel launches each needs per
# training step (the blocked path runs K2's forward orientation 3 times
# forward and twice over the transposed blocks in the backward; the hot
# format's cold COO runs no kernel of the port's)
MAIN_PATHS = [
    ("graphsage", ["--test"],
     {"edge_stream_spmm.forward": 3, "edge_stream_spmm.transpose": 2}),
    ("gat", ["--model", "gat", "--test"],
     {"cold_attention_rowmax": 3, "cold_attention_terms": 3,
      "cold_attention_terms.bwd_q": 3, "cold_attention_terms.bwd_kv": 3}),
    ("blocked", BLOCKED_ARGS, {"stream_spmm.forward": 5}),
    ("gat pattern", ["--model", "gat", "--adj_format", "pattern", "--test"],
     {"stream_sddmm": 2, "stream_spmm.forward": 2,
      "stream_spmm.transpose": 2}),
    ("hot", ["--adj_format", "hot"], {}),
    ("subgraph", ["--sampler", "subgraph"],
     {"edge_stream_spmm.forward": 3, "edge_stream_spmm.transpose": 2}),
]


def _counters():
    """JSON name -> (launch Counter, key) of every kernel."""
    return {name: (importlib.import_module(
        f"gnn_tpu_torch.ops.{mod}").launches, key)
        for name, (mod, key), _, _ in KERNELS}


def _reset_counters():
    """Every launch counter set to 0; returns them by JSON name."""
    counters = _counters()
    for c, _ in counters.values():
        c.clear()
    return counters


def run_main_path(save_dir, label, argv, per_step):
    """Phase 5: one CLI run (one epoch + val, + the test sweep where
    ``argv`` asks for it), with every launch counter set to 0 just before
    and read just after; returns its kernel launch counts by JSON name."""
    import math

    import torch

    from gnn_tpu_torch import cli

    metrics = os.path.join(save_dir, "metrics.jsonl")
    n_before = sum(1 for _ in open(metrics)) if os.path.exists(metrics) else 0
    counters = _reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(argv + ["--n_devices", "1", "--epoch_num", "1",
                          "--save_dir", save_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: c[key] for name, (c, key) in counters.items()}
    if rc != 0:
        fail(f"{label}: cli.main returned {rc}")
    recs = [json.loads(l) for l in open(metrics)][n_before:]
    ep = next(r for r in recs if "step_losses" in r)
    test_f1 = next((r["test_f1"] for r in recs if "test_f1" in r), None)
    losses, times = ep["step_losses"], ep["step_times"]
    steps = len(losses)
    log(f"main path {label}: {steps} steps in {wall:.1f}s wall (set-up, "
        f"epoch, val{', test sweep' if test_f1 is not None else ''})")
    log("step losses: " + " ".join(f"{v:.4f}" for v in losses))
    log("step seconds: " + " ".join(f"{v:.3f}" for v in times))
    steady = sorted(times[1:]) or times
    log(f"median step seconds (after the first): "
        f"{steady[len(steady) // 2]:.4f}")
    log(f"val F1 {ep['valid_f1']:.4f}  val loss {ep['valid_loss']:.4f}"
        + (f"  test F1 {test_f1:.4f}" if test_f1 is not None else ""))
    log(f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    log(f"kernel launches on the {label} main path: "
        f"{ {k: v for k, v in counts.items() if v} }")
    if steps == 0 or not all(math.isfinite(v) for v in losses):
        fail(f"{label}: non-finite or missing losses: {losses}")
    last5 = sum(losses[-5:]) / len(losses[-5:])
    if not last5 < losses[0]:
        fail(f"{label}: loss did not fall: first {losses[0]}, last-5 mean "
             f"{last5}")
    for name, n in per_step.items():
        if counts[name] < n * steps:
            fail(f"{label}: {name} launches {counts[name]} < {n} x {steps}")
    if test_f1 is not None and not (0.0 <= test_f1 <= 1.0):
        fail(f"{label}: test F1 out of range: {test_f1}")
    return counts


def run_probe_path(save_dir, device):
    """Phase 5: the probe (``tools/torch_edgestream_probe.py``) on one
    default batch, with every launch counter set to 0 just before and
    read just after: the COO, K1 and K6 on each layer's cold residual,
    both directions. Fails unless K6 launched and every K1 / K6 result
    agrees with the COO one to REL_TOL. Returns the launch counts."""
    import torch
    probe = load_probe()
    counters = _reset_counters()
    t0 = time.perf_counter()
    adjs, widths, _ = probe.default_batch(save_dir, device)
    recs = probe.run_probe(probe.seg_cases(adjs, widths), iters=16,
                           log=log)
    torch.cuda.synchronize()
    counts = {name: c[key] for name, (c, key) in counters.items()}
    log(f"probe path: {len(recs)} layer-directions in "
        f"{time.perf_counter() - t0:.1f}s wall; kernel launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    for r in recs:
        for k in ("k1", "k6"):
            if not (r[f"{k}_finite"]
                    and r[f"{k}_err"] <= REL_TOL * r["scale"] + 1e-6):
                fail(f"probe layer {r['layer']} {r['direction']}: {k} "
                     f"max abs err {r[f'{k}_err']:.3e} vs max |coo| "
                     f"{r['scale']:.3e}")
    if counts["edge_stream_spmm_seg"] == 0:
        fail("probe path: K6 was never launched")
    return counts


def _kernel_entry(name, source, replaces, launches, t):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches),
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes"] >= t["flops"]
                         else "operations"),
            "library_ms": t.get("library_ms")}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; nothing to drive",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "gnn_tpu_torch")):
        print("chip_smoke: gnn_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from gnn_tpu_torch import cli
    from gnn_tpu_torch.ops import cuda_build

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    # the card's name and power limit, as nvidia-smi prints them
    log(smi.stdout.strip())
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    secs = build_kernels()
    log(f"kernel build: {secs:.1f}s "
        f"({ {k: round(v, 1) for k, v in cuda_build.BUILD_SECONDS.items()} })")

    nhid = cli.build_parser().parse_args([]).nhid
    save_dir = tempfile.mkdtemp(prefix="gnn_tpu_torch_smoke_")
    t0 = time.perf_counter()
    try:
        adjs, widths, pattern = main_path_batch(save_dir, device)
        sub_adjs, sub_widths, _ = load_probe().default_batch(
            save_dir, device, ["--sampler", "subgraph"])
        k1 = check_edge_stream(adjs, widths, device, sub_adjs, sub_widths)
        del sub_adjs
        seg = check_seg(adjs, widths, device)
        attn = check_attention(adjs, device, nhid)
        del adjs
        blocked, bwidths = blocked_batch(device)
        tiles = check_tile_kernels(blocked, bwidths, pattern, device, nhid)
        del blocked, pattern
        torch.cuda.empty_cache()
        log(f"phase 3 (kernel checks): {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        for case in AGREEMENTS:
            check_agreement(*case)
        check_multi_epoch()
        log(f"phase 4 (agreements): {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        counts = dict.fromkeys((k[0] for k in KERNELS), 0)
        for label, argv, per_step in MAIN_PATHS:
            for name, n in run_main_path(save_dir, label, argv,
                                         per_step).items():
                counts[name] += n
        for name, n in run_probe_path(save_dir, device).items():
            counts[name] += n
        log(f"phase 5 (main paths, probe): {time.perf_counter() - t0:.1f}s")
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)

    measured = {f"edge_stream_spmm.{d}": k1[d]
                for d in ("forward", "transpose")}
    measured.update({name: {**attn[key], "library_ms": None}
                     for name, (_, key), _, _ in KERNELS
                     if key in ATTN_KEYS})
    measured.update(tiles)
    measured["edge_stream_spmm_seg"] = seg
    kernels = [_kernel_entry(name, source, replaces, counts[name],
                             measured[name])
               for name, _, source, replaces in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
