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
   cluster size; the four additive attention kernels of gatv1 (add_rowmax,
   add_terms, add_bwd_q, add_bwd_kv) at its widths (4 x 256, 4 x 256,
   6 x 41), each timed beside its plain version and bound; the hot part's
   kernels on its live entries (the mask pass, rowmax, terms, bwd_row,
   bwd_col of ``hot_attention.cu``) on the same batch's resident layers
   at those widths, the mask and row max exact, each timed beside its
   plain version (the dense grid) and bound; the dot-product hot modes
   of gat (dot_rowmax, dot_terms, dot_bwd_row, dot_bwd_col) on the same
   layers at gat's width (one head of 512), each timed beside its plain
   version and bound, and each layer's live route (mask pass, row max,
   terms, backward) beside the grid route it replaced, with their times
   and the memory each allocates.
   The stream SpMM (K2) runs at the three layers of one blocked batch (50k nodes / degree 30, batch 512,
   samp_num 2048; widths 602 / 1024 / 1024) over ``block_*`` and over
   the transposed ``block_*_t``, and K2 in both orientations and the
   stream SDDMM (K5) at GAT's tile layer of one default pattern batch
   (2048 x 10240, all 1280 tiles, width 512), plus a 4-head case, a case
   with empty row tiles, one with BlockedAdj padding tiles, and K2 both
   ways on blocked layer 2's tiles made dense and with a hub row and
   column. Each case prints its error, the kernel's time (CUDA events),
   the plain version's time, the bound (the larger of the bytes over the
   memory rate and the float32 flops the function needs over the float32
   rate: K2's are those of the tiles' nonzeros, printed with their
   density) and, where one PyTorch call computes the same function, that
   call's time (a yardstick the port never calls): ``torch.sparse.mm``
   over a CSR of K1's and K6's weighted edges, over a CSR of K2's
   nonzeros and over a BSR of its tiles (where the card's PyTorch takes
   BSR; the faster one is the yardstick), ``torch.sparse.sampled_addmm``
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
6. the single-device extras at the CLI defaults, each CLI run with the
   launch counters set to 0 just before and read just after, in
   directories that share phase 5's set-up caches: (a) ``--locality_sampling
   --scale_factor 4 --op_timing --profile_dir``, two epochs: every epoch's
   spmm buckets finite and above 0 and its communication bucket 0.0, K1
   launched more often than the steps and val passes account for (the
   op-timing probe times K1 both ways on every layer), a trace of epoch 1
   that names K1's kernel, a falling loss; then one epoch at factor 1:
   the share of epoch 0's layer-0 input nodes in the skew set, as each
   run logs it, must rise from factor 1 to factor 4. (b) Resume, with an
   lr warmup that spans epoch 2: three epochs uninterrupted, against two
   epochs and then ``--epoch_num 3 --resume``: the resumed run trains
   epoch 2 only, and its train and val loss and step losses agree with
   the uninterrupted run's to RESUME_RTOL; two resumes from a broken
   copy of the checkpoint (update count 0; no optimizer state) must miss
   by more;
7. two data-parallel ranks on the one card (gloo collectives; NCCL
   refuses two ranks on one device), each rank a process that counts its
   own kernel launches and writes them, its step losses and its
   parameter digests to its run directory: (a) phase 4's small input,
   GraphSAGE resident, two epochs with the replicated table and two
   with ``CachedFeatures``, on the card and on the CPU: the ranks agree
   bit for bit, the card's step losses agree with the CPU's to
   AGREE_RTOL, the cache's with the replicated table's to DP_CACHE_RTOL
   (exactly on the CPU); (b) the CLI defaults with ``--n_devices 2
   --dist_backend gloo --feature_cache --op_timing --epoch_num 2 --test``
   in a directory sharing phase 5's set-up caches: bitwise equal
   parameters after each epoch, a falling loss, a communication bucket
   above 0, each rank's K1 launches accounted for by its steps, val
   passes, test batches and op-timing probe; it logs each rank's shares
   of layer-0 input rows from its own buffer, its peer's and the host,
   the bytes its all-to-all received a step and its median step (both
   ranks share one card's SMs: not a multi-GPU speed figure);
8. the part-sharded grid (``--resident_parts``) on the one card, every
   rank a gloo process on ``cuda:0`` that counts its own kernel launches
   and writes them, its step losses, parameter digests and memory figures
   to its run directory: (a) phase 4's small input, one epoch a case on
   the card and on the CPU: GraphSAGE on one data rank x 2 part ranks
   with the node-range feature shards and with the composed cache, in
   full expansion, and GAT; GraphSAGE on 2 x 2 ranks. Every rank of a
   grid holds the same parameters after each epoch, the card agrees with
   the CPU to AGREE_RTOL, and each case with the same run unsharded (one
   rank, or phase 7's two data ranks) to PART_RTOL; (b) the CLI defaults
   with ``--n_devices 1 --resident_parts 2 --dist_backend gloo
   --feature_cache --op_timing --epoch_num 1 --test``: equal digests, a
   falling loss, a communication bucket above 0, each rank's K1 launches
   accounted for, each rank's resident graph half of phase 5's (within
   the node ranges' padding), its feature buffer at most half of phase
   5's table and its peak memory after set-up below phase 5's; it logs
   the bytes each rank sums over its part group a step, the shares of
   layer-0 rows from the own part, the other part and the host, and the
   median step (not a multi-GPU speed figure); (c) the same with
   ``--model gat`` and no test sweep: equal digests, finite losses, K3
   and K4 launched phase 5's GAT counts a step (and a val pass), no hot
   kernel (a part's shard keeps the dense hot grid);
9. the entry points and the halo full-graph trainer: (a)
   ``gnn_tpu_torch.entry``: ``entry``'s forward on the card against the
   CPU's, then ``dryrun_multichip(4)``, four gloo ranks on ``cuda:0`` in
   one spawn, one epoch a case of every sharded path (data parallelism
   with the cache and the hot format, resident, resident with stream
   tiles, GAT hot-block attention without and with stream tiles, and on
   2 x 2 ranks the part-sharded resident graph, full expansion, the
   composed cache and the hybrid DP x cache mode, then one halo step),
   each rank counting its kernel launches a case: every loss finite,
   each rank's sharded resident bytes at most 1.06 / P of the whole
   state, K1 launched in the stream-tile case and K3 / K4 in GAT's; (b)
   the halo trainer on the gcn Laplacian of the default synthetic graph
   (orders 1,1,1, nhid 512, softmax CE), HALO_STEPS steps on one rank
   and on two gloo ranks sharing the card (which attach the graph from a
   ``GraphBundle`` this process publishes): the step losses agree to
   HALO_RTOL and fall below the first at some step; it logs the
   Laplacian's nnz, the plan's halo width, the halo bytes a rank sends a
   step, each run's median step, peak memory and set-up seconds (not
   multi-GPU figures); (c) the
   tests' small graph, three steps on two ranks on the card and on the
   CPU: the step losses agree to AGREE_RTOL;
10. grouped dispatch, four pairs of runs at the CLI defaults, two
   epochs and a val pass each, eagerly and at ``--steps_per_dispatch 8``
   (one CUDA graph replay of 8 steps a group; the 6-step tail replays
   the one-step graph 6 times), in one process and in directories
   sharing phase 5's set-up caches: the default path (K1), ``--model
   gat`` (the resident path, K3 and K4 inside the graphs), ``--adj_format
   hot`` and ``--adj_format coo`` (no kernel of the port's). Each pair:
   every step loss of the grouped run within 1e-3 relative of the eager
   run's, the val F1s within 1e-3, every graph recording the path's
   per-step kernel launches (phase 5's counts) for each of its steps,
   exactly and no other (K1 3 forward and 2 transposed; K3, K4 terms,
   bwd_q and bwd_kv 3 each and, on GAT's, the hot part's mask pass and
   four dot modes 3 each; none on the hot and coo formats), the
   replays covering every step, at most one capture in the second
   epoch, every capture logged. The kernels' launches in the replays
   are each graph's recorded launches times its replays, since a
   wrapper's counter sees a capture once and a replay never. It logs
   each run's median step of epoch 1, its captures and their seconds and
   its peak memory (flagged above 4 GB), beside the card. Then
   ``--model gatv1 --nhid 1024`` at G = 8 alone (its own checks are
   against the CPU and G = 1 in the card tests): finite step losses,
   every graph recording exactly 3 launches of each additive kernel and
   of each hot kernel (mask, rowmax, terms, bwd_row, bwd_col) for each
   of its steps and no other, the replays covering every step;
11. a ``kernels`` JSON line (every kernel of the port, the additive
   ones with no TPU kernel they replace), then the result line
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
KERNEL_SOURCES = ["edge_stream", "edge_attention", "hot_attention",
                  "stream_spmm"]
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
    # gatv1's additive score source: no TPU kernel computes this score
    ("cold_attention_additive_rowmax", ("esattn", "add_rowmax"),
     "gnn_tpu_torch/csrc/edge_attention.cu", None),
    ("cold_attention_additive_terms", ("esattn", "add_terms"),
     "gnn_tpu_torch/csrc/edge_attention.cu", None),
    ("cold_attention_additive_terms.bwd_q", ("esattn", "add_bwd_q"),
     "gnn_tpu_torch/csrc/edge_attention.cu", None),
    ("cold_attention_additive_terms.bwd_kv", ("esattn", "add_bwd_kv"),
     "gnn_tpu_torch/csrc/edge_attention.cu", None),
    # gatv1's hot part on its live entries: no TPU kernel either
    ("hot_attention.mask", ("hotattn", "mask"),
     "gnn_tpu_torch/csrc/hot_attention.cu", None),
    ("hot_attention.rowmax", ("hotattn", "rowmax"),
     "gnn_tpu_torch/csrc/hot_attention.cu", None),
    ("hot_attention.terms", ("hotattn", "terms"),
     "gnn_tpu_torch/csrc/hot_attention.cu", None),
    ("hot_attention.terms.bwd_row", ("hotattn", "bwd_row"),
     "gnn_tpu_torch/csrc/hot_attention.cu", None),
    ("hot_attention.terms.bwd_col", ("hotattn", "bwd_col"),
     "gnn_tpu_torch/csrc/hot_attention.cu", None),
    # gat's hot part on its live entries: the dense grid it replaces was
    # XLA's matmuls, no TPU kernel
    ("hot_attention.dot_rowmax", ("hotattn", "dot_rowmax"),
     "gnn_tpu_torch/csrc/hot_attention.cu", None),
    ("hot_attention.dot_terms", ("hotattn", "dot_terms"),
     "gnn_tpu_torch/csrc/hot_attention.cu", None),
    ("hot_attention.dot_terms.bwd_row", ("hotattn", "dot_bwd_row"),
     "gnn_tpu_torch/csrc/hot_attention.cu", None),
    ("hot_attention.dot_terms.bwd_col", ("hotattn", "dot_bwd_col"),
     "gnn_tpu_torch/csrc/hot_attention.cu", None),
]
ATTN_KEYS = ["rowmax", "terms", "bwd_q", "bwd_kv"]
# the additive score source's kernels (gatv1), timed at gatv1's widths:
# per layer (heads, features a head) at nhid 1024 and 41 classes
ADD_KEYS = ["add_rowmax", "add_terms", "add_bwd_q", "add_bwd_kv"]
GATV1_LAYERS = [(4, 256), (4, 256), (6, 41)]
# the hot part's kernels on its live entries (gatv1), at the same widths
HOT_KEYS = ["mask", "rowmax", "terms", "bwd_row", "bwd_col"]
# gat's hot part on its live entries (the mask pass above and the dot
# modes), at gat's width (one head of nhid)
DOT_KEYS = ["dot_rowmax", "dot_terms", "dot_bwd_row", "dot_bwd_col"]
# per-step launches of the hot part on its live entries: the mask pass
# and the dot modes once a layer (gat's three)
GAT_HOT_PER_STEP = {name: 3 for name, (mod, key), _, _ in KERNELS
                    if mod == "hotattn" and key in ["mask"] + DOT_KEYS}
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


def card():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


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
    if sorted(cuda_build.build_all()) != sorted(KERNEL_SOURCES):
        fail(f"the sources in gnn_tpu_torch/csrc are not {KERNEL_SOURCES}")
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
            "rowmax": (lambda: ea.cold_rowmax(*t[:3], (q, k), **kw),
                       lambda: ea.cold_attention_rowmax_ref(*t[:3], q, k,
                                                            **kw)),
            "terms": (lambda: ea.cold_terms(*t, (q, k), v, rm, **kw),
                      lambda: ea.cold_attention_terms_ref(*t, q, k, v, rm,
                                                          **kw)),
            "bwd_q": (lambda: ea.cold_backward("bwd_q", *t, (q, k), v, rm,
                                               gd, gn, **kw),
                      lambda: ea.cold_attention_bwd_q_ref(*t, q, k, v, rm,
                                                          gd, gn, **kw)),
            "bwd_kv": (lambda: ea.cold_backward("bwd_kv", *t, (q, k), v, rm,
                                                gd, gn, **kw),
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
    """The yardsticks for K2: one ``torch.sparse.mm`` over a CSR of the
    tiles' nonzeros, and one over a BSR tensor of the same ``(bm, bk)``
    tiles where the card's PyTorch takes BSR. Returns ``[(fn, label)]``."""
    import torch
    csr = dense.to_sparse_csr()
    out = [((lambda: torch.sparse.mm(csr, x)), "CSR")]
    try:
        bsr = dense.to_sparse_bsr((bm, bk))
        torch.sparse.mm(bsr, x)
        torch.cuda.synchronize()
        out.append(((lambda: torch.sparse.mm(bsr, x)), "BSR"))
    except (RuntimeError, NotImplementedError, TypeError) as e:
        log(f"  (torch.sparse.mm refuses BSR here: {str(e)[:100]})")
        torch.cuda.synchronize()
    return out


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


def tile_cases(blocked, bwidths, pattern, device, nhid, gen):
    """Phase 3's K2 / K5 cases: ``(label, kernel name, stream, F,
    transpose, mult)``, ``mult`` = launches of the case per step of the
    main paths that run it. The three blocked layers over ``block_*`` and
    over ``block_*_t``; GAT's tile layer of one default pattern batch
    (attention-like tile values: the layer's 0/1 mask times positive
    random numbers), one head and four; a stream whose odd row tiles have
    no entry; a blocked layer with padding tiles; blocked layer 2's tiles
    fully dense, and with a hub row and column in every tile."""
    import torch

    from gnn_tpu_torch.models.gat import _coo_to_tilewise
    from gnn_tpu_torch.ops import spmm as tsm

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
    # blocked L2's tiles fully dense, and with a hub row and a hub column
    # (row 5 and column 7 of every tile full), both orientations
    rc, v = tsm._blocked_to_stream_arrays(b2.block_cols, b2.block_vals)
    hub = v.clone()
    hub[:, 5, :] = torch.rand(hub[:, 5, :].shape, generator=gen,
                              device=device) + 0.5
    hub[:, :, 7] = torch.rand(hub[:, :, 7].shape, generator=gen,
                              device=device) + 0.5
    for label, vals in (("dense tiles (L2)", rnd(*v.shape)),
                        ("hub row+col (L2)", hub)):
        st = tsm.StreamBlocks(blk_rc=rc, vals=vals, nrows=b2.nrows,
                              ncols=b2.ncols, bm=b2.bm, bk=b2.bk)
        for transpose in (False, True):
            cases.append((label, "stream_spmm.transpose" if transpose
                          else "stream_spmm.forward", st, bwidths[2],
                          transpose, 0))

    return cases


def check_tile_kernels(blocked, bwidths, pattern, device, nhid):
    """Phase 3: the stream SpMM (K2, both orientations) and SDDMM (K5)
    against their plain versions on ``tile_cases``. Returns, per kernel,
    the per-step sums over one step of each main path that runs it."""
    import torch

    from gnn_tpu_torch.ops import sddmm as tsd
    from gnn_tpu_torch.ops import spmm as tsm
    gen = torch.Generator(device=device).manual_seed(2)
    names = ("stream_spmm.forward", "stream_spmm.transpose", "stream_sddmm")
    totals = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                      max_abs_err=0.0, bytes=0.0, flops=0.0) for n in names}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)

    cases = tile_cases(blocked, bwidths, pattern, device, nhid, gen)
    for label, name, st, f, transpose, mult in cases:
        nb, bm, bk = st.blk_rc.shape[0], st.bm, st.bk
        nnz = nb * bm * bk
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
            libs = [((lambda: torch.sparse.sampled_addmm(csr, xa, yt,
                                                         beta=0.0)),
                     "sampled_addmm")]
        else:
            n_in = st.nrows if transpose else st.ncols
            n_out = st.ncols if transpose else st.nrows
            xa = rnd(n_in, f)
            kern = lambda: tsm.stream_spmm(st, xa, transpose)
            plain = lambda: tsm.stream_spmm_ref(st, xa, transpose)
            # every tile read once, x and y once; the products are those
            # of the tiles' nonzeros (the function's work, not the dense
            # tiles' 2 * nb * bm * bk * F)
            nbytes = (4 * nb * bm * bk + 4 * nb * (2 if transpose else 1)
                      + 4 * (n_in + n_out) * f)
            nnz = int(torch.count_nonzero(st.vals))
            dense = _stream_dense(st, transpose)
            libs = _library_spmm(dense, bk if transpose else bm,
                                 bm if transpose else bk, xa)
            del dense
        flops = 2 * nnz * f
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
        lib_ms = {lab: time_ms(fn, reps=3) for fn, lab in libs}
        lib_label = min(lib_ms, key=lib_ms.get)
        library_ms = lib_ms[lib_label]
        del libs
        t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
        t_flops = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_flops)
        log(f"{name:21s} {label:28s} {'T' if transpose else ' '} "
            f"R={st.nrows} C={st.ncols} F={f} tiles={nb} nnz={nnz} "
            f"density={nnz / max(nb * bm * bk, 1):.5f} "
            f"max_abs_err={err:.3e} max_rel_err={rel:.3e} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} "
            + " ".join(f"{lab}_ms={t:.4f}" for lab, t in lib_ms.items())
            + f" library_ms={library_ms:.4f} ({lib_label}) "
            f"bound_ms={bound_ms:.4f} "
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
                   ship_cold=True, ctx=None, cached=False):
    """Phase 4's small input (3000 nodes) and a `Trainer` over it on
    ``dev``: same batches and initial weights on every device, dropout
    0; on the resident and hot paths a float32 hot block, on the resident
    path stream tiles on (off under full expansion, ``ship_cold=False``,
    which rebuilds the cold COO on the device). With ``ctx`` (phases 7
    and 8), the trainer of rank ``ctx.rank``, of data rank
    ``ctx.data_rank`` and, on a grid of part ranks (phase 8), with the
    resident graph sharded over its part group and the features in
    node-range shards (`PartShardedFeatures`). With ``cached``, the
    features through `CachedFeatures` (or, on a grid, `PartCachedFeatures`)
    over the greedy placement of 20% of the nodes a buffer, a buffer a
    data rank (a part) (alpha 0, the CLI's default). Returns
    ``(trainer, pipeline, graph)``; the caller closes the pipeline."""
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
    ws, rank = (1, 0) if ctx is None else (ctx.dp, ctx.data_rank)
    parts = 1 if ctx is None else ctx.parts
    pipe = BatchPipeline(cfg, lap, g.labels, pool_num=2, seed=0,
                         world_size=ws, rank=rank)
    net = build_model(model, 64, (1, 1), 7, n_feats=40, dropout=0.0, seed=0)
    from gnn_tpu_torch.parallel import feature_cache as fc
    source = None
    if cached:
        from gnn_tpu_torch.placement.engine import create_placement
        placement = create_placement(lap, g.train_nodes,
                                     per_dev=lap.shape[0] // 5,
                                     num_devs=ws if parts == 1 else parts,
                                     num_conv_layers=2, alpha=0.0)
        source = (fc.CachedFeatures(g.feats, placement, ctx) if parts == 1
                  else fc.PartCachedFeatures(g.feats, placement, ctx.part,
                                             device=dev))
    elif parts > 1:
        source = fc.PartShardedFeatures(g.feats, ctx.part, device=dev)
    tr = Trainer(net, pipe, g.feats, lr=0.01, sigmoid_loss=False,
                 resident_graph=rg, hot_dense=hot, device=dev,
                 feature_source=source, dist=ctx, resident_parts=parts)
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
      "cold_attention_terms.bwd_q": 3, "cold_attention_terms.bwd_kv": 3,
      **GAT_HOT_PER_STEP}),
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


def run_cli(save_dir, argv):
    """``gnn_tpu_torch.cli.main(argv)`` with ``--save_dir save_dir``, every
    launch counter set to 0 just before and read just after. Returns the
    metrics records the run appended, its kernel launch counts by JSON
    name, and its wall seconds."""
    import torch

    from gnn_tpu_torch import cli

    metrics = os.path.join(save_dir, "metrics.jsonl")
    n_before = sum(1 for _ in open(metrics)) if os.path.exists(metrics) else 0
    counters = _reset_counters()
    t0 = time.perf_counter()
    rc = cli.main(argv + ["--save_dir", save_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: c[key] for name, (c, key) in counters.items()}
    if rc != 0:
        fail(f"{argv}: cli.main returned {rc}")
    return [json.loads(l) for l in open(metrics)][n_before:], counts, wall


def run_main_path(save_dir, label, argv, per_step):
    """Phase 5: one CLI run (one epoch + val, + the test sweep where
    ``argv`` asks for it), with every launch counter set to 0 just before
    and read just after; returns its kernel launch counts by JSON name
    and its rank record (``rank0.json``: the resident state's bytes, the
    peak memory after set-up)."""
    import math

    import torch

    torch.cuda.reset_peak_memory_stats()
    recs, counts, wall = run_cli(save_dir, argv + ["--n_devices", "1",
                                                   "--epoch_num", "1"])
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
    with open(os.path.join(save_dir, "rank0.json")) as f:
        return counts, json.load(f)


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


# phase 6: K1's launches per training step of the default path (phase 5),
# and K1's __global__ function in csrc/edge_stream.cu (a profiler trace
# names it)
DEFAULT_PER_STEP = MAIN_PATHS[0][2]
K1_KERNEL = "edge_stream_kernel"
# the resumed run's epoch against the uninterrupted run's (train and val
# loss, and each step's loss): K1 sums in a run-dependent order, so the
# runs agree closely but not bit for bit. Readings at full width (H100):
# sound resumes 1e-8 to 5.4e-6; a resume that lost the update count
# 8.1e-4 on the train loss, one that lost the optimizer state 1.2e-3
RESUME_RTOL = 1e-4
# the resume runs' lr warmup: longer than two epochs of 30 steps, so that
# epoch 2 still warms up and a resume that lost the update count shows
RESUME_WARMUP = 90


def linked_dir(save_dir, name):
    """A new directory ``name`` in ``save_dir`` with hard links to its
    set-up caches (the placement, the sample probabilities and the hot
    block's COO, the ``.npy`` / ``.npz`` files) and none of its
    checkpoints or metrics."""
    d = os.path.join(save_dir, name)
    os.makedirs(d)
    for f in os.listdir(save_dir):
        if f.endswith((".npy", ".npz")):
            os.link(os.path.join(save_dir, f), os.path.join(d, f))
    return d


def log_epochs(label, recs):
    """Each epoch record's buckets, losses and step seconds; returns the
    epoch records."""
    eps = [r for r in recs if "step_losses" in r]
    for r in eps:
        times = r["step_times"]
        steady = sorted(times[1:]) or times
        log(f"{label} epoch {r['epoch']}: {len(times)} steps, scale_factor "
            f"{r['scale_factor']}, total_s {r['total_s']:.3f}, sample_wait_s "
            f"{r['sample_wait_s']:.3f}, data_movement_s "
            f"{r['data_movement_s']:.3f}, execution_s "
            f"{r['execution_s']:.3f}, spmm_fwd_s {r['spmm_fwd_s']:.4f}, "
            f"spmm_bwd_s {r['spmm_bwd_s']:.4f}, communication_s "
            f"{r['communication_s']}, skew_share {r['skew_share']:.4f}, "
            f"median step s "
            f"{steady[len(steady) // 2]:.4f}, train loss "
            f"{r['train_loss']:.5f}, val loss {r['valid_loss']:.5f}, val F1 "
            f"{r['valid_f1']:.4f}")
        log(f"{label} epoch {r['epoch']} step seconds: "
            + " ".join(f"{v:.3f}" for v in times))
    return eps


def k1_trace_ms(path):
    """K1's kernels in a Chrome trace: their count and summed device ms."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    k1 = [e for e in events if e.get("cat") == "kernel"
          and K1_KERNEL in e.get("name", "")]
    return len(k1), sum(e.get("dur", 0.0) for e in k1) / 1e3


def run_extras(save_dir):
    """Phase 6 (a): the default CLI run with ``--locality_sampling
    --scale_factor 4 --op_timing --profile_dir``, two epochs. Every
    epoch's spmm buckets must be finite and above 0 and its communication
    bucket 0.0; K1 must launch more often than the training steps and val
    passes account for (the op-timing probe times K1 both ways on every
    layer); the trace of epoch 1 must name K1's kernel; the loss must
    fall. Returns the run's launch counts."""
    import math

    d = linked_dir(save_dir, "extras")
    prof = os.path.join(d, "profile")
    recs, counts, wall = run_cli(d, [
        "--n_devices", "1", "--epoch_num", "2", "--locality_sampling",
        "--scale_factor", "4", "--op_timing", "--profile_dir", prof])
    eps = log_epochs("extras", recs)
    steps = sum(len(r["step_losses"]) for r in eps)
    losses = [v for r in eps for v in r["step_losses"]]
    log(f"extras run: {len(eps)} epochs, {steps} steps in {wall:.1f}s wall; "
        f"kernel launches { {k: v for k, v in counts.items() if v} }")
    if len(eps) != 2 or not all(math.isfinite(v) for v in losses):
        fail(f"extras: missing epochs or non-finite losses: {losses}")
    last5 = sum(losses[-5:]) / 5
    if not last5 < losses[0]:
        fail(f"extras: loss did not fall: first {losses[0]}, last-5 mean "
             f"{last5}")
    for r in eps:
        if not (math.isfinite(r["spmm_fwd_s"]) and r["spmm_fwd_s"] > 0
                and math.isfinite(r["spmm_bwd_s"]) and r["spmm_bwd_s"] > 0
                and r["communication_s"] == 0.0):
            fail(f"extras epoch {r['epoch']}: op-timing buckets "
                 f"{r['spmm_fwd_s']}, {r['spmm_bwd_s']}, "
                 f"{r['communication_s']}")
    # the steps launch per_step each; every val pass one forward a layer
    for name, n in DEFAULT_PER_STEP.items():
        floor = n * steps + (3 * len(eps) if name.endswith("forward") else 0)
        log(f"{name}: {counts[name]} launches, {floor} from the steps and "
            f"val passes")
        if counts[name] <= floor:
            fail(f"extras: {name} launches {counts[name]} <= {floor}: the "
                 f"op-timing probe did not launch K1")
    traces = os.listdir(prof)
    if traces != ["trace_epoch1.json"]:
        fail(f"extras: profile directory holds {traces}")
    trace = os.path.join(prof, traces[0])
    n_k1, k1_ms = k1_trace_ms(trace)
    ep1 = eps[1]
    log(f"trace {os.path.getsize(trace)} bytes: {n_k1} K1 kernels "
        f"({K1_KERNEL}), {k1_ms:.3f} ms of device time over epoch 1's "
        f"{len(ep1['step_losses'])} steps; op-timing buckets of epoch 1 "
        f"(hot block + K1, isolated, times the steps): "
        f"{1e3 * (ep1['spmm_fwd_s'] + ep1['spmm_bwd_s']):.3f} ms")
    if n_k1 == 0:
        fail(f"extras: the trace does not name {K1_KERNEL}")
    # epoch 0 at factor 1: the same targets and sampling seeds
    recs1, counts1, wall1 = run_cli(linked_dir(save_dir, "factor1"), [
        "--n_devices", "1", "--epoch_num", "1", "--locality_sampling",
        "--scale_factor", "1"])
    share1 = log_epochs("factor 1", recs1)[0]["skew_share"]
    share4 = eps[0]["skew_share"]
    log(f"factor 1 run: {wall1:.1f}s wall; epoch 0's layer-0 input nodes "
        f"in the skew set: {share1:.4f} at factor 1, {share4:.4f} at "
        f"factor 4")
    if not share4 > share1:
        fail(f"locality: factor 4 does not raise the skew share: {share1} "
             f"-> {share4}")
    return {k: counts[k] + counts1[k] for k in counts}


def broken_copy(save_dir, src, name, breaks):
    """A directory ``name`` like ``linked_dir``'s, holding a copy of
    ``src``'s checkpoints in which ``breaks(payload)`` has changed the
    latest one."""
    import torch

    from gnn_tpu_torch.train.checkpoint import checkpoint_path
    d = linked_dir(save_dir, name)
    for ck in ("latest", "best"):
        if os.path.exists(checkpoint_path(src, ck)):
            shutil.copy(checkpoint_path(src, ck), checkpoint_path(d, ck))
    path = checkpoint_path(d, "latest")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    breaks(payload)
    torch.save(payload, path)
    return d


def _lose_count(payload):
    payload["n_updates"] = 0


def _lose_optimizer(payload):
    del payload["opt_state"], payload["n_updates"]


def run_resume(save_dir):
    """Phase 6 (b), with an lr warmup of RESUME_WARMUP steps: run A trains
    3 epochs uninterrupted; run B trains 2, then resumes with
    ``--epoch_num 3 --resume`` in its directory. The resumed run must
    train exactly epoch 2, with its train and val loss and each step's
    loss within RESUME_RTOL of run A's epoch 2. Two more resumes start
    from copies of run B's checkpoint that lost the update count or the
    optimizer state; each must miss run A's epoch 2 by more than
    RESUME_RTOL on one of those, or the check could not see such a
    fault. Returns the launch counts of the five runs."""
    base = ["--n_devices", "1", "--lr_warmup", str(RESUME_WARMUP)]
    resume = ["--epoch_num", "3", "--resume"]
    a_dir, b_dir = linked_dir(save_dir, "run_a"), linked_dir(save_dir,
                                                             "run_b")
    total = {}
    eps = {}

    def run(label, d, argv):
        recs, counts, wall = run_cli(d, base + argv)
        eps[label] = log_epochs(label, recs)
        log(f"{label}: {wall:.1f}s wall")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    run("run A", a_dir, ["--epoch_num", "3"])
    run("run B", b_dir, ["--epoch_num", "2"])
    broken = [(label, broken_copy(save_dir, b_dir, name, breaks))
              for label, name, breaks in (
                  ("resumed without the update count", "lost_count",
                   _lose_count),
                  ("resumed without the optimizer state", "lost_opt",
                   _lose_optimizer))]
    run("run B resumed", b_dir, resume)
    for label, d in broken:
        run(label, d, resume)
    want = eps["run A"][2]
    for label in ["run B resumed"] + [label for label, _ in broken]:
        got = eps[label]
        if [r["epoch"] for r in got] != [2]:
            fail(f"resume: {label} trained epochs "
                 f"{[r['epoch'] for r in got]}, not [2]")
        rel = {key: abs(got[0][key] - want[key]) / abs(want[key])
               for key in ("train_loss", "valid_loss")}
        rel["step_losses"] = max(
            abs(g - w) / abs(w)
            for g, w in zip(got[0]["step_losses"], want["step_losses"]))
        log(f"resume: epoch 2 {label} against uninterrupted, rel diff: "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
            + f" (train loss {got[0]['train_loss']:.6f} against "
            f"{want['train_loss']:.6f})")
        worst = max(rel.values())
        if label == "run B resumed" and not worst <= RESUME_RTOL:
            fail(f"resume: epoch 2 differs by {worst:.3e}")
        if label != "run B resumed" and not worst > RESUME_RTOL:
            fail(f"resume: {label} agrees to {worst:.3e}, within "
                 f"RESUME_RTOL: the check cannot see that fault")
    return total


# phase 7: two data-parallel ranks through gloo, both on the one card.
# The card's runs against the CPU's agree to AGREE_RTOL; the cached runs'
# step losses against the replicated ones to DP_CACHE_RTOL, K1's
# run-to-run noise (the gather is exact; K1 sums in a run-dependent order,
# and its reruns of one configuration read 1e-8 to 5.4e-6 apart, phase 6)
DP_CACHE_RTOL = 1e-4
DP_WORLD = 2
# the longest phase 7 waits on a rank or a collective before failing
DP_JOIN_TIMEOUT_S = 600.0
DP_COLLECTIVE_TIMEOUT_S = 300.0
DP_EPOCHS = 2


# the card's ranks also run the CPU reference: one spawn a world serves
# both (the same gloo groups; a CPU run's tensors stay on the CPU)
REF_DEVICES = ("cuda", "cpu")


def _join_for(rank, rdv, parts=1):
    """Join a world of gloo ranks on the card, the host's cores shared
    among them for the CPU reference runs; returns ``(ctx, views)``,
    ``views[d]`` the context whose tensors live on device type ``d``."""
    import dataclasses

    import torch

    from gnn_tpu_torch.parallel import dist as tdist
    torch.set_num_threads(max(1, torch.get_num_threads() // rdv.world_size))
    ctx = tdist.init_dist(rank, rdv, "cuda", "gloo", parts)
    return ctx, {d: dataclasses.replace(ctx, device=torch.device(d))
                 if d == "cpu" else ctx for d in REF_DEVICES}


def _small_dp_rank(rank, rdv, out_dir):
    """Phase 7 (a), one rank, on the card and then on the CPU: phase 4's
    small input, GraphSAGE resident, two epochs with the replicated table
    and two with the cache; writes its step losses (the mean across the
    ranks) and parameter digests, a file a device."""
    from gnn_tpu_torch.parallel import dist as tdist
    ctx, views = _join_for(rank, rdv)
    recs = {}
    try:
        for device_type, view in views.items():
            rec = recs[device_type] = {"device": str(view.device)}
            for cached in (False, True):
                tr, pipe, g = _small_trainer(view.device, "graphsage",
                                             ctx=view, cached=cached)
                try:
                    losses = [v for e in range(DP_EPOCHS) for v in
                              tr.train_epoch(g.train_nodes, e).step_losses]
                finally:
                    pipe.close()
                key = "cached" if cached else "replicated"
                rec[key] = losses
                rec[f"{key}_digest"] = tr.param_digest()
    finally:
        tdist.close_dist(ctx)
    for device_type, rec in recs.items():
        with open(os.path.join(out_dir, f"small_{device_type}{rank}.json"),
                  "w") as f:
            json.dump(rec, f)


def _spawn_dp(fn, args, out_dir):
    from gnn_tpu_torch.parallel import dist as tdist
    tdist.JOIN_TIMEOUT_S = DP_JOIN_TIMEOUT_S
    tdist.COLLECTIVE_TIMEOUT_S = DP_COLLECTIVE_TIMEOUT_S
    tdist.spawn_ranks(DP_WORLD, fn, args, rendezvous_dir=out_dir)


def _rel(a, b):
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def check_dp_small(save_dir):
    """Phase 7 (a): two gloo ranks on the card (both on ``cuda:0``), each
    with the replicated table and with the cache, and the same two ranks
    again with CPU tensors (`_small_dp_rank`). Fails unless both ranks log the same step losses
    and end with the same parameters, each card run's step losses agree
    with the CPU run's to AGREE_RTOL, the cached runs agree with the
    replicated ones to DP_CACHE_RTOL on the card and bit for bit on the
    CPU, and the loss falls."""
    import math

    out = os.path.join(save_dir, "dp_small")
    os.makedirs(out)
    runs = {}
    t0 = time.perf_counter()
    _spawn_dp(_small_dp_rank, (out,), out)
    log(f"dp small: {time.perf_counter() - t0:.1f}s wall (two ranks, card "
        f"and CPU)")
    for device_type in REF_DEVICES:
        recs = []
        for r in range(DP_WORLD):
            with open(os.path.join(out, f"small_{device_type}{r}.json")) as f:
                recs.append(json.load(f))
        log(f"dp small {device_type}: two ranks on "
            f"{[r['device'] for r in recs]}")
        for key in ("replicated", "cached"):
            if (recs[0][key] != recs[1][key]
                    or recs[0][f"{key}_digest"] != recs[1][f"{key}_digest"]):
                fail(f"dp small {device_type} {key}: the ranks disagree")
            losses = recs[0][key]
            if not (all(math.isfinite(v) for v in losses)
                    and losses[-1] < losses[0]):
                fail(f"dp small {device_type} {key}: losses {losses}")
        runs[device_type] = recs[0]
    for key in ("replicated", "cached"):
        rel = _rel(runs["cuda"][key], runs["cpu"][key])
        c, p = runs["cuda"][key], runs["cpu"][key]
        log(f"dp small {key} ({len(c)} steps, 2 ranks): cuda {c[0]:.5f}.."
            f"{c[-1]:.5f}, cpu {p[0]:.5f}..{p[-1]:.5f}, max rel diff "
            f"{rel:.2e}")
        if not rel <= AGREE_RTOL:
            fail(f"dp small {key}: cuda and cpu disagree: {rel:.3e}")
    rel_card = _rel(runs["cuda"]["cached"], runs["cuda"]["replicated"])
    rel_cpu = _rel(runs["cpu"]["cached"], runs["cpu"]["replicated"])
    log(f"dp small cached against replicated: cuda max rel diff "
        f"{rel_card:.2e}, cpu {rel_cpu:.2e}")
    if not (rel_card <= DP_CACHE_RTOL and rel_cpu == 0.0):
        fail(f"dp small: the cache changes the losses: cuda {rel_card:.3e},"
             f" cpu {rel_cpu:.3e}")


def run_dp_main_path(save_dir):
    """Phase 7 (b): the CLI defaults with ``--n_devices 2 --dist_backend
    gloo --feature_cache --op_timing --epoch_num DP_EPOCHS --test``, both
    ranks on the one card, in a directory sharing phase 5's set-up
    caches. Each rank counts its own kernel launches and writes them,
    with its step losses, parameter digests and cache row counts, to
    ``rank{r}.json``. Fails unless the ranks hold bitwise the same
    parameters after each epoch, the losses are finite and fall, every
    epoch's communication bucket is finite and above 0, and each rank's
    K1 launches are its steps' (phase 5's per-step counts) plus 3 a val
    pass and a test batch plus the op-timing probe's, which launches K1
    as often forward as transposed. Returns the ranks' summed launch
    counts by JSON name."""
    import math

    import numpy as np

    d = linked_dir(save_dir, "dp")
    argv = ["--n_devices", str(DP_WORLD), "--dist_backend", "gloo",
            "--feature_cache", "--op_timing", "--epoch_num", str(DP_EPOCHS),
            "--test"]
    from gnn_tpu_torch.parallel import dist as tdist
    tdist.JOIN_TIMEOUT_S = DP_JOIN_TIMEOUT_S
    tdist.COLLECTIVE_TIMEOUT_S = DP_COLLECTIVE_TIMEOUT_S
    recs, _, wall = run_cli(d, argv)
    eps = log_epochs("dp", recs)
    test_f1 = next((r["test_f1"] for r in recs if "test_f1" in r), None)
    ranks = []
    for r in range(DP_WORLD):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    steps = sum(len(e["step_losses"]) for e in ranks[0]["epochs"])
    losses = [v for r in eps for v in r["step_losses"]]
    log(f"dp main path: {DP_WORLD} ranks on "
        f"{[r['device'] for r in ranks]} ({ranks[0]['backend']}), "
        f"{len(eps)} epochs, {steps} steps a rank in {wall:.1f}s wall "
        f"(set-up, epochs, val, test sweep); test F1 {test_f1}")
    digests = [[e["param_digest"] for e in r["epochs"]] for r in ranks]
    log(f"dp parameter digests after each epoch: {digests}")
    if len(eps) != DP_EPOCHS or any(x != digests[0] for x in digests):
        fail(f"dp: the ranks' parameters differ: {digests}")
    if not (losses and all(math.isfinite(v) for v in losses)):
        fail(f"dp: non-finite or missing losses: {losses}")
    last5 = sum(losses[-5:]) / 5
    if not last5 < losses[0]:
        fail(f"dp: loss did not fall: first {losses[0]}, last-5 mean "
             f"{last5}")
    for r in eps:
        if not (math.isfinite(r["communication_s"])
                and r["communication_s"] > 0):
            fail(f"dp epoch {r['epoch']}: communication bucket "
                 f"{r['communication_s']}")
    total = dict.fromkeys((k[0] for k in KERNELS), 0)
    keys = {f"{mod}.{key}": name for name, (mod, key), _, _ in KERNELS}
    per = DEFAULT_PER_STEP
    for rec in ranks:
        rs = sum(len(e["step_losses"]) for e in rec["epochs"])
        got = {keys[k]: v for k, v in rec["launches"].items()}
        for k, v in got.items():
            total[k] += v
        fwd = got.get("edge_stream_spmm.forward", 0)
        tr = got.get("edge_stream_spmm.transpose", 0)
        evals = 3 * (len(rec["epochs"]) + rec["test_batches"])
        probe_f = fwd - per["edge_stream_spmm.forward"] * rs - evals
        probe_t = tr - per["edge_stream_spmm.transpose"] * rs
        log(f"dp rank {rec['rank']} K1 launches: forward {fwd} = "
            f"{per['edge_stream_spmm.forward']} x {rs} steps + 3 x "
            f"({len(rec['epochs'])} val passes + {rec['test_batches']} "
            f"test batches) + {probe_f} probe; transpose {tr} = "
            f"{per['edge_stream_spmm.transpose']} x {rs} + {probe_t} probe")
        if not (probe_f == probe_t > 0 and probe_f % 3 == 0):
            fail(f"dp rank {rec['rank']}: K1 launches do not add up")
        c = rec["cache"]
        rows = c["rows_local"] + c["rows_peer"] + c["rows_host"]
        times = [t for e in rec["epochs"] for t in e["step_times"]]
        steady = sorted(times[1:]) or times
        log(f"dp rank {rec['rank']} layer-0 input rows over {c['batches']} "
            f"training batches: own buffer {c['rows_local'] / rows:.4f}, "
            f"peer's buffer {c['rows_peer'] / rows:.4f}, host "
            f"{c['rows_host'] / rows:.4f} of {rows}; all-to-all received "
            f"{c['rows_peer'] * c['row_bytes'] / c['batches']:.0f} bytes a "
            f"step; median step {steady[len(steady) // 2]:.4f} s (two ranks "
            f"share one card's SMs: not a multi-GPU speed figure)")
    comm = [r["communication_s"] / len(r["step_losses"]) for r in eps]
    log(f"dp communication bucket a step (rank 0; all-reduce of the "
        f"gradients + one batch's feature exchange, isolated): "
        f"{' '.join(f'{v:.4f}' for v in comm)} s; median step of rank 0's "
        f"last epoch "
        f"{np.median(ranks[0]['epochs'][-1]['step_times'][1:]):.4f} s on "
        f"{card()} (two ranks share the card)")
    return total


# phase 8: the data x part grid, every rank under gloo on the one card.
# Each case's step losses against the same run unsharded (one rank, or
# phase 7's two data ranks) agree to PART_RTOL: the parts sum the hot
# products in another order, and on the card K1 sums in a run-dependent
# order (phase 6's reruns read 1e-8 to 5.4e-6 apart)
PART_RTOL = 1e-5
GRID_PARTS = 2
# one epoch a case keeps phase 8 near two minutes (two epochs took 130 s
# for (a) alone, PERF.md §6)
GRID_EPOCHS = 1
# phase 8 (a)'s cases on one data rank x GRID_PARTS part ranks: (name,
# model, ship_cold, cached); "full" is full expansion (Trainer only)
GRID_CASES = [("sharded", "graphsage", True, False),
              ("cached", "graphsage", True, True),
              ("full", "graphsage", False, False),
              ("gat", "gat", True, False)]


def _small_grid_rank(rank, rdv, out_dir, parts, cases):
    """Phase 8 (a), one rank of a ``world / parts`` x ``parts`` grid, on
    the card and then on the CPU: each of ``cases`` on phase 4's small
    input for GRID_EPOCHS epochs; writes its step losses (the grid's
    mean) and its digest after each epoch, a file a device."""
    from gnn_tpu_torch.parallel import dist as tdist
    ctx, views = _join_for(rank, rdv, parts)
    recs = {}
    try:
        for device_type, view in views.items():
            rec = recs[device_type] = {"device": str(view.device)}
            for name, model, ship_cold, cached in cases:
                tr, pipe, g = _small_trainer(view.device, model,
                                             ship_cold=ship_cold, ctx=view,
                                             cached=cached)
                losses, digests = [], []
                try:
                    for e in range(GRID_EPOCHS):
                        losses += tr.train_epoch(g.train_nodes,
                                                 e).step_losses
                        digests.append(tr.param_digest())
                finally:
                    pipe.close()
                rec[name] = losses
                rec[f"{name}_digests"] = digests
    finally:
        tdist.close_dist(ctx)
    for device_type, rec in recs.items():
        with open(os.path.join(out_dir, f"grid_{device_type}"
                               f"{world_tag(rdv)}_{rank}.json"), "w") as f:
            json.dump(rec, f)


def world_tag(rdv):
    return f"w{rdv.world_size}"


def _spawn_grid(world, parts, cases, out_dir):
    """One spawn of ``world`` ranks (card and CPU runs); rank 0's record
    by device type, after checking that every rank's agrees."""
    from gnn_tpu_torch.parallel import dist as tdist
    tdist.JOIN_TIMEOUT_S = DP_JOIN_TIMEOUT_S
    tdist.COLLECTIVE_TIMEOUT_S = DP_COLLECTIVE_TIMEOUT_S
    tdist.spawn_ranks(world, _small_grid_rank, (out_dir, parts, cases),
                      rendezvous_dir=out_dir)
    out = {}
    for device_type in REF_DEVICES:
        recs = []
        for r in range(world):
            with open(os.path.join(out_dir, f"grid_{device_type}w{world}"
                                   f"_{r}.json")) as f:
                recs.append(json.load(f))
        for name, *_ in cases:
            if any(x[name] != recs[0][name]
                   or x[f"{name}_digests"] != recs[0][f"{name}_digests"]
                   for x in recs):
                fail(f"grid {device_type} {world} ranks {name}: the ranks "
                     f"disagree: digests "
                     f"{[x[f'{name}_digests'] for x in recs]}")
        out[device_type] = recs[0]
    return out


def check_grid_small(save_dir):
    """Phase 8 (a): phase 4's small input on the grid, card and CPU (the
    card's ranks run the CPU cases too, one spawn a grid). GraphSAGE with the node-range feature shards and with the composed
    cache, in full expansion, and GAT, on one data rank x GRID_PARTS part
    ranks; GraphSAGE on two data ranks x GRID_PARTS part ranks. Fails
    unless every rank of a grid logs the same step losses and holds the
    same parameters after each epoch, the card's step losses agree with
    the CPU's to AGREE_RTOL, and each case agrees with the same run
    unsharded (one rank in this process; phase 7's two data ranks for the
    2 x 2 grid, whose replicated table gathers what the shards do) to
    PART_RTOL."""
    import math

    out = os.path.join(save_dir, "grid_small")
    os.makedirs(out)
    runs = {}
    t0 = time.perf_counter()
    ones = _spawn_grid(GRID_PARTS, GRID_PARTS, GRID_CASES, out)
    grids22 = _spawn_grid(2 * GRID_PARTS, GRID_PARTS, GRID_CASES[:1], out)
    log(f"grid small spawns: {time.perf_counter() - t0:.1f}s wall (1 x "
        f"{GRID_PARTS} and 2 x {GRID_PARTS} gloo ranks, card and CPU)")
    for device_type in REF_DEVICES:
        t0 = time.perf_counter()
        one, grid22 = ones[device_type], grids22[device_type]
        ref = {}
        for name, model, ship_cold, cached in GRID_CASES:
            if name == "cached":
                ref[name] = ref["sharded"]
                continue
            tr, pipe, g = _small_trainer(device_type, model,
                                         ship_cold=ship_cold)
            try:
                ref[name] = [v for e in range(GRID_EPOCHS) for v in
                             tr.train_epoch(g.train_nodes, e).step_losses]
            finally:
                pipe.close()
        got = {name: one[name] for name, *_ in GRID_CASES}
        got["2x2"] = grid22["sharded"]
        with open(os.path.join(save_dir, "dp_small",
                               f"small_{device_type}0.json")) as f:
            # phase 7 trains DP_EPOCHS epochs; the grid the first ones
            ref["2x2"] = json.load(f)["replicated"][:len(got["2x2"])]
        runs[device_type] = got
        log(f"grid small {device_type}: the unsharded runs "
            f"{time.perf_counter() - t0:.1f}s wall; epochs a case: "
            f"{GRID_EPOCHS}; every rank's losses and digests equal")
        for name, losses in got.items():
            if len(losses) != len(ref[name]):
                fail(f"grid small {device_type} {name}: {len(losses)} steps "
                     f"against {len(ref[name])} unsharded")
            rel = _rel(losses, ref[name])
            log(f"grid small {device_type} {name} ({len(losses)} steps): "
                f"{losses[0]:.5f}..{losses[-1]:.5f}; against the run "
                f"unsharded max rel diff {rel:.2e}")
            if not (all(math.isfinite(v) for v in losses)
                    and losses[-1] < losses[0]):
                fail(f"grid small {device_type} {name}: losses {losses}")
            if not rel <= PART_RTOL:
                fail(f"grid small {device_type} {name}: sharded and "
                     f"unsharded disagree: {rel:.3e}")
    for name in runs["cuda"]:
        rel = _rel(runs["cuda"][name], runs["cpu"][name])
        log(f"grid small {name}: cuda against cpu max rel diff {rel:.2e}")
        if not rel <= AGREE_RTOL:
            fail(f"grid small {name}: cuda and cpu disagree: {rel:.3e}")


# the resident graph's tensors of one rank, replicated (phase 5's) and as
# a part's shards (phase 8's)
RESIDENT_KEYS = (("slot_of_node", "slot_shard"),
                 ("row_val", "row_val_shard"),
                 ("col_val", "col_val_shard"), ("dense", "dense"),
                 ("dense_t", "dense_t"))


def _grid_ranks(d, world):
    ranks = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    digests = [[e["param_digest"] for e in r["epochs"]] for r in ranks]
    log(f"grid parameter digests after each epoch: {digests}")
    if any(x != digests[0] for x in digests):
        fail(f"grid: the ranks' parameters differ: {digests}")
    return ranks


def run_grid_main_path(save_dir, main_recs):
    """Phase 8 (b): the CLI defaults with ``--n_devices 1 --resident_parts
    GRID_PARTS --dist_backend gloo --feature_cache --op_timing
    --epoch_num 1 --test``, every rank on the one card, in a directory
    sharing phase 5's set-up caches. Fails unless the ranks hold the same
    parameters, the losses are finite and fall, the communication bucket
    is above 0, each rank's K1 launches are its steps' (phase 5's per-step
    counts) plus 3 a val pass and a test batch plus the op-timing
    probe's, each rank's resident graph on the card (slot, row and column
    shards, D and D^T shards) is 1 / GRID_PARTS of phase 5's default
    run's within the node ranges' padding, its feature buffer at most
    1 / GRID_PARTS of phase 5's table, and its peak memory after set-up
    below phase 5's. Returns the ranks' summed launch counts."""
    import math

    import numpy as np

    d = linked_dir(save_dir, "grid")
    argv = ["--n_devices", "1", "--resident_parts", str(GRID_PARTS),
            "--dist_backend", "gloo", "--feature_cache", "--op_timing",
            "--epoch_num", "1", "--test"]
    from gnn_tpu_torch.parallel import dist as tdist
    tdist.JOIN_TIMEOUT_S = DP_JOIN_TIMEOUT_S
    tdist.COLLECTIVE_TIMEOUT_S = DP_COLLECTIVE_TIMEOUT_S
    recs, _, wall = run_cli(d, argv)
    eps = log_epochs("grid", recs)
    test_f1 = next((r["test_f1"] for r in recs if "test_f1" in r), None)
    ranks = _grid_ranks(d, GRID_PARTS)
    losses = [v for r in eps for v in r["step_losses"]]
    log(f"grid main path: 1 x {GRID_PARTS} ranks on "
        f"{[r['device'] for r in ranks]} ({ranks[0]['backend']}), "
        f"{len(losses)} steps in {wall:.1f}s wall (set-up, epoch, val, test "
        f"sweep); test F1 {test_f1}")
    if not (losses and all(math.isfinite(v) for v in losses)):
        fail(f"grid: non-finite or missing losses: {losses}")
    if not sum(losses[-5:]) / 5 < losses[0]:
        fail(f"grid: loss did not fall: {losses}")
    for r in eps:
        if not (math.isfinite(r["communication_s"])
                and r["communication_s"] > 0):
            fail(f"grid epoch {r['epoch']}: communication bucket "
                 f"{r['communication_s']}")
    one = main_recs["graphsage"]
    whole = sum(one["state_bytes"][a] for a, _ in RESIDENT_KEYS)
    total = dict.fromkeys((k[0] for k in KERNELS), 0)
    keys = {f"{mod}.{key}": name for name, (mod, key), _, _ in KERNELS}
    per = DEFAULT_PER_STEP
    for rec in ranks:
        rs = sum(len(e["step_losses"]) for e in rec["epochs"])
        got = {keys[k]: v for k, v in rec["launches"].items()}
        for k, v in got.items():
            total[k] += v
        fwd = got.get("edge_stream_spmm.forward", 0)
        tr = got.get("edge_stream_spmm.transpose", 0)
        evals = 3 * (len(rec["epochs"]) + rec["test_batches"])
        probe_f = fwd - per["edge_stream_spmm.forward"] * rs - evals
        probe_t = tr - per["edge_stream_spmm.transpose"] * rs
        log(f"grid rank {rec['rank']} K1 launches: forward {fwd} = "
            f"{per['edge_stream_spmm.forward']} x {rs} steps + 3 x "
            f"({len(rec['epochs'])} val passes + {rec['test_batches']} "
            f"test batches) + {probe_f} probe; transpose {tr} = "
            f"{per['edge_stream_spmm.transpose']} x {rs} + {probe_t} probe")
        if not (probe_f == probe_t > 0 and probe_f % 3 == 0):
            fail(f"grid rank {rec['rank']}: K1 launches do not add up")
        sb = rec["state_bytes"]
        mine = sum(sb[b] for _, b in RESIDENT_KEYS)
        log(f"grid rank {rec['rank']} resident graph on the card: {mine} "
            f"bytes ({ {b: sb[b] for _, b in RESIDENT_KEYS} }) against "
            f"{whole} on one rank (phase 5, default path): "
            f"{mine / whole:.6f}; feature buffer {sb['features']} bytes "
            f"against the table's {one['state_bytes']['features']}; peak "
            f"memory after set-up {rec['setup_max_memory']} bytes against "
            f"{one['setup_max_memory']}")
        if not whole / GRID_PARTS <= mine <= whole / GRID_PARTS + 64:
            fail(f"grid rank {rec['rank']}: resident graph {mine} bytes is "
                 f"not 1/{GRID_PARTS} of {whole}")
        if sb["features"] > one["state_bytes"]["features"] / GRID_PARTS:
            fail(f"grid rank {rec['rank']}: feature buffer "
                 f"{sb['features']} bytes")
        if not rec["setup_max_memory"] < one["setup_max_memory"]:
            fail(f"grid rank {rec['rank']}: peak memory after set-up "
                 f"{rec['setup_max_memory']} not below one rank's "
                 f"{one['setup_max_memory']}")
        c = rec["cache"]
        rows = c["rows_local"] + c["rows_peer"] + c["rows_host"]
        times = [t for e in rec["epochs"] for t in e["step_times"]]
        steady = sorted(times[1:]) or times
        log(f"grid rank {rec['rank']}: bytes summed over the part group a "
            f"step {rec['epochs'][0]['part_bytes'] / rs:.0f}; layer-0 input "
            f"rows over {c['batches']} planned batches (training and val): "
            f"own part's buffer {c['rows_local'] / rows:.4f}, the other "
            f"part's {c['rows_peer'] / rows:.4f}, host "
            f"{c['rows_host'] / rows:.4f} of {rows}; median step "
            f"{steady[len(steady) // 2]:.4f} s on {card()} ({GRID_PARTS} "
            f"ranks share one card's SMs and gloo stages every collective "
            f"through the host: not a multi-GPU speed figure)")
    comm = [r["communication_s"] / len(r["step_losses"]) for r in eps]
    log(f"grid communication bucket a step (rank 0; the gradient "
        f"all-reduce + one batch's feature gather, isolated): "
        f"{' '.join(f'{v:.4f}' for v in comm)} s; median step of rank 0 "
        f"{np.median(ranks[0]['epochs'][-1]['step_times'][1:]):.4f} s")
    return total


def run_grid_gat(save_dir, main_recs):
    """Phase 8 (c): phase 8 (b)'s run with ``--model gat`` and no test
    sweep. Fails unless the ranks hold the same parameters, the losses
    are finite, and each rank launches K3 and K4's terms 3 times a step
    and a val pass and bwd_q and bwd_kv 3 times a step (phase 5's GAT
    per-step counts). Returns the ranks' summed launch counts."""
    import math

    d = linked_dir(save_dir, "grid_gat")
    argv = ["--model", "gat", "--n_devices", "1", "--resident_parts",
            str(GRID_PARTS), "--dist_backend", "gloo", "--feature_cache",
            "--op_timing", "--epoch_num", "1"]
    recs, _, wall = run_cli(d, argv)
    eps = log_epochs("grid gat", recs)
    ranks = _grid_ranks(d, GRID_PARTS)
    losses = [v for r in eps for v in r["step_losses"]]
    log(f"grid gat: 1 x {GRID_PARTS} ranks, {len(losses)} steps in "
        f"{wall:.1f}s wall (set-up, epoch, val)")
    if not (losses and all(math.isfinite(v) for v in losses)):
        fail(f"grid gat: non-finite or missing losses: {losses}")
    total = dict.fromkeys((k[0] for k in KERNELS), 0)
    keys = {f"{mod}.{key}": name for name, (mod, key), _, _ in KERNELS}
    # K3/K4 as on one part; a part's shard keeps the dense hot grid, so no
    # hot kernel launches
    per = {n: c for n, c in MAIN_PATHS[1][2].items()
           if n.startswith("cold_attention")}
    for rec in ranks:
        rs = sum(len(e["step_losses"]) for e in rec["epochs"])
        vals = len(rec["epochs"])
        got = {keys[k]: v for k, v in rec["launches"].items()}
        for k, v in got.items():
            total[k] += v
        want = {n: c * (rs + (vals if n in ("cold_attention_rowmax",
                                            "cold_attention_terms") else 0))
                for n, c in per.items()}
        log(f"grid gat rank {rec['rank']} K3/K4 launches "
            f"{ {n: got.get(n, 0) for n in per} }, expected {want} "
            f"({rs} steps, {vals} val pass)")
        if any(got.get(n, 0) != v for n, v in want.items()):
            fail(f"grid gat rank {rec['rank']}: K3/K4 launches do not add "
                 f"up")
        hot = {n: v for n, v in got.items() if n.startswith("hot_") and v}
        if hot:
            fail(f"grid gat rank {rec['rank']}: a part's shard launched hot "
                 f"kernels {hot}")
    return total


# phase 9: the entry points' dry run and the halo full-graph trainer. The
# halo trainer's step losses on one rank and on HALO_WORLD ranks agree to
# HALO_RTOL: the exchange moves rows exactly, the aggregation sums them in
# another order (index_add_'s atomics on the card)
DRYRUN_RANKS = 4
HALO_RTOL = 1e-4
HALO_WORLD = 2
HALO_STEPS = 5
HALO_SMALL_STEPS = 3
# (b)'s model: the gcn Laplacian of the CLI's synthetic default graph
HALO_FULL = dict(orders=(1, 1, 1), nhid=512, lr=0.01, sigmoid_loss=False,
                 seed=0)


def run_dryrun(save_dir):
    """Phase 9 (a): ``gnn_tpu_torch.entry``. The forward of ``entry`` on
    the card against the CPU's to AGREE_RTOL, then
    ``dryrun_multichip(DRYRUN_RANKS)``: four gloo ranks on ``cuda:0``, one
    epoch a case, each rank counting its kernel launches a case. Fails
    unless every case's loss is finite on every rank, each rank's
    part-sharded resident bytes are at most 1.06 / P of the whole state
    (both checked by ``dryrun_multichip``), K1 launched in the resident
    stream-tile case and K3 and K4 (terms, bwd_q, bwd_kv) in GAT's.
    Returns the ranks' launches summed over the cases by JSON name."""
    import torch

    from gnn_tpu_torch import entry
    from gnn_tpu_torch.parallel import dist as tdist
    fn, args = entry.entry("cuda")
    cfn, cargs = entry.entry("cpu")
    with torch.no_grad():
        got, want = fn(*args).cpu().numpy(), cfn(*cargs).numpy()
    err = float(abs(got - want).max())
    log(f"entry forward {tuple(got.shape)} on the card against the CPU: "
        f"max abs err {err:.2e}")
    if not err <= AGREE_RTOL * float(abs(want).max()):
        fail(f"entry: the card's forward disagrees: {err:.3e}")
    tdist.JOIN_TIMEOUT_S = DP_JOIN_TIMEOUT_S
    tdist.COLLECTIVE_TIMEOUT_S = DP_COLLECTIVE_TIMEOUT_S
    d = os.path.join(save_dir, "dryrun")
    os.makedirs(d)
    t0 = time.perf_counter()
    try:
        res = entry.dryrun_multichip(DRYRUN_RANKS, "cuda", run_dir=d)
    except RuntimeError as e:
        fail(str(e))
    log(f"dry run: {DRYRUN_RANKS} ranks, {len(res)} cases in "
        f"{time.perf_counter() - t0:.1f}s wall")
    if "sharded_resident" not in res:
        fail("dry run: the part-sharded cases did not run")
    if not res["resident_stream"]["launches"].get("edgestream.forward"):
        fail("dry run: K1 was not launched in the stream-tile case")
    for k in ATTN_KEYS:
        if not res["gat_stream"]["launches"].get(f"esattn.{k}"):
            fail(f"dry run: K3/K4 {k} was not launched in GAT's stream-tile "
                 f"case")
    keys = {f"{mod}.{key}": name for name, (mod, key), _, _ in KERNELS}
    total = dict.fromkeys((k[0] for k in KERNELS), 0)
    for r in res.values():
        for k, v in r["launches"].items():
            total[keys[k]] += v
    return total


def _halo_small_kw():
    """(c)'s input: the tests' small graph, orders 1,1, nhid 32."""
    import numpy as np

    from gnn_tpu_torch.data.synthetic import make_powerlaw_graph
    from gnn_tpu_torch.utils.normalize import build_laplacian
    g = make_powerlaw_graph(2000, 12, 32, 7, seed=0)
    mask = np.zeros(g.adj_full.shape[0], bool)
    mask[g.train_nodes] = True
    return dict(adj=build_laplacian(g.adj_full, "gcn"), feats=g.feats,
                labels_dense=np.asarray(g.labels.todense(), np.float32),
                train_mask=mask, orders=(1, 1), nhid=32,
                num_classes=g.num_classes, lr=0.01, seed=0)


def _halo_run(kw, steps, ctx=None):
    """``steps`` steps of a FullGraphTrainer: one rank on the card, or
    rank ``ctx.rank`` on ``ctx.device``: losses, step seconds, set-up seconds, peak
    memory, the plan's figures and the bytes a step this rank sent
    through the halo exchange."""
    import torch

    from gnn_tpu_torch.parallel import halo
    from gnn_tpu_torch.train.fullgraph import FullGraphTrainer
    dev = ctx.device if ctx is not None else torch.device("cuda")
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr = FullGraphTrainer(dist=ctx, device=dev, **kw)
    if on_card:
        torch.cuda.synchronize(dev)
    setup = time.perf_counter() - t0
    halo.exchange_bytes["sent"] = 0
    losses, times = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(tr.train_step())      # waits for the device
        times.append(time.perf_counter() - t)
    lp = tr.local_plan
    return dict(losses=losses, step_s=times, setup_s=setup,
                plan_s=tr.plan_seconds,
                peak=torch.cuda.max_memory_allocated(dev) if on_card else 0,
                nnz=int(kw["adj"].nnz), halo_width=tr.plan.halo_width,
                n_local=tr.plan.n_local,
                edges_local=int(lp.intra.vals.numel() + lp.halo.vals.numel()),
                bytes_per_step=halo.exchange_bytes["sent"] / steps)


def _halo_rank(rank, rdv, out_dir, bundle_path):
    """Phase 9 (b) / (c), one rank on the card: (c)'s small input for
    HALO_SMALL_STEPS steps on the card and on the CPU, then the
    full-width input attached from the bundle the parent published at
    ``bundle_path``, HALO_STEPS steps on the card; writes
    ``halo{rank}.json``."""
    from gnn_tpu_torch.data.shared import GraphBundle
    from gnn_tpu_torch.parallel import dist as tdist
    ctx, views = _join_for(rank, rdv)
    rec = {"device": str(ctx.device)}
    keep = []
    try:
        for device_type, view in views.items():
            rec[f"small_{device_type}"] = _halo_run(
                _halo_small_kw(), HALO_SMALL_STEPS, view)
        items, keep = GraphBundle.attach(bundle_path)
        kw = {k: items[k] for k in ("adj", "feats", "labels_dense",
                                    "train_mask", "num_classes")}
        rec["full"] = _halo_run(dict(kw, **HALO_FULL), HALO_STEPS, ctx)
        del items, kw
    finally:
        tdist.close_dist(ctx)
        for seg in keep:
            seg.close()
    with open(os.path.join(out_dir, f"halo{rank}.json"), "w") as f:
        json.dump(rec, f)


def _log_halo(label, r):
    import numpy as np
    log(f"halo {label}: set-up {r['setup_s']:.2f}s (the host plan "
        f"{r['plan_s']:.2f}s), median step "
        f"{float(np.median(r['step_s'])):.4f}s, peak memory {r['peak']} "
        f"bytes, n_local {r['n_local']}, halo_width {r['halo_width']}, "
        f"local edges {r['edges_local']}, halo bytes sent a step "
        f"{r['bytes_per_step']:.0f}; losses "
        + " ".join(f"{v:.6f}" for v in r["losses"]))


def run_halo(save_dir):
    """Phase 9 (b) and (c): the halo full-graph trainer. (b) The gcn
    Laplacian of the CLI's synthetic default graph (100k nodes, degree 50,
    602 features, 41 classes), orders 1,1,1, nhid 512, softmax CE, lr
    0.01, seed 0: HALO_STEPS steps on one rank in this process, and on
    HALO_WORLD gloo ranks sharing ``cuda:0`` that attach the graph from
    a GraphBundle this process publishes. (c) The tests' small graph,
    orders 1,1, nhid 32, HALO_SMALL_STEPS steps on the same HALO_WORLD
    ranks on the card and with CPU tensors. Fails unless (b)'s two runs' step losses agree
    to HALO_RTOL and fall below the first (at some step), the ranks of a
    run report the same losses, and
    (c)'s card run agrees with the CPU run to AGREE_RTOL. Logs the
    Laplacian's nnz, the plan, the halo bytes a step, the median step,
    peak memory and set-up seconds (ranks sharing one card: not
    multi-GPU figures)."""
    import numpy as np
    import torch

    from gnn_tpu_torch import cli
    from gnn_tpu_torch.data.loaders import load_dataset
    from gnn_tpu_torch.data.shared import GraphBundle
    from gnn_tpu_torch.parallel import dist as tdist
    from gnn_tpu_torch.utils.normalize import build_laplacian

    a = cli.build_parser().parse_args([])
    t0 = time.perf_counter()
    g = load_dataset(a.dataset, a.data_dir)
    mask = np.zeros(g.adj_full.shape[0], bool)
    mask[g.train_nodes] = True
    kw = dict(adj=build_laplacian(g.adj_full, "gcn"), feats=g.feats,
              labels_dense=np.asarray(g.labels.todense(), np.float32),
              train_mask=mask, num_classes=g.num_classes)
    del g
    log(f"halo input: {a.dataset} gcn Laplacian, "
        f"{kw['adj'].shape[0]} nodes, {kw['adj'].nnz} nnz, "
        f"{kw['feats'].shape[1]} features, {kw['num_classes']} classes, "
        f"built in {time.perf_counter() - t0:.1f}s")
    one = _halo_run(dict(kw, **HALO_FULL), HALO_STEPS)
    _log_halo("full width, 1 rank", one)
    torch.cuda.empty_cache()
    out = os.path.join(save_dir, "halo")
    os.makedirs(out)
    path = os.path.join(out, "bundle.pkl")
    bundle = GraphBundle.publish(kw, path)
    del kw
    tdist.JOIN_TIMEOUT_S = DP_JOIN_TIMEOUT_S
    tdist.COLLECTIVE_TIMEOUT_S = DP_COLLECTIVE_TIMEOUT_S
    try:
        t0 = time.perf_counter()
        tdist.spawn_ranks(HALO_WORLD, _halo_rank, (out, path),
                          rendezvous_dir=out)
        recs = []
        for r in range(HALO_WORLD):
            with open(os.path.join(out, f"halo{r}.json")) as f:
                recs.append(json.load(f))
        log(f"halo {HALO_WORLD} ranks on {[x['device'] for x in recs]}: "
            f"{time.perf_counter() - t0:.1f}s wall")
    finally:
        bundle.close()
    for what in ("small_cuda", "small_cpu", "full"):
        if any(x[what]["losses"] != recs[0][what]["losses"] for x in recs):
            fail(f"halo {what}: the ranks disagree")
    for r, x in enumerate(recs):
        _log_halo(f"full width, rank {r} of {HALO_WORLD} sharing the card",
                  x["full"])
    two = recs[0]["full"]["losses"]
    rel = _rel(two, one["losses"])
    log(f"halo full width: {HALO_WORLD} ranks against 1, max rel diff "
        f"{rel:.2e} on {card()} (ranks share the card: not a multi-GPU "
        f"figure)")
    if not rel <= HALO_RTOL:
        fail(f"halo full width: {HALO_WORLD} ranks and 1 disagree: "
             f"{rel:.3e}")
    # the synthetic graph's labels ignore its edges, and Adam's first
    # steps at lr 0.01 move every weight by about 0.01 (a quarter of the
    # init's spread), so the loss need not fall step by step: it must
    # fall below the first step's at some step
    if not min(one["losses"][1:]) < one["losses"][0]:
        fail(f"halo full width: loss did not fall: {one['losses']}")
    c = recs[0]["small_cuda"]["losses"]
    p = recs[0]["small_cpu"]["losses"]
    rel = _rel(c, p)
    log(f"halo small ({HALO_SMALL_STEPS} steps, {HALO_WORLD} ranks): cuda "
        + " ".join(f"{v:.6f}" for v in c) + ", cpu "
        + " ".join(f"{v:.6f}" for v in p) + f", max rel diff {rel:.2e}")
    if not rel <= AGREE_RTOL:
        fail(f"halo small: cuda and cpu disagree: {rel:.3e}")


# phase 10: each main path that runs grouped, at G = 1 (eager steps) and
# at --steps_per_dispatch GROUP (one CUDA graph replay a group),
# GROUP_EPOCHS epochs and a val pass each. The two runs sample the same
# batches and draw the same dropout masks (the generator is registered
# with the graphs); K1, K3 and K4 sum in a run-dependent order and the
# grouped run's capturable Adam rounds its update in float32, so their
# step losses agree to GROUP_RTOL and their val F1s to GROUP_F1_TOL, not
# bit for bit
GROUP = 8
GROUP_EPOCHS = 2
GROUP_RTOL = 1e-3
GROUP_F1_TOL = 1e-3
# the pairs: label, CLI arguments, and the kernel launches each graph
# records a step (JSON name -> count: phase 5's per-step counts of the
# path; none on the hot and coo formats)
GROUP_PAIRS = [
    ("default", [], DEFAULT_PER_STEP),
    ("gat", ["--model", "gat"],
     next(ps for label, _, ps in MAIN_PATHS if label == "gat")),
    ("hot", ["--adj_format", "hot"], {}),
    ("coo", ["--adj_format", "coo"], {}),
]
# gatv1 at its published widths, run at G = GROUP alone, and the launches
# each of its graphs records a step: each additive and each hot kernel
# once a layer
GATV1_ARGS = ["--model", "gatv1", "--nhid", "1024"]
GATV1_PER_STEP = {name: 3 for name, (mod, key), _, _ in KERNELS
                  if key in ADD_KEYS or (mod == "hotattn"
                                         and key in HOT_KEYS)}
# a grouped run's peak memory above this is flagged in the log (GAT's
# eager peak is 3.15 GB, PERF.md section 5)
GROUP_PEAK_FLAG = 4e9


def _grouped_run(save_dir, label, argv, g):
    """One CLI run of a phase 10 pair at ``--steps_per_dispatch g`` in a
    directory sharing phase 5's set-up caches; returns its epoch records,
    launch counts, rank record and peak memory, and logs them."""
    import gc

    import torch

    d = linked_dir(save_dir, f"group_{label}_{g}")
    torch.cuda.reset_peak_memory_stats()
    recs, counts, wall = run_cli(d, argv + [
        "--n_devices", "1", "--epoch_num", str(GROUP_EPOCHS),
        "--steps_per_dispatch", str(g)])
    gc.collect()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(d, "rank0.json")) as f:
        rank = json.load(f)
    eps = log_epochs(f"grouped {label} G={g}", recs)
    times = eps[-1]["step_times"]
    log(f"grouped {label} G={g}: {wall:.1f}s wall, median step (epoch "
        f"{eps[-1]['epoch']}) {sorted(times)[len(times) // 2]:.5f}s, peak "
        f"memory {peak} bytes, captures {len(rank.get('captures', []))} "
        f"in {sum(c['seconds'] for c in rank.get('captures', [])):.3f}s, "
        f"launches counted { {k: v for k, v in counts.items() if v} }, "
        f"replayed {rank.get('replayed_launches', {})}, on {card()}")
    return dict(eps=eps, counts=counts, rank=rank, peak=peak)


def _check_captures(label, grp, per_step):
    """A grouped run's captures: every graph recorded exactly
    ``per_step`` launches of each kernel for each of its steps and no
    other, the replays ran every step, the second epoch captured at most
    one graph, and every capture is in the rank record and was logged."""
    caps = grp["rank"]["captures"]
    steps = sum(len(r["step_losses"]) for r in grp["eps"])
    keys = {name: f"{mod}.{key}" for name, (mod, key), _, _ in KERNELS}
    for c in caps:
        log(f"grouped {label} capture: {c['steps']} steps, shapes "
            f"{c['key']}, {c['seconds']:.3f}s, recorded {c['launches']}, "
            f"{c['replays']} replays")
        want = {keys[name]: n * c["steps"] for name, n in per_step.items()}
        if c["launches"] != want:
            fail(f"grouped {label}: a {c['steps']}-step graph recorded "
                 f"{c['launches']}, not {want}")
    replayed_steps = sum(c["steps"] * c["replays"] for c in caps)
    if replayed_steps != steps:
        fail(f"grouped {label}: the replays ran {replayed_steps} steps of "
             f"{steps}")
    per_epoch = [r["captures"] for r in grp["eps"]]
    log(f"grouped {label}: captures by epoch {per_epoch}, "
        f"{sum(c['seconds'] for c in caps):.2f}s in all; peak memory "
        f"G={GROUP} {grp['peak']} bytes")
    if grp["peak"] > GROUP_PEAK_FLAG:
        log(f"grouped {label}: FLAG: G={GROUP} peak memory {grp['peak']} "
            f"bytes is above {GROUP_PEAK_FLAG:.0f}")
    if per_epoch[1] > 1:
        fail(f"grouped {label}: epoch 1 captured {per_epoch[1]} graphs")
    if sum(per_epoch) != len(caps) or any(
            r["capture_s"] <= 0 for r in grp["eps"] if r["captures"]):
        fail(f"grouped {label}: captures {per_epoch} by epoch, {len(caps)} "
             f"logged")


def _run_launches(run):
    """A grouped run's launches by JSON name: its counters' plus each
    graph's captured launches times its replays."""
    replayed = run["rank"].get("replayed_launches", {})
    return {name: run["counts"][name] + replayed.get(f"{mod}.{key}", 0)
            for name, (mod, key), _, _ in KERNELS}


def check_grouped_pair(save_dir, label, argv, per_step):
    """Phase 10, one pair: ``argv`` eagerly and at ``--steps_per_dispatch
    GROUP``. Fails unless the runs take the same steps, every step loss
    of the grouped run agrees with the eager run's to GROUP_RTOL and the
    val F1s to GROUP_F1_TOL, and the grouped run's captures pass
    :func:`_check_captures`. Returns the launch counts of both runs by
    JSON name: the counters' (the warm-up steps before each capture, the
    val passes) plus each graph's captured launches times its
    replays."""
    import math

    total = {}
    runs = {}
    for g in (1, GROUP):
        runs[g] = r = _grouped_run(save_dir, label, argv, g)
        for name, n in _run_launches(r).items():
            total[name] = total.get(name, 0) + n
    one, grp = runs[1], runs[GROUP]
    if [len(r["step_losses"]) for r in one["eps"]] != [
            len(r["step_losses"]) for r in grp["eps"]] or \
            len(one["eps"]) != GROUP_EPOCHS:
        fail(f"grouped {label}: the runs took different steps")
    rel = max(abs(a - b) / abs(b)
              for ra, rb in zip(grp["eps"], one["eps"])
              for a, b in zip(ra["step_losses"], rb["step_losses"]))
    df1 = max(abs(ra["valid_f1"] - rb["valid_f1"])
              for ra, rb in zip(grp["eps"], one["eps"]))
    log(f"grouped {label}: G={GROUP} against G=1, max rel step-loss diff "
        f"{rel:.3e}, max val F1 diff {df1:.3e}")
    if not (math.isfinite(rel) and rel <= GROUP_RTOL):
        fail(f"grouped {label}: step losses differ by {rel:.3e}")
    if not df1 <= GROUP_F1_TOL:
        fail(f"grouped {label}: val F1s differ by {df1:.3e}")
    log(f"grouped {label}: peak memory G=1 {one['peak']} bytes")
    _check_captures(label, grp, per_step)
    return total


def run_grouped(save_dir):
    """Phase 10: every pair of GROUP_PAIRS (:func:`check_grouped_pair`),
    each run with every launch counter set to 0 before it and read after;
    returns the launch counts of all the runs by JSON name."""
    total = {}
    for label, argv, per_step in GROUP_PAIRS:
        t0 = time.perf_counter()
        for name, n in check_grouped_pair(save_dir, label, argv,
                                          per_step).items():
            total[name] = total.get(name, 0) + n
        log(f"phase 10 pair {label}: {time.perf_counter() - t0:.1f}s")
    return total


def check_additive_attention(adjs, device):
    """The four additive attention kernels (gatv1's score source)
    against their plain versions on the default batch's cold tiles at
    gatv1's widths (:data:`GATV1_LAYERS`): el [R, H], er [C, H], v [C,
    H d], a self column a row (a random column: an edge to it is
    dropped); each timed by CUDA events beside its plain version and its
    bound (each input read once, each output written once, coords 2 B an
    edge, entries 16 B). Returns totals by key as
    :func:`check_attention`'s."""
    import torch

    from gnn_tpu_torch.ops import esattn as ea
    gen = torch.Generator(device=device).manual_seed(2)
    totals = {key: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                        max_rel_err=0.0, bytes=0.0, flops=0.0)
              for key in ADD_KEYS}
    for l, (adj, (H, d)) in enumerate(zip(adjs, GATV1_LAYERS)):
        t = (adj.es_coords, adj.es_rc, adj.es_off, adj.es_ord)
        kw = dict(slope=0.2, bm=adj.es_bm, bk=adj.es_bk)
        R, C, n = adj.nrows, adj.ncols, H * d

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=device)
        el, er, v = rnd(R, H), rnd(C, H), rnd(C, n)
        gd, gn = rnd(R, H), rnd(R, n)
        sp = torch.randint(0, C, (R,), generator=gen, device=device,
                           dtype=torch.int32)
        rows, _ = ea.live_additive_edges(*t[:3], sp, adj.es_bm, adj.es_bk)
        e, nb = int(rows.shape[0]), int(t[1].shape[0])
        m_ref = ea.cold_additive_rowmax_ref(*t[:3], el, er, sp, **kw)
        has = m_ref > ea.NEG_SENTINEL / 2
        rm = torch.where(has, m_ref, torch.zeros_like(m_ref))
        a = (el, er, sp)
        fns = {
            "add_rowmax": (
                lambda: ea.cold_rowmax(*t[:3], a, **kw),
                lambda: ea.cold_additive_rowmax_ref(*t[:3], *a, **kw)),
            "add_terms": (
                lambda: ea.cold_terms(*t, a, v, rm, **kw),
                lambda: ea.cold_additive_terms_ref(*t, *a, v, rm, **kw)),
            "add_bwd_q": (
                lambda: ea.cold_backward("bwd_q", *t, a, v, rm, gd, gn, **kw),
                lambda: ea.cold_additive_bwd_q_ref(*t, *a, v, rm, gd, gn,
                                                   **kw)),
            "add_bwd_kv": (
                lambda: ea.cold_backward("bwd_kv", *t, a, v, rm, gd, gn,
                                         **kw),
                lambda: ea.cold_additive_bwd_kv_ref(*t, *a, v, rm, gd, gn,
                                                    **kw)),
        }
        # bytes besides the coords and entry tables, and float32 flops
        base = 4 * (R * H + C * H) + 4 * R
        io = {"add_rowmax": (base + 4 * R * H, 3 * e * H),
              "add_terms": (base + 4 * C * n + 4 * R * H
                            + 4 * (R * H + R * n), 2 * e * n + 5 * e * H),
              "add_bwd_q": (base + 4 * C * n + 4 * (2 * R * H + R * n)
                            + 4 * R * H, 2 * e * n + 8 * e * H),
              "add_bwd_kv": (base + 4 * C * n + 4 * (2 * R * H + R * n)
                             + 4 * nb + 4 * (C * H + C * n),
                             4 * e * n + 8 * e * H)}
        for key in ADD_KEYS:
            kern, plain = fns[key]
            got, want = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = []
            for y, ref in zip(got, want):
                if key == "add_rowmax":
                    if not (y[~has] == ea.NEG_SENTINEL).all():
                        fail(f"{key} layer{l}: rows without a cold edge do "
                             f"not read NEG_SENTINEL")
                    y, ref = y[has], ref[has]
                errs.append(_max_err(y, ref, f"layer{l}", key))
            err = max(x for x, _ in errs)
            rel = max(x for _, x in errs)
            t_bytes = (2 * e + 16 * nb + io[key][0]) / MEM_BYTES_PER_S * 1e3
            t_flops = io[key][1] / F32_FLOPS_PER_S * 1e3
            ms = time_ms(kern)
            plain_ms = time_ms(plain, reps=2, rounds=3)
            tot = totals[key]
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["max_rel_err"] = max(tot["max_rel_err"], rel)
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += max(t_bytes, t_flops)
            tot["bytes"] += t_bytes
            tot["flops"] += t_flops
            log(f"{key:10s} layer{l} R={R} C={C} n_out={n} H={H} "
                f"cold_edges={e} entries={nb} max_abs_err={err:.3e} "
                f"max_rel_err={rel:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={max(t_bytes, t_flops):.4f} "
                f"({'bytes' if t_bytes >= t_flops else 'operations'})")
            del got, want
        torch.cuda.empty_cache()
    return totals


def check_hot_attention(adjs, device):
    """The hot part's kernels on its live entries (gatv1's additive
    source, `gnn_tpu_torch.ops.hotattn`: the mask pass, rowmax, terms,
    bwd_row, bwd_col) against their plain versions on the default batch's
    resident layers (bfloat16 block) at gatv1's widths
    (:data:`GATV1_LAYERS`), random el, er, v and a random own column a
    row; each timed by CUDA events beside its plain version and its bound
    (each input read once, each output written once; float32 operations
    per live entry over the float32 rate). The mask pass's words must be
    the plain version's exactly, the row max too. Returns totals by key
    as :func:`check_attention`'s."""
    import torch

    from gnn_tpu_torch.ops import hotattn as ha
    gen = torch.Generator(device=device).manual_seed(4)
    totals = {key: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                        max_rel_err=0.0, bytes=0.0, flops=0.0)
              for key in HOT_KEYS}
    slope = 0.2
    for l, (adj, (H, d)) in enumerate(zip(adjs, GATV1_LAYERS)):
        R, C, n = adj.nrows, adj.ncols, H * d

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=device)
        el, er, v = rnd(R, H), rnd(C, H), rnd(C, n)
        sp = torch.randint(0, C, (R,), generator=gen, device=device,
                           dtype=torch.int32)
        r_loc = adj.rowpos.index_select(0, adj.present_row_slots.long())
        c_loc = adj.colpos.index_select(0, adj.present_col_slots.long())
        mask_ops = ha.mask_operands(adj, r_loc, sp)
        grid = ha.live_grid(adj, r_loc, c_loc, el, er, v, sp, slope)
        bits, bits_t, orders = grid.bits, grid.bits_t, grid.orders
        elh, erh, vh = grid.elh, grid.erh, grid.vh
        rh, ch = elh.shape[0], erh.shape[0]
        m_ref = ha.rowmax_ref(bits, elh, erh, slope)
        rm = torch.where(torch.isfinite(m_ref), m_ref,
                         torch.zeros_like(m_ref))
        gd, gn = rnd(rh, H), rnd(rh, n)
        live = int(ha.unpack_bits(bits, ch).sum())
        a = (elh, erh, vh, rm)
        fns = {
            "mask": (lambda: ha.live_masks(*mask_ops),
                     lambda: ha.live_masks_ref(*mask_ops)),
            "rowmax": (lambda: ha.rowmax(bits, elh, erh, slope,
                                         order=orders[0]),
                       lambda: ha.rowmax_ref(bits, elh, erh, slope)),
            "terms": (lambda: ha.terms(bits, bits_t, *a, slope, orders),
                      lambda: ha.terms_ref(bits, *a, slope)),
            "bwd_row": (lambda: ha.bwd_row(bits, *a, gd, gn, slope,
                                           orders[0]),
                        lambda: ha.bwd_row_ref(bits, *a, gd, gn, slope)),
            "bwd_col": (lambda: ha.bwd_col(bits_t, *a, gd, gn, slope,
                                           orders[1]),
                        lambda: ha.bwd_col_ref(bits_t, *a, gd, gn, slope)),
        }
        words = 4 * (rh * -(-ch // 32) + ch * -(-rh // 32))
        k = adj.dense.shape[0]
        # bytes each call must move, and its float32 operations
        io = {"mask": (2 * rh * k + 4 * (rh + 2 * k) + words, 0),
              "rowmax": (words / 2 + 4 * (rh * H + ch * H + rh * H),
                         2 * live * H),
              "terms": (words / 2 + 4 * (2 * rh * H + ch * H + ch * n
                                         + rh * H + rh * n),
                        2 * live * n + 6 * live * H),
              "bwd_row": (words / 2 + 4 * (3 * rh * H + ch * H + ch * n
                                           + rh * n + rh * H),
                          2 * live * n + 10 * live * H),
              "bwd_col": (words / 2 + 4 * (3 * rh * H + ch * H + ch * n
                                           + rh * n + ch * H + ch * n),
                          4 * live * n + 10 * live * H)}
        for key in HOT_KEYS:
            kern, plain = fns[key]
            with torch.no_grad():
                got, want = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            if key in ("mask", "rowmax"):
                for y, ref in zip(got, want):
                    if not torch.equal(y, ref):
                        fail(f"hot {key} layer{l}: not the plain version's "
                             f"exactly")
                err = rel = 0.0
            else:
                errs = [_max_err(y, ref, f"layer{l}", f"hot {key}")
                        for y, ref in zip(got, want)]
                err = max(x for x, _ in errs)
                rel = max(x for _, x in errs)
            t_bytes = io[key][0] / MEM_BYTES_PER_S * 1e3
            t_flops = io[key][1] / F32_FLOPS_PER_S * 1e3
            with torch.no_grad():
                ms = time_ms(kern)
                plain_ms = time_ms(plain, reps=2, rounds=3)
            tot = totals[key]
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["max_rel_err"] = max(tot["max_rel_err"], rel)
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += max(t_bytes, t_flops)
            tot["bytes"] += t_bytes
            tot["flops"] += t_flops
            log(f"hot {key:8s} layer{l} rh={rh} ch={ch} n_out={n} H={H} "
                f"live={live} ({live / max(rh * ch, 1):.4f} of the grid) "
                f"max_abs_err={err:.3e} max_rel_err={rel:.3e} ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} "
                f"bound_ms={max(t_bytes, t_flops):.4f} "
                f"({'bytes' if t_bytes >= t_flops else 'operations'})")
            del got, want
        del grid, fns
        torch.cuda.empty_cache()
    return totals


def check_dot_attention(adjs, device, nhid):
    """gat's hot part on its live entries (`gnn_tpu_torch.ops.hotattn`:
    the dot modes dot_rowmax, dot_terms, dot_bwd_row, dot_bwd_col) against
    their plain versions on the default batch's resident layers at gat's
    width (one head of ``nhid``), random q, k, v; each timed by CUDA
    events beside its plain version and its bound (each input read once,
    each output written once; float32 operations per live entry over the
    float32 rate); then each layer's live route (mask pass, row max,
    terms, backward) beside the grid route it replaced (the plain
    versions under autograd: the dense route's operations). Returns
    totals by key as :func:`check_attention`'s."""
    import torch

    from gnn_tpu_torch.ops import hotattn as ha
    from gnn_tpu_torch.ops.hotdense import _take_rows_fill
    gen = torch.Generator(device=device).manual_seed(5)
    totals = {key: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                        max_rel_err=0.0, bytes=0.0, flops=0.0)
              for key in DOT_KEYS}
    H, d = 1, nhid
    n, scale = H * d, 1.0 / d ** 0.5
    for l, adj in enumerate(adjs):
        R, C = adj.nrows, adj.ncols

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=device)
        q, k, v = rnd(R, n), rnd(C, n), rnd(C, n)
        r_loc = adj.rowpos.index_select(0, adj.present_row_slots.long())
        c_loc = adj.colpos.index_select(0, adj.present_col_slots.long())
        grid = ha.dot_live_grid(adj, r_loc, c_loc, q, k, v, H, scale)
        bits, bits_t, orders = grid.bits, grid.bits_t, grid.orders
        qh, kh, vh = grid.qh, grid.kh, grid.vh
        rh, ch = qh.shape[0], kh.shape[0]
        m_ref = ha.dot_rowmax_ref(bits, qh, kh, H, scale)
        rm = torch.where(torch.isfinite(m_ref), m_ref,
                         torch.zeros_like(m_ref))
        gd, gn = rnd(rh, H), rnd(rh, n)
        live = int(ha.unpack_bits(bits, ch).sum())
        a = (qh, kh, vh, rm)
        fns = {
            "dot_rowmax": (lambda: ha.dot_rowmax(bits, qh, kh, H, scale,
                                                 order=orders[0]),
                           lambda: ha.dot_rowmax_ref(bits, qh, kh, H,
                                                     scale)),
            "dot_terms": (lambda: ha.dot_terms(bits, bits_t, *a, H, scale,
                                               orders),
                          lambda: ha.dot_terms_ref(bits, *a, H, scale)),
            "dot_bwd_row": (lambda: ha.dot_bwd_row(bits, *a, gd, gn, H,
                                                   scale, orders[0]),
                            lambda: ha.dot_bwd_row_ref(bits, *a, gd, gn, H,
                                                       scale)),
            "dot_bwd_col": (lambda: ha.dot_bwd_col(bits_t, *a, gd, gn, H,
                                                   scale, orders[1]),
                            lambda: ha.dot_bwd_col_ref(bits_t, *a, gd, gn, H,
                                                       scale)),
        }
        words = 4 * (rh * -(-ch // 32) + ch * -(-rh // 32))
        # bytes each call must move (inputs once, outputs once), and its
        # float32 operations; the rows a live entry gathers (from L2) are
        # logged beside them
        io = {"dot_rowmax": (words / 2 + 4 * (rh * n + ch * n + rh * H),
                             2 * live * n),
              "dot_terms": (words / 2 + 4 * (2 * rh * n + 2 * ch * n
                                             + 2 * rh * H), 4 * live * n),
              "dot_bwd_row": (words / 2 + 4 * (3 * rh * n + 2 * ch * n
                                               + 2 * rh * H), 6 * live * n),
              "dot_bwd_col": (words / 2 + 4 * (2 * rh * n + 4 * ch * n
                                               + 2 * rh * H), 8 * live * n)}
        gathers = {"dot_rowmax": 1, "dot_terms": 2, "dot_bwd_row": 2,
                   "dot_bwd_col": 2}
        for key in DOT_KEYS:
            kern, plain = fns[key]
            with torch.no_grad():
                got, want = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            if key == "dot_rowmax":
                fin = torch.isfinite(want[0])
                if not torch.equal(fin, torch.isfinite(got[0])):
                    fail(f"dot rowmax layer{l}: rows without a live entry "
                         f"differ")
                got, want = (got[0][fin],), (want[0][fin],)
            errs = [_max_err(y, ref, f"layer{l}", f"dot {key}")
                    for y, ref in zip(got, want)]
            err = max(x for x, _ in errs)
            rel = max(x for _, x in errs)
            t_bytes = io[key][0] / MEM_BYTES_PER_S * 1e3
            t_flops = io[key][1] / F32_FLOPS_PER_S * 1e3
            with torch.no_grad():
                ms = time_ms(kern)
                plain_ms = time_ms(plain, reps=2, rounds=3)
            tot = totals[key]
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["max_rel_err"] = max(tot["max_rel_err"], rel)
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += max(t_bytes, t_flops)
            tot["bytes"] += t_bytes
            tot["flops"] += t_flops
            gb = gathers[key] * 4 * n * live / 1e9
            log(f"dot {key:11s} layer{l} rh={rh} ch={ch} n_out={n} H={H} "
                f"live={live} ({live / max(rh * ch, 1):.4f} of the grid) "
                f"max_abs_err={err:.3e} max_rel_err={rel:.3e} ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} "
                f"bound_ms={max(t_bytes, t_flops):.4f} "
                f"({'bytes' if t_bytes >= t_flops else 'operations'}) "
                f"gathered={gb:.3f} GB ({gb / ms:.2f} TB/s)")
            del got, want

        def route(live_route):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            if live_route:
                g2 = ha.dot_live_grid(adj, r_loc, c_loc, *leaves, H, scale)
                g2.rowmax(count_live=False)
                den, num = g2.terms(rm)
            else:
                # the dense route as the one-part DenseGrid ran it: the
                # block's present sub-grid as the mask, one score product
                # for the row max and the terms
                sentinel = 1 << 30
                row_ok = torch.arange(rh, device=device) < (
                    adj.row_cmp_idx != sentinel).sum()
                col_ok = torch.arange(ch, device=device) < (
                    adj.col_cmp_idx != sentinel).sum()
                mask = ((adj.dense.index_select(
                    0, adj.present_row_slots.long()).index_select(
                    1, adj.present_col_slots.long()) != 0)
                    & row_ok[:, None] & col_ok[None, :])
                qg, kg, vg = (_take_rows_fill(t, loc).reshape(-1, H, d)
                              .transpose(0, 1) for t, loc in
                              zip(leaves, (r_loc, c_loc, c_loc)))
                sc = torch.where(mask[None], torch.matmul(
                    qg, kg.transpose(1, 2)) * scale,
                    torch.full((), float("-inf"), device=device))
                sc.detach().amax(dim=2)
                e = torch.exp(sc - rm.t()[:, :, None])
                den, num = e.sum(dim=2), torch.matmul(e, vg)
            ((den * gd.t()).sum() + (num * gn.reshape(
                rh, H, d).transpose(0, 1)).sum()).backward()

        routes = {}
        for name, live_route in (("live", True), ("grid", False)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            routes[name] = (time_ms(lambda: route(live_route), reps=3,
                                    rounds=3),
                            torch.cuda.max_memory_allocated() - base)
        log(f"dot route layer{l} rh={rh} ch={ch}: live (mask, row max, "
            f"terms, backward) {routes['live'][0]:.4f} ms, "
            f"{routes['live'][1]} B above the operands; grid route "
            f"{routes['grid'][0]:.4f} ms, {routes['grid'][1]} B")
        del grid, fns
        torch.cuda.empty_cache()
    return totals


def run_gatv1(save_dir):
    """Phase 10's last run: ``--model gatv1 --nhid 1024`` on the default
    dataset at G = GROUP for GROUP_EPOCHS epochs. Fails unless every step
    loss is finite and the captures pass :func:`_check_captures` with
    GATV1_PER_STEP; returns the run's launches by JSON name."""
    import math

    r = _grouped_run(save_dir, "gatv1", GATV1_ARGS, GROUP)
    losses = [x for e in r["eps"] for x in e["step_losses"]]
    log(f"grouped gatv1 G={GROUP}: {len(losses)} steps, first / last "
        f"losses {losses[0]:.4f} / {losses[-1]:.4f}, val F1 "
        f"{r['eps'][-1]['valid_f1']:.4f}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"grouped gatv1: a step loss is not finite: {losses}")
    _check_captures("gatv1", r, GATV1_PER_STEP)
    return _run_launches(r)


def _kernel_entry(name, source, replaces, launches, t):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches),
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes"] >= t["flops"]
                         else "operations"),
            "library_ms": t.get("library_ms")}


def main() -> int:
    t_start = time.perf_counter()
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
    # the card's name and power limit, as nvidia-smi prints them
    log(card())
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
        additive = check_additive_attention(adjs, device)
        hot = check_hot_attention(adjs, device)
        hot.update(check_dot_attention(adjs, device, nhid))
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
        main_recs = {}
        for label, argv, per_step in MAIN_PATHS:
            got, main_recs[label] = run_main_path(save_dir, label, argv,
                                                  per_step)
            for name, n in got.items():
                counts[name] += n
        for name, n in run_probe_path(save_dir, device).items():
            counts[name] += n
        log(f"phase 5 (main paths, probe): {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        for run in (run_extras, run_resume):
            for name, n in run(save_dir).items():
                counts[name] += n
        log(f"phase 6 (single-device extras): "
            f"{time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        check_dp_small(save_dir)
        for name, n in run_dp_main_path(save_dir).items():
            counts[name] += n
        log(f"phase 7 (two ranks on one card): "
            f"{time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        check_grid_small(save_dir)
        for run in (run_grid_main_path, run_grid_gat):
            for name, n in run(save_dir, main_recs).items():
                counts[name] += n
        log(f"phase 8 (the part-sharded grid on one card): "
            f"{time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        for name, n in run_dryrun(save_dir).items():
            counts[name] += n
        run_halo(save_dir)
        log(f"phase 9 (entry, dry run, halo trainer): "
            f"{time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        for name, n in run_grouped(save_dir).items():
            counts[name] += n
        for name, n in run_gatv1(save_dir).items():
            counts[name] += n
        log(f"phase 10 (grouped dispatch, gatv1 at G = 8): "
            f"{time.perf_counter() - t0:.1f}s")
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)

    measured = {f"edge_stream_spmm.{d}": k1[d]
                for d in ("forward", "transpose")}
    measured.update({name: {**attn[key], "library_ms": None}
                     for name, (mod, key), _, _ in KERNELS
                     if mod == "esattn" and key in ATTN_KEYS})
    measured.update({name: {**additive[key], "library_ms": None}
                     for name, (_, key), _, _ in KERNELS
                     if key in ADD_KEYS})
    measured.update({name: {**hot[key], "library_ms": None}
                     for name, (mod, key), _, _ in KERNELS
                     if mod == "hotattn"})
    measured.update(tiles)
    measured["edge_stream_spmm_seg"] = seg
    kernels = [_kernel_entry(name, source, replaces, counts[name],
                             measured[name])
               for name, _, source, replaces in KERNELS]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f}s from start to "
        f"the kernels line")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
