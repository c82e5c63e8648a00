#!/usr/bin/env python3
"""Time variants of the edge-stream attention kernel (K3 / K4) on one
NVIDIA GPU.

    python3 tools/torch_esattn_variants.py [--profile] VARIANT ...

Each VARIANT is a comma-separated list of NAME=VALUE settings of the
``constexpr int`` constants of ``gnn_tpu_torch/csrc/edge_attention.cu``
(``ROWMAX_EDGES=4,MAX_SPLIT=4``), or ``base`` for the source as it is.
Every variant is built with nvcc (all at once; the registers and spill
bytes ptxas reports are printed), checked against the plain versions on
one default batch (the probe's set-up, ``tools/torch_edgestream_probe.py``)
and timed at the GAT path's shapes on its three layers (width ``--nhid``,
one head): rowmax, terms, bwd_q and bwd_kv. Variants run in turns (in
order, then reversed), so two readings of each come from one card.

``--profile`` also builds each variant with clock64 counters at the
kernel's phase boundaries and prints, per case, the thread blocks, the
passes per block and the mean cycles a block spends in each phase, read
by its first thread: set-up and search, the pass's ranges, decode (the
first thread's share), the wait for the cluster's counts (the block's and
the cluster's slowest decode), the sort (row CSR, scatter, barrier),
compute, boundary-row combine; with the slowest block's total.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

SOURCE = os.path.join(os.path.dirname(HERE), "gnn_tpu_torch", "csrc",
                      "edge_attention.cu")
REL_TOL = 1e-4
MODES = ("rowmax", "terms", "bwd_q", "bwd_kv")

# --profile: (anchor line in the kernel, line inserted after it); the
# counters are summed over blocks into g_prof (blocks, passes, then the
# cycles of each PHASES entry, the total and the slowest block's total)
PHASES = ("set-up", "range", "decode", "count wait", "sort", "compute",
          "combine")
PROBES = [
    ("    S& s = *reinterpret_cast<S*>(smem_raw);\n",
     "    long long p_t0 = clock64(), p_m = 0, p_r = 0, p_d = 0, p_w = 0, "
     "p_s = 0, p_g = 0, p_c = 0, p_pass = 0;\n"),
    ("    const int k_hi = lower_bound(tile + 1);\n",
     "    const long long p_setup = clock64() - p_t0;\n"),
    ("      for (int c0 = 0; c0 < tot;) {\n",
     "        p_m = clock64(); ++p_pass;\n"),
    ("        const int c_next = s.rng[split];\n",
     "        p_r += clock64() - p_m; p_m = clock64();\n"),
    ("        // 2. the cluster's row CSR: a row's edges take the blocks' "
     "counts\n",
     "        p_d += clock64() - p_m; p_m = clock64();\n"),
    ("        cluster.sync();                         // every count is "
     "final\n",
     "        p_w += clock64() - p_m; p_m = clock64();\n"),
    ("        cluster.sync();                         // every edge is in "
     "place\n",
     "        p_s += clock64() - p_m; p_m = clock64();\n"),
    ("        // 4. rows that continue past a warp: partial states through "
     "shared\n",
     "        __syncthreads(); p_g += clock64() - p_m; p_m = clock64();\n"),
    ("        if (row_has) s.written[tid] = 1;\n",
     "        p_c += clock64() - p_m;\n"),
    ("      if (!s.written[r]) flush(a, s, r, row_base, zero);\n",
     "    if (threadIdx.x == 0) {\n"
     "      using u64 = unsigned long long;\n"
     "      const u64 t = clock64() - p_t0;\n"
     "      const long long ph[] = {p_setup, p_r, p_d, p_w, p_s, p_g, p_c};\n"
     "      atomicAdd(&g_prof[0], 1ull);\n"
     "      atomicAdd(&g_prof[1], (u64)p_pass);\n"
     "      for (int i = 0; i < 7; ++i) atomicAdd(&g_prof[2 + i], (u64)ph[i]);\n"
     "      atomicAdd(&g_prof[9], t); atomicMax(&g_prof[10], t);\n"
     "    }\n"),
    ("namespace cg = cooperative_groups;\n",
     "__device__ unsigned long long g_prof[11];\n"
     "extern \"C\" int prof_read(unsigned long long* out) {\n"
     "  return cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof)); }\n"
     "extern \"C\" int prof_zero() { unsigned long long z[11] = {};\n"
     "  return cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }\n"),
]


def _load(name):
    """``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--nhid", type=int, default=512)
    ap.add_argument("variants", nargs="+")
    a = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch.cuda is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    variants = [{} if v == "base" else dict(kv.split("=")
                                            for kv in v.split(","))
                for v in a.variants]
    tmp = tempfile.mkdtemp(prefix="esattn_variants_")
    try:
        return run(a, variants, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _entry(mode, *xs, **kw):
    """The entry point of ``mode`` on its plain version's arguments ``xs``:
    the tiles (three for the rowmax, four else), ``q``, ``k`` and the
    mode's others."""
    from gnn_tpu_torch.ops import esattn as ea
    n = 3 if mode == "rowmax" else 4
    tiles, ops, rest = xs[:n], xs[n:n + 2], xs[n + 2:]
    if mode == "rowmax":
        return ea.cold_rowmax(*tiles, ops, **kw)
    if mode == "terms":
        return ea.cold_terms(*tiles, ops, *rest, **kw)
    return ea.cold_backward(mode, *tiles, ops, *rest, **kw)


def cases(adjs, n, dev):
    """Per layer and mode: ``(label, kernel call, plain result)``."""
    import torch

    from gnn_tpu_torch.ops import esattn as ea
    gen = torch.Generator(device=dev).manual_seed(1)
    out = []
    for l, adj in enumerate(adjs):
        t = (adj.es_coords, adj.es_rc, adj.es_off, adj.es_ord)
        kw = dict(n_heads=1, bm=adj.es_bm, bk=adj.es_bk)
        R, C = adj.nrows, adj.ncols

        def rnd(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=dev) * scale
        q = rnd(R, n, scale=n ** -0.5)
        k, v, gd, gn = rnd(C, n), rnd(C, n), rnd(R, 1), rnd(R, n)
        rm = ea.cold_attention_rowmax_ref(*t[:3], q, k, **kw)
        rm = torch.where(rm > ea.NEG_SENTINEL / 2, rm, torch.zeros_like(rm))
        args = {
            "rowmax": (ea.cold_attention_rowmax_ref, t[:3] + (q, k)),
            "terms": (ea.cold_attention_terms_ref, t + (q, k, v, rm)),
            "bwd_q": (ea.cold_attention_bwd_q_ref,
                      t + (q, k, v, rm, gd, gn)),
            "bwd_kv": (ea.cold_attention_bwd_kv_ref,
                       t + (q, k, v, rm, gd, gn)),
        }
        for mode in MODES:
            plain, xs = args[mode]
            want = plain(*xs, **kw)
            out.append((f"{mode} layer{l}",
                        lambda mode=mode, xs=xs, kw=kw: _entry(mode, *xs,
                                                               **kw),
                        want if isinstance(want, tuple) else (want,)))
    return out


def run(a, variants, tmp) -> int:
    import torch

    from gnn_tpu_torch.ops import cuda_build
    from gnn_tpu_torch.utils.timing import cuda_time_ms
    k1_tool = _load("torch_edgestream_variants")
    jobs = [(v, False, tmp, i, SOURCE, PROBES)
            for i, v in enumerate(variants)]
    if a.profile:
        jobs += [(v, True, tmp, i, SOURCE, PROBES)
                 for i, v in enumerate(variants)]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(k1_tool.build, jobs))

    dev = torch.device("cuda")
    adjs, _, _ = _load("torch_edgestream_probe").default_batch(tmp, dev)
    calls = cases(adjs, a.nhid, dev)

    def use(lib_path):
        cuda_build._LIBS["edge_attention"] = ctypes.CDLL(lib_path)

    n = len(variants)
    for turn, i in enumerate(list(range(n)) + list(reversed(range(n)))):
        so, regs, spill = built[i]
        use(so)
        ms = {}
        for label, fn, want in calls:
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            for y, ref in zip(got, want):
                ok = ref > -1e30
                err = float((y[ok] - ref[ok]).abs().max()
                            / ref[ok].abs().max())
                if not err <= REL_TOL:
                    print(f"{variants[i]} {label}: rel err {err:.3e}",
                          file=sys.stderr)
                    return 1
            ms[label] = cuda_time_ms(fn, 10, 5)
        sums = {m: sum(v for k, v in ms.items() if k.startswith(m + " "))
                for m in MODES}
        print(f"{variants[i] or 'base'} regs {regs} spill {spill}: "
              + " ".join(f"{m} {v:.4f}" for m, v in sums.items())
              + " ms; " + " ".join(f"{k} {v:.4f}" for k, v in ms.items()),
              flush=True)
        if a.profile and turn < n:
            use(built[n + i][0])
            lib = cuda_build._LIBS["edge_attention"]
            for label, fn, _ in calls:
                lib.prof_zero()
                fn()
                torch.cuda.synchronize()
                p = (ctypes.c_ulonglong * 11)()
                lib.prof_read(p)
                b = max(p[0], 1)
                print(f"  profile {label}: blocks {p[0]} passes/block "
                      f"{p[1] / b:.2f}; cycles/block "
                      + " ".join(f"{ph} {p[2 + i] / b:.0f}"
                                 for i, ph in enumerate(PHASES))
                      + f" total {p[9] / b:.0f}, slowest block {p[10]}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
