#!/usr/bin/env python3
"""Time variants of the edge-stream kernel (K1 / K6) on one NVIDIA GPU.

    python3 tools/torch_edgestream_variants.py [--profile] VARIANT ...

Each VARIANT is a comma-separated list of NAME=VALUE settings of the
``constexpr int`` constants of ``gnn_tpu_torch/csrc/edge_stream.cu``
(``CAP=1024,MAX_SPLIT=8``), or ``base`` for the source as it is. Every
variant is built with nvcc (all at once; the registers and spill bytes
ptxas reports are printed), checked against the plain version on one
default batch (the probe's set-up, ``tools/torch_edgestream_probe.py``)
and timed on its three layers: K1 forward and transpose, K6 forward and
on the swapped pack. Variants run in turns (in order, then reversed), so
two readings of each come from one card.

``--profile`` also builds each variant with clock64 counters at the
kernel's phase boundaries and prints, per case, the thread blocks, the
passes per block and the mean cycles a block spends in each phase (set-up
and search, decode and cluster sort, gather, boundary-row combine), with
the slowest block's total.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "gnn_tpu_torch", "csrc", "edge_stream.cu")
REL_TOL = 1e-4

# --profile: (anchor line in the kernel, line inserted after it); the
# counters are summed over blocks into g_prof[8]
PROBES = [
    ("  Smem& s = *reinterpret_cast<Smem*>(smem_raw);\n",
     "  long long p_t0 = clock64(), p_dec = 0, p_gat = 0, p_comb = 0, "
     "p_mark = 0, p_pass = 0;\n"),
    ("  int k_hi = lower_bound(tile + 1);\n",
     "  const long long p_setup = clock64() - p_t0;\n"),
    ("    for (int c0 = 0; c0 < tot; c0 += split * CAP) {\n",
     "      p_mark = clock64(); ++p_pass;\n"),
    ("      cluster.sync();                           // every edge is in "
     "place\n",
     "      p_dec += clock64() - p_mark; p_mark = clock64();\n"),
    ("      // 4. rows that continue past a warp: partials through shared\n",
     "      __syncthreads(); p_gat += clock64() - p_mark; "
     "p_mark = clock64();\n"),
    ("      if (row_has) s.written[tid] = 1;\n",
     "      p_comb += clock64() - p_mark;\n"),
    ("    if (!s.written[r]) flush_row<V>(s, y, r, row_base, F, col0, "
     "zero);\n",
     "  if (threadIdx.x == 0) {\n"
     "    const unsigned long long t = clock64() - p_t0;\n"
     "    using u64 = unsigned long long;\n"
     "    atomicAdd(&g_prof[0], 1ull);\n"
     "    atomicAdd(&g_prof[1], (u64)p_pass);\n"
     "    atomicAdd(&g_prof[2], (u64)p_setup);\n"
     "    atomicAdd(&g_prof[3], (u64)p_dec);\n"
     "    atomicAdd(&g_prof[4], (u64)p_gat);\n"
     "    atomicAdd(&g_prof[5], (u64)p_comb);\n"
     "    atomicAdd(&g_prof[6], t); atomicMax(&g_prof[7], t);\n"
     "  }\n"),
    ("namespace cg = cooperative_groups;\n",
     "__device__ unsigned long long g_prof[8];\n"
     "extern \"C\" int prof_read(unsigned long long* out) {\n"
     "  return cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof)); }\n"
     "extern \"C\" int prof_zero() { unsigned long long z[8] = {};\n"
     "  return cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }\n"),
]


def load_probe():
    """``tools/torch_edgestream_probe.py`` as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_edgestream_probe.py")
    spec = importlib.util.spec_from_file_location("torch_edgestream_probe",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def variant_source(settings, profile, source=SOURCE, probes=PROBES):
    src = open(source).read()
    for name, value in settings.items():
        src, n = re.subn(rf"constexpr int {name} = [^;]+;",
                         f"constexpr int {name} = {int(value)};", src)
        if n != 1:
            raise SystemExit(f"no constant {name} in {source}")
    if profile:
        for anchor, line in probes:
            if src.count(anchor) != 1:
                raise SystemExit(f"--profile: anchor not found once in the "
                                 f"kernel (update PROBES): {anchor!r}")
            src = src.replace(anchor, anchor + line)
    return src


def build(args):
    """nvcc one variant, ``(settings, profile, out_dir, i[, source,
    probes])``; returns (library path, registers, spill bytes)."""
    from gnn_tpu_torch.ops import cuda_build
    settings, profile, out_dir, i, *src = args
    cu = os.path.join(out_dir, f"variant{i}{'p' if profile else ''}.cu")
    with open(cu, "w") as f:
        f.write(variant_source(settings, profile, *src))
    so = cu[:-3] + ".so"
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                        "-Xptxas", "-v", "-o", so, cu], capture_output=True,
                       text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed for {settings}:\n{r.stderr[-3000:]}")
    regs = sorted({int(v) for v in re.findall(r"Used (\d+) registers",
                                               r.stderr)})
    spill = sorted({int(v) for v in re.findall(r"(\d+) bytes spill stores",
                                                r.stderr)})
    return so, regs, spill


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true")
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
    tmp = tempfile.mkdtemp(prefix="edge_stream_variants_")
    try:
        return run(a, variants, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(a, variants, tmp) -> int:
    import torch

    from gnn_tpu_torch.ops import cuda_build, edgestream as es
    from gnn_tpu_torch.utils.timing import cuda_time_ms
    probe = load_probe()
    jobs = [(v, False, tmp, i) for i, v in enumerate(variants)]
    if a.profile:
        jobs += [(v, True, tmp, i) for i, v in enumerate(variants)]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(build, jobs))

    dev = torch.device("cuda")
    adjs, widths, _ = probe.default_batch(tmp, dev)
    cases = probe.seg_cases(adjs, widths)
    gen = torch.Generator(device=dev).manual_seed(0)
    calls = []       # (label, fn, plain version)
    for c in cases:
        for tr in (False, True):
            x = torch.randn((c.tiles.nrows if tr else c.tiles.ncols, c.f),
                            generator=gen, device=dev)
            d = "tr " if tr else "fwd"
            calls.append((f"K1 {d} layer{c.layer}",
                          lambda c=c, x=x, tr=tr: es.edge_stream_spmm(
                              c.tiles, x, c.rv, c.nf, tr),
                          es.edge_stream_spmm_ref(c.tiles, x, c.rv, c.nf,
                                                  tr)))
            t, sg, r, f = ((c.tiles_t, c.seg_t, c.nf, c.rv) if tr
                           else (c.tiles, c.seg, c.rv, c.nf))
            calls.append((f"K6 {d} layer{c.layer}",
                          lambda t=t, sg=sg, x=x, r=r, f=f:
                          es.edge_stream_spmm_seg(t, sg, x, r, f),
                          es.edge_stream_spmm_seg_ref(t, sg, x, r, f)))

    def use(lib_path):
        cuda_build._LIBS["edge_stream"] = ctypes.CDLL(lib_path)

    n = len(variants)
    for turn, i in enumerate(list(range(n)) + list(reversed(range(n)))):
        so, regs, spill = built[i]
        use(so)
        ms = {}
        for label, fn, want in calls:
            got = fn()
            torch.cuda.synchronize()
            err = float((got - want).abs().max() / want.abs().max())
            if not err <= REL_TOL:
                print(f"{variants[i]} {label}: rel err {err:.3e}",
                      file=sys.stderr)
                return 1
            ms[label] = cuda_time_ms(fn, 10, 5)
        k1f = sum(v for k, v in ms.items() if k.startswith("K1 fwd"))
        k1t = sum(v for k, v in ms.items() if k.startswith("K1 tr"))
        k6 = sum(v for k, v in ms.items() if k.startswith("K6"))
        print(f"{variants[i] or 'base'} regs {regs} spill {spill}: K1 fwd "
              f"{k1f:.4f} K1 tr {k1t:.4f} K6 {k6:.4f} ms; "
              + " ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
        if a.profile and turn < n:
            use(built[n + i][0])
            lib = cuda_build._LIBS["edge_stream"]
            for label, fn, _ in calls:
                lib.prof_zero()
                fn()
                torch.cuda.synchronize()
                p = (ctypes.c_ulonglong * 8)()
                lib.prof_read(p)
                b = max(p[0], 1)
                print(f"  profile {label}: blocks {p[0]} passes/block "
                      f"{p[1] / b:.2f}; cycles/block set-up {p[2] / b:.0f} "
                      f"decode+sort {p[3] / b:.0f} gather {p[4] / b:.0f} "
                      f"combine {p[5] / b:.0f} total {p[6] / b:.0f}, "
                      f"slowest block {p[7]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
