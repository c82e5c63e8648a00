#!/usr/bin/env python3
"""Time variants of the stream SpMM kernel (K2) on one NVIDIA GPU.

    python3 tools/torch_stream_spmm_variants.py [--profile] VARIANT ...

Each VARIANT is a comma-separated list of NAME=VALUE settings, or
``base`` for the code as it is. A NAME is a ``constexpr int`` of
``gnn_tpu_torch/csrc/stream_spmm.cu`` (``SCAN_THREADS=512,STAGES=3``) or
a launch-planning constant of ``gnn_tpu_torch/ops/spmm.py``
(``FILL_BLOCKS=132``, ``MAX_ROWS=64``, ``MAX_SPLIT=8``; ``ACC_FLOATS``
is set in both). Every variant
is built with nvcc (all at once; the registers and spill bytes ptxas
reports are printed), checked against the plain version and timed on
``chip_smoke.py`` phase 3's K2 cases (one blocked batch's three layers
over ``block_*`` and ``block_*_t``, GAT's tile layer both orientations,
the dense and hub-row tiles). The forward and transposed sums weight each
case by its launches per main-path step, as phase 3 does. Variants run in
turns (in order, then reversed), so two readings of each come from one
card.

``--profile`` also builds each variant with ``-DSTREAM_SPMM_PROFILE``
(clock64 counters at the kernel's barriers, read by thread 0) and prints,
per case, the thread blocks, the staged slabs per block and the mean
cycles a block spends in each phase (stage wait, scan, gather and sums,
reading the run's entries, set-up and the final write), with the slowest
block's total.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

SOURCE = os.path.join(ROOT, "gnn_tpu_torch", "csrc", "stream_spmm.cu")
REL_TOL = 1e-4
PHASES = ("wait", "scan", "gather", "entries", "set-up+write")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def split_settings(settings):
    """``(C constants, ops.spmm attributes)`` of one variant; a name both
    define (``ACC_FLOATS``) goes to both."""
    from gnn_tpu_torch.ops import spmm as tsm
    src = open(SOURCE).read()
    py = {k: int(v) for k, v in settings.items()
          if k.isupper() and isinstance(getattr(tsm, k, None), int)}
    c = {k: v for k, v in settings.items()
         if k not in py or f"constexpr int {k} =" in src}
    return c, py


def build(args):
    """nvcc one variant, ``(C settings, profile, out_dir, i)``; returns
    (library path, registers, spill bytes)."""
    from gnn_tpu_torch.ops import cuda_build
    settings, profile, out_dir, i = args
    src = open(SOURCE).read()
    for name, value in settings.items():
        src, n = re.subn(rf"constexpr int {name} = [^;]+;",
                         f"constexpr int {name} = {int(value)};", src)
        if n != 1:
            raise SystemExit(f"no constant {name} in {SOURCE}")
    cu = os.path.join(out_dir, f"variant{i}{'p' if profile else ''}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    flags = ["-DSTREAM_SPMM_PROFILE"] if profile else []
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags,
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
    tmp = tempfile.mkdtemp(prefix="stream_spmm_variants_")
    try:
        return run(a, variants, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(a, variants, tmp) -> int:
    import torch

    from gnn_tpu_torch.ops import cuda_build, spmm as tsm
    from gnn_tpu_torch.utils.timing import cuda_time_ms
    smoke = _load(os.path.join(ROOT, "chip_smoke.py"), "chip_smoke")
    split = [split_settings(v) for v in variants]
    jobs = [(c, False, tmp, i) for i, (c, _) in enumerate(split)]
    if a.profile:
        jobs += [(c, True, tmp, i) for i, (c, _) in enumerate(split)]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(build, jobs))

    dev = torch.device("cuda")
    _, _, pattern = smoke.main_path_batch(tmp, dev)
    blocked, bwidths = smoke.blocked_batch(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    calls = []       # (label, mult, fn, plain result)
    for label, name, st, f, tr, mult in smoke.tile_cases(
            blocked, bwidths, pattern, dev, 512, gen):
        if name == "stream_sddmm" or (label.startswith("GAT tile H=4")):
            continue
        x = torch.randn((st.nrows if tr else st.ncols, f), generator=gen,
                        device=dev)
        calls.append((f"{'tr ' if tr else 'fwd'} {label}", mult,
                      lambda st=st, x=x, tr=tr: tsm.stream_spmm(st, x, tr),
                      tsm.stream_spmm_ref(st, x, tr)))
    defaults = {k: getattr(tsm, k) for _, py in split for k in py}

    def use(lib_path, py):
        cuda_build._LIBS["stream_spmm"] = ctypes.CDLL(lib_path)
        for k, v in {**defaults, **py}.items():
            setattr(tsm, k, v)

    n = len(variants)
    for turn, i in enumerate(list(range(n)) + list(reversed(range(n)))):
        so, regs, spill = built[i]
        use(so, split[i][1])
        ms = {}
        for label, _, fn, want in calls:
            got = fn()
            torch.cuda.synchronize()
            err = float((got - want).abs().max() / want.abs().max())
            if not err <= REL_TOL:
                print(f"{variants[i]} {label}: rel err {err:.3e}",
                      file=sys.stderr)
                return 1
            ms[label] = cuda_time_ms(fn, 10, 5)
        fwd = sum(m * ms[l] for l, m, _, _ in calls if l.startswith("fwd"))
        tr = sum(m * ms[l] for l, m, _, _ in calls if l.startswith("tr "))
        print(f"{variants[i] or 'base'} regs {regs} spill {spill}: K2 fwd "
              f"{fwd:.4f} K2 tr {tr:.4f} ms a step; "
              + "; ".join(f"{k} {v:.4f}" for k, v in ms.items()),
              flush=True)
        if a.profile and turn < n:
            use(built[n + i][0], split[i][1])
            lib = cuda_build._LIBS["stream_spmm"]
            for label, _, fn, _ in calls:
                lib.prof_zero()
                fn()
                torch.cuda.synchronize()
                p = (ctypes.c_ulonglong * 9)()
                lib.prof_read(p)
                b = max(p[0], 1)
                print(f"  profile {label}: blocks {p[0]} slabs/block "
                      f"{p[1] / b:.2f}; cycles/block "
                      + " ".join(f"{ph} {p[2 + j] / b:.0f}"
                                 for j, ph in enumerate(PHASES))
                      + f" total {p[7] / b:.0f}, slowest block {p[8]}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
