#!/usr/bin/env python3
"""Profile the PyTorch port's training step on one NVIDIA GPU.

    python3 tools/torch_profile_step.py [--warmup 5] [--steps 10] [CLI flags]
    python3 tools/torch_profile_step.py --model gat
    python3 tools/torch_profile_step.py --model gat --adj_format pattern
    python3 tools/torch_profile_step.py --adj_format blocked \
        --dataset synthetic:nodes=50000,deg=30 --samp_num 2048 --batch_size 512
    python3 tools/torch_profile_step.py --adj_format hot
    python3 tools/torch_profile_step.py --sampler subgraph

Sets up the configuration `gnn_tpu_torch.cli` would train (its defaults
unless CLI flags are given, e.g. ``--model gat``, ``--adj_format
blocked`` / ``hot`` or ``--sampler subgraph``), runs ``--warmup``
steps, then ``--steps`` steps under ``torch.profiler``, and prints:

* per step: seconds waiting for the sampler, moving the batch to the
  card, and running the step (ending with the loss read back);
* the device busy share over the window (kernel time / wall time);
* device time per step by kind of kernel (dense matmuls, the port's
  hand-written kernels, everything else);
* the kernels by total device time per step, with their shares.
"""
from __future__ import annotations

import argparse
import collections
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# kernel-name patterns of each kind, first match wins (the hand-written
# kernels' names come from gnn_tpu_torch/csrc)
KINDS = [
    ("tile-stream SpMM / SDDMM K2/K5 (stream_spmm.cu)",
     ("stream_spmm_kernel", "stream_sddmm_kernel")),
    ("edge-stream attention K3/K4 (edge_attention.cu)",
     ("edge_attention_kernel",)),
    # K1 and K6 are one kernel template; K6 is its mode 2 (SEG)
    ("segment-grid SpMM K6 (edge_stream.cu)", ("edge_stream_kernel<2",)),
    ("edge-stream SpMM K1 (edge_stream.cu)", ("edge_stream_kernel",)),
    ("dense matmuls (cuBLAS / CUTLASS)",
     ("gemm", "gemv", "nvjet", "cutlass", "xmma", "sm90_")),
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--steps", type=int, default=10)
    own, rest = ap.parse_known_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gnn_tpu_torch import cli
    from gnn_tpu_torch.sampling.pipeline import BatchPipeline
    from gnn_tpu_torch.train.stepfns import to_device_batch

    if not torch.cuda.is_available():
        print("torch.cuda is not available", file=sys.stderr)
        return 2
    save_dir = tempfile.mkdtemp(prefix="gnn_tpu_torch_profile_")
    try:
        args = cli.build_parser().parse_args(
            rest + ["--epoch_num", "0", "--save_dir", save_dir])
        trainer, graph = cli.train(args)   # set-up only: zero epochs
        old = trainer.pipeline
        pipe = BatchPipeline(old.cfg, old.lap, old.labels,
                             pool_num=args.pool_num, seed=args.seed)
        trainer.pipeline = pipe
        it = pipe.train_epoch(graph.train_nodes, epoch=0)

        def step():
            t0 = time.perf_counter()
            mb = next(it)
            t1 = time.perf_counter()
            b = to_device_batch(mb, trainer.device)
            t2 = time.perf_counter()
            float(trainer.train_step(b))
            return t1 - t0, t2 - t1, time.perf_counter() - t2

        for _ in range(own.warmup):
            step()
        torch.cuda.synchronize()
        split = [0.0, 0.0, 0.0]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(own.steps):
                for i, v in enumerate(step()):
                    split[i] += v
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        pipe.close()
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)

    by_name = collections.Counter()
    calls = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            calls[e.name] += 1
    busy = sum(by_name.values()) / 1e6
    n = own.steps
    print(f"gpu: {torch.cuda.get_device_name(0)}")
    print(f"window: {n} steps after {own.warmup} warm-up, "
          f"{wall / n * 1e3:.3f} ms/step wall")
    print(f"host per step: sampler wait {split[0] / n * 1e3:.3f} ms, "
          f"to device {split[1] / n * 1e3:.3f} ms, step "
          f"{split[2] / n * 1e3:.3f} ms")
    print(f"device busy {busy / n * 1e3:.3f} ms/step = "
          f"{busy / wall:.3f} of wall (idle {1 - busy / wall:.3f})")
    kinds = collections.Counter()
    for name, us in by_name.items():
        kind = next((k for k, pats in KINDS
                     if any(p in name for p in pats)), "everything else")
        kinds[kind] += us
    print("device time per step by kind:")
    for kind, us in kinds.most_common():
        print(f"  {us / n / 1e3:9.4f} ms  {us / 1e6 / busy:6.3f}  {kind}")
    print("kernels by device time per step:")
    for name, us in by_name.most_common(25):
        print(f"  {us / n / 1e3:9.4f} ms  {us / 1e6 / busy:6.3f}  "
              f"x{calls[name] / n:5.1f}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
