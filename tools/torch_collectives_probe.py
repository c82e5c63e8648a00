#!/usr/bin/env python3
"""Two gloo ranks on one card: do gloo's ``all_reduce`` and
``all_to_all_single`` take CUDA tensors, and how long do the training
step's collectives take?

    python3 tools/torch_collectives_probe.py [--floats N] [--rows R]
                                             [--width F]

Both ranks run on ``cuda:0`` (the port's ``--dist_backend gloo``; NCCL
refuses two ranks on one device). Each checks ``all_reduce`` and an
uneven ``all_to_all_single`` on float32, bfloat16 and int64 CUDA tensors
against the expected values, then times, by the host clock around
``torch.cuda.synchronize()``, the mean of 10 calls after 3 warm-ups of
an ``all_reduce`` of ``--floats`` float32 (default: the default model's
gradient, 2,764,841 floats, plus the loss) and an ``all_to_all_single`` of
``--rows`` rows of ``--width`` float32 split evenly (default: 10000 x
602, about one default batch's layer-0 rows from the peer). Prints the
card's name and power limit, then one JSON line per rank.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mean_ms(fn, reps=10, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def rank_main(rank, rdv, out_dir, floats, rows, width):
    import torch
    import torch.distributed as dist

    from gnn_tpu_torch.parallel import dist as tdist
    ctx = tdist.init_dist(rank, rdv, "cuda", "gloo")
    dev = ctx.device
    rec = {"rank": rank, "device": str(dev), "ok": {}}
    try:
        send = [1, 2] if rank == 0 else [3, 0]
        recv = [1, 3] if rank == 0 else [2, 0]
        want = ([[0, 1, 2, 3], [100, 101, 102, 103], [104, 105, 106, 107],
                 [108, 109, 110, 111]] if rank == 0 else
                [[4, 5, 6, 7], [8, 9, 10, 11]])
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16),
                         ("int64", torch.int64)):
            t = torch.full((5,), rank + 1, dtype=dt, device=dev)
            dist.all_reduce(t)
            rec["ok"][f"all_reduce {name}"] = t.tolist() == [3] * 5
            x = (torch.arange(sum(send) * 4, device=dev).reshape(-1, 4)
                 + 100 * rank).to(dt)
            y = torch.empty(sum(recv), 4, dtype=dt, device=dev)
            dist.all_to_all_single(y, x, output_split_sizes=recv,
                                   input_split_sizes=send)
            rec["ok"][f"all_to_all_single {name}"] = y.tolist() == want
        flat = torch.zeros(floats, device=dev)
        rec["all_reduce_ms"] = _mean_ms(
            lambda: tdist.all_reduce_sum_([flat], ctx))
        half = rows // 2
        x = torch.zeros(2 * half, width, device=dev)
        y = torch.empty_like(x)
        rec["all_to_all_ms"] = _mean_ms(lambda: dist.all_to_all_single(
            y, x, output_split_sizes=[half, half],
            input_split_sizes=[half, half]))
        rec.update(floats=floats, rows=2 * half, width=width)
    finally:
        tdist.close_dist(ctx)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--floats", type=int, default=2_764_842)
    ap.add_argument("--rows", type=int, default=10_000)
    ap.add_argument("--width", type=int, default=602)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from gnn_tpu_torch.parallel import dist as tdist
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    out = tempfile.mkdtemp(prefix="collectives_probe_")
    tdist.JOIN_TIMEOUT_S = 300.0
    tdist.COLLECTIVE_TIMEOUT_S = 120.0
    ok = True
    try:
        tdist.spawn_ranks(2, rank_main, (out, a.floats, a.rows, a.width),
                          rendezvous_dir=out)
        for r in range(2):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                rec = json.load(f)
            ok = ok and all(rec["ok"].values())
            print(json.dumps(rec), flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
