#!/usr/bin/env python3
"""Time gat's hot part on its live entries on one NVIDIA GPU, at the
shapes of one batch of a configuration (default: the benchmark cell
``gat-reddit-g8``'s graph, widths, hot block and batch).

    python3 tools/torch_hotdot_probe.py [CLI flags]

Runs ``chip_smoke.py``'s phase 3 dot check on that batch: each dot mode
(dot_rowmax, dot_terms, dot_bwd_row, dot_bwd_col) against its plain
version, timed by CUDA events with its bound and the rows it gathers,
then each layer's live route (mask pass, row max, terms, backward)
beside the dense grid route it replaced, with the memory each allocates.
CLI flags (`gnn_tpu_torch.cli`'s) replace the defaults below.
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# portbench/configs/gat-reddit.json and traffic ladies-b512-g8
CELL = ["--dataset",
        "synthetic:nodes=232965,deg=100,feats=602,classes=41,seed=0",
        "--model", "gat", "--nhid", "512", "--hot_k", "16384", "--norm",
        "row", "--batch_size", "512", "--samp_num", "8192"]


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from gnn_tpu_torch import cli
    if not torch.cuda.is_available():
        print("torch_hotdot_probe: no CUDA card", file=sys.stderr)
        return 2
    argv = argv or CELL
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(cs.card())
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        adjs, _, _ = cs.load_probe().default_batch(d, dev, argv)
        cs.log(f"batch in {time.perf_counter() - t0:.1f}s")
        nhid = cli.build_parser().parse_args(argv).nhid
        for key, tot in cs.check_dot_attention(adjs, dev, nhid).items():
            cs.log(f"{key}: {tot}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
