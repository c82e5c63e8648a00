"""Run one cell of ``BENCHMARK.json`` once and print its result as the
last line of standard output (one JSON object), with each number that
decided ``correct`` beside its limit as the last lines of standard
error.

    python3 portbench/run.py --workload sage-reddit-g8 --seed 7 \\
        --seconds 30 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (after the same window, a profiled slice). Every
cache a run may reuse (the generated graph, the native sampler's build,
the placement and hot-block caches of each configuration) lives under
``portbench/.cache`` in the checkout, and the port's CUDA kernels build
into ``gnn_tpu_torch/_build``; the run's own state goes to a directory
under ``TMPDIR`` that the run removes. Exits 2 without a result where
there is no card, or fewer cards than the cell needs."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")


def _cache_env() -> None:
    """Point every cache of the port and its libraries into the
    checkout, at fixed paths."""
    for var, sub in (("GNN_TPU_TORCH_SYNTH_CACHE", "graphs"),
                     ("GNN_TPU_TORCH_NATIVE_CACHE", "native"),
                     ("CUDA_CACHE_PATH", "nv"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)


def _finite(x):
    """A number for the JSON line: non-finite readings become null."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_env()
    sys.path.insert(0, ROOT)
    from portbench import check, harness, manifest
    man = manifest.load_manifest()
    cell = manifest.cell(man, args.workload)
    try:
        result = harness.run_cell(
            cell, manifest.config(cell["config"]),
            manifest.traffic(cell["traffic"]), args.seed, args.seconds,
            bool(args.trace), check.load_limits(cell["name"]),
            t_start=T_START,
            metric_names=manifest.metrics_of(man, cell["name"],
                                             bool(args.trace)))
    except harness.NoCard as e:
        print(f"portbench: {e}; no result", file=sys.stderr)
        return 2
    leaked = harness.forbidden_modules()
    if leaked:
        print("portbench: loaded " + ", ".join(leaked) + "; no result",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
