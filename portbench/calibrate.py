"""The readings that the limits of ``correct`` are set from, taken on the
chip at a cell's own size, in one process with one set-up:

* for every seed, the program's four numbers (its checked steps against
  the reference's, as a run compares them);
* for the first ``--controls`` seeds, on the same batches, the controls
  and the fault: the port itself with TF32 on (``program_tf32``), the
  reference computed in TF32 put in the program's place
  (``reference_tf32``), the reference with half of each batch left
  out of the loss, the mean taken over the rest (``half_batch``), and
  the reference whose last step reads the step before's batch
  (``stale_step``).

    python3 portbench/calibrate.py --workload gat-reddit-g8 \\
        --seeds 101 102 103 --controls 3 --out calib.jsonl

With ``--tiny`` the cell is the tests' tiny one
(``portbench/tests/portbench_tiny.py``), at each traffic's own steps a
dispatch on the card and at most 2 with ``--device cpu`` (where the
program's TF32 control does not exist and is left out).

Each seed's readings are one JSON line on standard output and in
``--out``. The benchmark's own runs never run this."""
import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _program_side(static, spec, seed, tf32: bool):
    """The program's checked steps for ``seed`` (TF32 on where asked):
    ``(program side, batches, initial parameters, sampler width)``."""
    import torch

    from portbench import harness, program
    torch.backends.cuda.matmul.allow_tf32 = tf32
    run_dir = tempfile.mkdtemp(prefix="portbench-calib-")
    st = harness.RunState()
    trainer, pipe, width, params0 = harness.new_trainer(static, spec, seed,
                                                        run_dir)

    def sink(mb, kind):
        if kind == "train":
            st.check_batches.append(program.batch_view(mb, st.epoch))
    program.Feed(pipe, sink)
    try:
        prog = harness.checked_steps(st, trainer, static["graph"], spec,
                                     seed)
    finally:
        pipe.close()
        shutil.rmtree(run_dir, ignore_errors=True)
        torch.backends.cuda.matmul.allow_tf32 = False
    del trainer, pipe
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return prog, st.check_batches, params0, width


def _same(a: list, b: list) -> bool:
    """Two runs' checked batches hold the same nodes."""
    import numpy as np
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x["caps"] != y["caps"] or x["epoch"] != y["epoch"]:
            return False
        arrs = [("input_nodes",), ("targets",)]
        if not all(np.array_equal(x[k[0]], y[k[0]]) for k in arrs):
            return False
        if len(x["positions"]) != len(y["positions"]) or not all(
                np.array_equal(p, q)
                for p, q in zip(x["positions"], y["positions"])):
            return False
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", default="")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.run import _cache_env
    _cache_env()
    import torch

    from portbench import check, harness, manifest
    from portbench.reference import train as reftrain
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("calibrate: no card", file=sys.stderr)
        return 2
    if not (on_card or args.tiny):
        print("calibrate: a full-size cell runs on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tiny:
        sys.path.insert(0, os.path.join(ROOT, "portbench", "tests"))
        import portbench_tiny
        cell, cfg, tr = portbench_tiny.tiny(args.workload, card=on_card)
    else:
        cell = manifest.cell(manifest.load_manifest(), args.workload)
        cfg = manifest.config(cell["config"])
        tr = manifest.traffic(cell["traffic"])
    spec = manifest.spec(cfg, tr)
    spec["config"] = cell["config"]
    static = harness.setup_static(spec, args.device)
    dev, feats = static["dev"], static["graph"].feats
    rg = harness.reference_graph(static["graph"], spec)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        t_seed = time.perf_counter()
        prog, batches, params0, width = _program_side(static, spec, seed,
                                                      False)
        steps = reftrain.prepare(spec, rg, batches, feats, dev)
        ref = reftrain.follow(spec, params0, steps)
        rec = {"workload": args.workload, "seed": seed,
               "sampler_width": width,
               "program": check.numbers(prog, ref, params0),
               "program_loss_gaps": [abs(a - b) / abs(b) for a, b in zip(
                   prog["losses"], ref["losses"])],
               "losses": ref["losses"]}
        if i < args.controls:
            rec["reference_tf32"] = check.numbers(
                reftrain.follow(spec, params0, steps,
                                precision="tf32"), ref, params0)
            for fault in ("half_batch", "stale_step"):
                rec[fault] = check.numbers(
                    reftrain.follow(spec, params0, steps, fault=fault),
                    ref, params0)
            del steps
        if i < args.controls and on_card:
            prog_t, batches_t, _, _ = _program_side(static, spec, seed, True)
            if not _same(batches_t, batches):
                steps_t = reftrain.prepare(spec, rg, batches_t, feats, dev)
                ref_t = reftrain.follow(spec, params0, steps_t)
            else:
                ref_t = ref
            rec["program_tf32"] = check.numbers(prog_t, ref_t, params0)
            rec["program_tf32_loss_gaps"] = [
                abs(a - b) / abs(b)
                for a, b in zip(prog_t["losses"], ref_t["losses"])]
        rec["seconds"] = time.perf_counter() - t_seed
        line = json.dumps(rec)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
