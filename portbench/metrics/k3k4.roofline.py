"""K3/K4's share of their roofline over the profiled slice: the least
time their calls could take (`portbench.counts.kernels.k3k4_calls`, from
each batch's stream tiles: rowmax, terms, bwd_q and bwd_kv per layer of
a training step, rowmax and terms per layer of a val batch) over the
device time of ``edge_attention_kernel``. Nothing where the trace holds
fewer calls than counted; where it holds more (a capture's eager warm-up
steps in the slice), their time stays in, and the share reads low."""
import sys

from portbench import trace
from portbench.counts import kernels


def read(rec):
    sl = rec.get("slice")
    if not sl:
        return None
    spec = rec["spec"]
    n, h = spec["nhid"], spec.get("heads", 1)
    bound, calls = 0.0, 0
    for tiles, keys in ([(t, ("rowmax", "terms", "bwd_q", "bwd_kv"))
                         for t in sl["tiles"]]
                        + [(t, ("rowmax", "terms"))
                           for t in sl["eval_tiles"]]):
        for t in tiles:
            if t is None:
                continue
            io = kernels.k3k4_calls(t["e"], t["nb"], t["r"], t["c"], n, h)
            for k in keys:
                bound += kernels.bound_s(*io[k])
                calls += 1
    secs, got = trace.sum_matching(sl["kernel_s"], sl["kernel_calls"],
                                   "edge_attention_kernel")
    if got == 0 or secs <= 0:
        return None
    if got != calls:
        print(f"k3k4.roofline: {got} traced calls, {calls} counted",
              file=sys.stderr)
        if got < calls:
            return None
    return 100.0 * bound / secs
