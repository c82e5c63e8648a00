"""K1's share of its roofline over the profiled slice: the least time
its calls could take (`portbench.counts.kernels.k1_call`, from each
batch's stream tiles: a forward call per layer, a transpose per layer
whose input takes a gradient, a forward call per layer of each val
batch) over the device time of ``edge_stream_kernel``. Nothing where the
trace holds fewer calls than counted; where it holds more (a capture's
eager warm-up steps in the slice), their time stays in, and the share
reads low."""
import sys

from portbench import trace
from portbench.counts import kernels, step


def read(rec):
    sl = rec.get("slice")
    if not sl:
        return None
    widths = step.model_counts(rec["spec"]["model"]).layer_widths(
        rec["spec"])
    bound, calls = 0.0, 0
    for tiles, train in ([(t, True) for t in sl["tiles"]]
                         + [(t, False) for t in sl["eval_tiles"]]):
        for l, t in enumerate(tiles):
            if t is None:
                continue
            dirs = [(t["c"], t["r"])] + ([(t["r"], t["c"])]
                                         if train and l >= 1 else [])
            for n_in, n_out in dirs:
                bound += kernels.bound_s(*kernels.k1_call(
                    t["e"], t["nb"], n_in, n_out, widths[l], t["r"],
                    t["c"]))
                calls += 1
    secs, n = trace.sum_matching(sl["kernel_s"], sl["kernel_calls"],
                                 "edge_stream_kernel")
    if n == 0 or secs <= 0:
        return None
    if n != calls:
        print(f"k1.roofline: {n} traced calls, {calls} counted",
              file=sys.stderr)
        if n < calls:
            return None
    return 100.0 * bound / secs
