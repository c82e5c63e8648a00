"""The additive attention kernels' share of their roofline over the
profiled slice: the least time their calls could take
(`portbench.counts.kernels_additive.additive_calls`, from each batch's
stream tiles at each layer's width and heads: the four calls per layer
of a training step, ``add_rowmax`` and ``add_terms`` per layer of a val
batch) over the device time of ``edge_attention_additive_kernel``.
Nothing where the configuration has no list of heads or the trace holds
fewer calls than counted; where it holds more (a capture's eager
warm-up steps in the slice), their time stays in, and the share reads
low."""
import sys

from portbench import trace
from portbench.counts import kernels, kernels_additive

TRAIN = ("add_rowmax", "add_terms", "add_bwd_q", "add_bwd_kv")
EVAL = ("add_rowmax", "add_terms")


def read(rec):
    sl = rec.get("slice")
    spec = rec["spec"]
    heads = spec.get("heads")
    if not sl or not isinstance(heads, list):
        return None
    last = len(heads) - 1
    widths = [(h * (spec["classes"] if i == last else spec["nhid"] // h), h)
              for i, h in enumerate(heads)]
    bound, calls = 0.0, 0
    for tiles, keys in ([(t, TRAIN) for t in sl["tiles"]]
                        + [(t, EVAL) for t in sl["eval_tiles"]]):
        for t, (n, h) in zip(tiles, widths):
            if t is None:
                continue
            io = kernels_additive.additive_calls(t["e"], t["nb"], t["r"],
                                                 t["c"], n, h)
            for k in keys:
                bound += kernels.bound_s(*io[k])
                calls += 1
    secs, got = trace.sum_matching(sl["kernel_s"], sl["kernel_calls"],
                                   "edge_attention_additive_kernel")
    if got == 0 or secs <= 0:
        return None
    if got != calls:
        print(f"gatv1.attn_roofline: {got} traced calls, {calls} counted",
              file=sys.stderr)
        if got < calls:
            return None
    return 100.0 * bound / secs
