"""CUDA-graph captures inside the window (`EpochMetrics.captures` summed
over its epochs): each is a compile-like stall the warm-up should have
taken."""


def read(rec):
    return sum(e["captures"] for e in rec["window"]["epochs"])
