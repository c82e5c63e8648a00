"""Milliseconds a training step of the window waited for its host batch
(`EpochMetrics.sample_wait_time` summed over the window's epochs, over
its steps; host clock, unprofiled)."""


def read(rec):
    w = rec["window"]
    if not w["steps"]:
        return None
    return 1e3 * sum(e["sample_wait_s"] for e in w["epochs"]) / w["steps"]
