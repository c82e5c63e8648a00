"""Milliseconds a training step of the window spent from its batch on
the card to its loss read back (`EpochMetrics.execution_time`, captures
left out; host clock, unprofiled)."""


def read(rec):
    w = rec["window"]
    if not w["steps"]:
        return None
    return 1e3 * sum(e["execution_s"] for e in w["epochs"]) / w["steps"]
