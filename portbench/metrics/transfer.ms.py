"""Milliseconds a training step of the window spent moving its batch to
the card (`EpochMetrics.data_movement_time`: ``to_device_batch``, or the
grouped path's staging less its wait for the card; host clock,
unprofiled)."""


def read(rec):
    w = rec["window"]
    if not w["steps"]:
        return None
    return 1e3 * sum(e["data_movement_s"] for e in w["epochs"]) / w["steps"]
