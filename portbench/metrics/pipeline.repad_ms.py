"""Milliseconds a training step of the window spent re-padding its
group to common shapes on the main thread (``pipeline.repad`` spans,
inside the trainer's wait for its next group, over the window's steps).
None where the port records no spans."""


def read(rec):
    try:
        from gnn_tpu_torch.utils.timing import RECORDER
    except ImportError:
        return None
    w = rec["window"]
    secs = RECORDER.total("pipeline.repad", [e["epoch"] for e in w["epochs"]])
    if secs is None or not w["steps"]:
        return None
    return 1e3 * secs / w["steps"]
