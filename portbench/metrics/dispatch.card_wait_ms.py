"""Milliseconds a training step of the window waited for the card
(``dispatch.card_wait`` spans: the pinned buffers' event before a group
is staged, and the epoch-end loss read, over the window's steps). None
where the port records no spans."""


def read(rec):
    try:
        from gnn_tpu_torch.utils.timing import RECORDER
    except ImportError:
        return None
    w = rec["window"]
    secs = RECORDER.total("dispatch.card_wait",
                          [e["epoch"] for e in w["epochs"]])
    if secs is None or not w["steps"]:
        return None
    return 1e3 * secs / w["steps"]
