"""Milliseconds of the val pass an epoch of the window (``eval.val``
spans: the val batch drawn on the main thread, the forward and its
read-back, the F1), over the window's epochs. None where the port
records no spans."""


def read(rec):
    try:
        from gnn_tpu_torch.utils.timing import RECORDER
    except ImportError:
        return None
    epochs = [e["epoch"] for e in rec["window"]["epochs"]]
    secs = RECORDER.total("eval.val", epochs)
    if secs is None:
        return None
    return 1e3 * secs / len(epochs)
