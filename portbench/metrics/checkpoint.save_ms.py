"""Milliseconds of the rolling checkpoint's write an epoch of the window
(``checkpoint.save`` spans in ``Trainer.save``, over the window's
epochs). None where the port records no spans."""


def read(rec):
    try:
        from gnn_tpu_torch.utils.timing import RECORDER
    except ImportError:
        return None
    epochs = [e["epoch"] for e in rec["window"]["epochs"]]
    secs = RECORDER.total("checkpoint.save", epochs)
    if secs is None:
        return None
    return 1e3 * secs / len(epochs)
