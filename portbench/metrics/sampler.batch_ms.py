"""Milliseconds a sampler worker spends on one batch in the window
(``sampler.batch`` spans over the ``sampler.batches`` counter, summed
over the window's epochs): the LADIES draws and the packing. None where
the port records no spans."""


def read(rec):
    try:
        from gnn_tpu_torch.utils.timing import RECORDER
    except ImportError:
        return None
    epochs = [e["epoch"] for e in rec["window"]["epochs"]]
    secs = RECORDER.total("sampler.batch", epochs)
    n = RECORDER.total("sampler.batches", epochs, "count")
    if secs is None or not n:
        return None
    return 1e3 * secs / n
