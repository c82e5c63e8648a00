"""MiB a training step of the window copied into the pinned staging
buffers (the ``dispatch.stage_bytes`` counter over the window's steps;
a short last group stages its repeated batches too). None where the
port counts nothing."""


def read(rec):
    try:
        from gnn_tpu_torch.utils.timing import RECORDER
    except ImportError:
        return None
    w = rec["window"]
    n = RECORDER.total("dispatch.stage_bytes",
                       [e["epoch"] for e in w["epochs"]], "count")
    if n is None or not w["steps"]:
        return None
    return n / 2 ** 20 / w["steps"]
