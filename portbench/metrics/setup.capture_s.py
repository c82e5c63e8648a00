"""Seconds of CUDA-graph captures (``dispatch.capture`` spans: the
eager warm-up steps and the recording) in the epochs before the window
and in the checked steps' epochs (``harness.CHECK_EPOCH`` and after):
the set-up's share that grouped dispatch adds. None where the port
records no spans."""


def read(rec):
    try:
        from gnn_tpu_torch.utils.timing import RECORDER
    except ImportError:
        return None
    from portbench.harness import CHECK_EPOCH
    first = rec["window"]["epochs"][0]["epoch"]
    before = [e for e in RECORDER.epochs() if isinstance(e, int)
              and (e < first or e >= CHECK_EPOCH)]
    return RECORDER.total("dispatch.capture", before)
