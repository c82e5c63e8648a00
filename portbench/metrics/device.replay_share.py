"""Share of the window's seconds the card spent in CUDA-graph replays,
unprofiled: the ``dispatch.replay_device_s`` counter (CUDA events just
before and after each ``graph.replay()``, read at each epoch's end)
over the window's host-clock seconds. None where the port counts
nothing."""


def read(rec):
    try:
        from gnn_tpu_torch.utils.timing import RECORDER
    except ImportError:
        return None
    w = rec["window"]
    secs = RECORDER.total("dispatch.replay_device_s",
                          [e["epoch"] for e in w["epochs"]], "count")
    if secs is None or w["seconds"] <= 0:
        return None
    return 100.0 * secs / w["seconds"]
