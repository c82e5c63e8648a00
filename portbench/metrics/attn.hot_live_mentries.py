"""Millions of live hot-part attention entries a training step of the
window walks (``H`` times the hot-hot entries that hold an edge, summed
over the layers whose hot part runs on its live entries: the
``attn.hot_live_entries`` counter that the port's row pass counts on the
device and reads at each epoch's end, over the window's steps). None
where the port counts nothing (a model whose hot part runs as a dense
grid, or a port without the counter)."""


def read(rec):
    try:
        from gnn_tpu_torch.utils.timing import RECORDER
    except ImportError:
        return None
    w = rec["window"]
    n = RECORDER.total("attn.hot_live_entries",
                       [e["epoch"] for e in w["epochs"]], "count")
    if n is None or not w["steps"]:
        return None
    return n / 1e6 / w["steps"]
