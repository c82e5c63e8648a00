"""Millions of dense hot-part attention entries a training step of the
window computes (``H * rh * ch`` of each resident layer, summed over the
layers: the ``attn.dense_entries`` counter the port adds where it stages
each batch, over the window's steps). None where the port counts
nothing (a model without attention, or a port without the counter)."""


def read(rec):
    try:
        from gnn_tpu_torch.utils.timing import RECORDER
    except ImportError:
        return None
    w = rec["window"]
    n = RECORDER.total("attn.dense_entries",
                       [e["epoch"] for e in w["epochs"]], "count")
    if n is None or not w["steps"]:
        return None
    return n / 1e6 / w["steps"]
