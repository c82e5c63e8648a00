"""Seconds the port's own set-up spans took before any epoch: the CLI's
set-up (``setup.cli``: graph load, Laplacian, placement, sampling
probabilities, hot block, resident graph), the feature table's upload
(``setup.features``) and the trainer's construction
(``setup.trainer``); the recorder's ``"setup"`` totals. None where the
port records no spans."""
SPANS = ("setup.cli", "setup.features", "setup.trainer")


def read(rec):
    try:
        from gnn_tpu_torch.utils.timing import RECORDER, SETUP
    except ImportError:
        return None
    parts = [RECORDER.total(name, [SETUP]) for name in SPANS]
    if all(p is None for p in parts):
        return None
    return sum(p for p in parts if p is not None)
