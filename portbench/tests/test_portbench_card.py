"""On the card: each tiny cell, at its traffic's own steps a dispatch
(an 8-step CUDA-graph replay at G = 8), runs through the port's CUDA
path (K1 or K3/K4 inside the replays) and reads correct against the
card's limits, and its profiled slice yields the per-layer metrics.
Skips where there is no card; run on the chip with
``python -m pytest --noconftest -m cuda portbench/tests``."""
import pytest
import torch

import portbench_tiny
from portbench import harness, manifest

CELLS = list(portbench_tiny.CELLS)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_tiny_cell_on_the_card(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port's kernels run on the card only")
    cell, cfg, tr = portbench_tiny.tiny(cell_name, card=True)
    man = manifest.load_manifest()
    r = harness.run_cell(cell, cfg, tr, 2 ** 31 + 17, 1.0, True,
                         portbench_tiny.limits(cell_name, card=True),
                         metric_names=manifest.metrics_of(man, cell_name,
                                                          True))
    assert r["correct"], r["checks"]
    assert r["context"]["steps_checked"] == 1 + max(
        tr["steps_per_dispatch"], 2)
    assert r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert "device.idle_share" in r["metrics"]
