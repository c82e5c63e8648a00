"""The comparison that decides ``correct``, at a tiny size on the CPU:
a sound run of each cell reads correct; the control (the reference in
TF32 put in the program's place) and the faults planted in the program
(a step that leaves its state unchanged; half of each batch left out of
the loss, the mean taken over the rest; the last checked step run on
the step before's batch, as a replay step reading a stale buffer) read
not correct."""
import numpy as np
import pytest
import torch

import portbench_tiny
from portbench import check, harness
from portbench.reference import train as reftrain

CELLS = list(portbench_tiny.CELLS)


def _run(cell_name, seed=7):
    cell, cfg, tr = portbench_tiny.tiny(cell_name)
    return harness.run_cell(cell, cfg, tr, seed, 0.5, False,
                            portbench_tiny.limits(cell_name), device="cpu",
                            require_card=False, metric_names=[])


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_sound_run_is_correct(cell_name):
    r = _run(cell_name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_is_not_correct(cell_name, tmp_path):
    cell, cfg, tr = portbench_tiny.tiny(cell_name)
    spec = portbench_tiny.spec_of(cell, cfg, tr)
    static = harness.setup_static(spec, "cpu")
    trainer, pipe, _, params0 = harness.new_trainer(static, spec, 11,
                                                    str(tmp_path))
    st = harness.RunState()

    def sink(mb, kind):
        st.check_batches.append(harness.program.batch_view(mb, st.epoch))
    harness.program.Feed(pipe, sink)
    try:
        prog = harness.checked_steps(st, trainer, static["graph"], spec, 11)
    finally:
        pipe.close()
    rg = harness.reference_graph(static["graph"], spec)
    steps = reftrain.prepare(spec, rg, st.check_batches,
                             static["graph"].feats, static["dev"])
    ref = reftrain.follow(spec, params0, steps)
    limits = portbench_tiny.limits(cell_name)
    assert check.verdict(check.numbers(prog, ref, params0), limits)
    control = reftrain.follow(spec, params0, steps, precision="tf32")
    nums = check.numbers(control, ref, params0)
    assert not check.verdict(nums, limits), nums


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_step_that_leaves_its_state_unchanged_is_not_correct(
        cell_name, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    r = _run(cell_name)
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell_name", CELLS)
def test_half_the_batch_left_out_is_not_correct(cell_name, monkeypatch):
    from gnn_tpu_torch.train import trainer as trainer_mod
    loss = trainer_mod.masked_loss

    def half(preds, labels, mask, sigmoid):
        valid = torch.nonzero(mask).flatten()
        kept = mask.clone()
        kept[valid[len(valid) // 2:]] = 0.0
        return loss(preds, labels, kept, sigmoid)
    monkeypatch.setattr(trainer_mod, "masked_loss", half)
    r = _run(cell_name)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_stale_step_is_not_correct(cell_name, monkeypatch):
    from gnn_tpu_torch.train.trainer import Trainer
    step = Trainer._step
    _, _, tr = portbench_tiny.tiny(cell_name)
    last = max(tr["steps_per_dispatch"], 2)     # the last checked step
    seen = []

    def stale(self, batch):
        seen.append(batch)
        n = len(seen) - 1
        return step(self, seen[n - 1] if n == last else batch)
    monkeypatch.setattr(Trainer, "_step", stale)
    r = _run(cell_name)
    assert not r["correct"], r["checks"]
    assert r["checks"]["step_gap"]["value"] > r["checks"]["step_gap"][
        "limit"]


def test_a_batch_the_graph_does_not_bear_out_is_caught():
    cell, cfg, tr = portbench_tiny.tiny("sage-reddit-g8")
    spec = portbench_tiny.spec_of(cell, cfg, tr)
    static = harness.setup_static(spec, "cpu")
    rg = harness.reference_graph(static["graph"], spec)
    from portbench.reference.graph import BatchFault
    train = static["graph"].train_nodes
    cols = np.sort(np.concatenate([train[:4], [train[-1] + 0]]))
    with pytest.raises(BatchFault):
        # columns not holding the rows
        rg.layer(train[4:6], cols, 256)
