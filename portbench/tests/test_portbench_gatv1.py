"""The cell ``gatv1-reddit-g8`` (the published GAT, arXiv:1710.10903) at
a tiny size: the configuration and traffic at their widths on the tests'
3,000-node graph. On the CPU a sound run reads correct, and the control
(the reference in TF32 in the program's place) and the faults (half of
each batch left out of the loss; the last checked step on the step
before's batch) read not correct; the counts of its operations and of
its additive kernels against hand counts; its metrics' readers. On the
card (``-m cuda``) the tiny cell at G = 8 reads correct and its profiled
slice yields the additive kernels' roofline share."""
import pytest
import torch

import portbench_tiny
from portbench import check, harness, manifest
from portbench.counts import kernels_additive, step
from portbench.reference import train as reftrain

CELL = "gatv1-reddit-g8"

# Limits of the compared numbers on the CPU (2 steps a replay, 3
# checked steps), set between the program's readings and the control's
# and the faults' from eight seeds of the tiny cell on the CPU: the
# program read at most 6.7e-8 / 7.0e-8 / 1.4e-7 / 3.1e-7 / 2.0e-7
# (first loss, median loss, largest step's loss, gradient, change); the
# TF32 control at least 6.0e-7 / 1.1e-5 / 3.1e-5 / 1.1e-4 / 5.2e-4; the
# half-batch fault at least 8.3e-5 / 1.5e-3 / 2.0e-3 / 0.039 / 0.034; a
# stale last step at least - / - / 4.8e-3 / - / 0.050.
LIMITS = {"first_loss_gap": 2.5e-7, "loss_gap": 1e-6, "step_gap": 2e-6,
          "grad_gap": 5e-6, "change_gap": 1e-5}
# On the card at G = 8 (9 checked steps, the warm-up's 28 steps taking
# the rate to 1.5e-3 by the last: Adam's updates there spread the later
# steps' gaps), from twelve seeds of the tiny cell there: the program
# read at most 6.7e-8 / 9.0e-6 / 1.1e-4 / 2.7e-7 / 8.7e-5; the two TF32
# controls at least 7.4e-7 / 3.0e-5 / 2.1e-4 / 9.2e-5 / 4.7e-4; the
# half-batch fault at least 1.1e-3 / 0.020 / 0.082 / 0.035 / 0.035; a
# stale last step at least - / - / 0.070 / - / 2.1e-3.
CARD_LIMITS = {"first_loss_gap": 2.5e-7, "loss_gap": 1.6e-5,
               "step_gap": 1.5e-4, "grad_gap": 5e-6, "change_gap": 2e-4}


def tiny(card: bool = False):
    """``(cell, config, traffic)`` of the cell cut to the tiny graph, as
    `portbench_tiny.tiny` cuts the others."""
    cell = {"name": CELL, "config": "tiny-gatv1-reddit",
            "traffic": "ladies-b512-g8", "chips": 1}
    cfg = manifest.config("gatv1-reddit")
    cfg.update(dataset=portbench_tiny.DATASET, hot_k=512)
    tr = manifest.traffic("ladies-b512-g8")
    tr.update(batch_size=64, samp_num=256, pool_num=2)
    if not card:
        tr.update(steps_per_dispatch=2)
    return cell, cfg, tr


def test_a_sound_run_is_correct():
    cell, cfg, tr = tiny()
    r = harness.run_cell(cell, cfg, tr, 7, 0.5, False, LIMITS,
                         device="cpu", require_card=False, metric_names=[])
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["context"]["steps_checked"] == 3


def test_the_control_and_the_faults_are_not_correct(tmp_path):
    cell, cfg, tr = tiny()
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
    assert check.verdict(check.numbers(prog, ref, params0), LIMITS)
    for kw in (dict(precision="tf32"), dict(fault="half_batch"),
               dict(fault="stale_step")):
        bad = reftrain.follow(spec, params0, steps, **kw)
        assert not check.verdict(check.numbers(bad, ref, params0),
                                 LIMITS), kw


CFG = {"model": "gatv1", "nhid": 8, "n_feats": 3, "orders": [1, 1, 1],
       "classes": 2, "heads": [2, 2, 3]}


def test_gatv1_step_hand_counted():
    layers = [{"r": 5, "c": 7, "nnz": 9, "nnz_hot": 4},
              {"r": 3, "c": 5, "nnz": 6, "nnz_hot": 0},
              {"r": 2, "c": 3, "nnz": 3, "nnz_hot": 0}]
    fwd = step.model_counts("gatv1").forward_flops(CFG, layers, 2)
    # layer 0: z on 7 columns (3 -> 8), el and er on 5 + 7 rows, 9 edges
    # and 5 self edges at 8; layer 1: z (8 -> 8) on 5, el / er on 3 + 5,
    # 6 + 3 edges, the residual (8 -> 8) on 3 rows; layer 2: z (8 -> 6)
    # on 3, el / er on 2 + 3, 3 + 2 edges at 6
    want = (2 * 7 * 3 * 8 + 2 * 12 * 8 + 2 * 14 * 8
            + 2 * 5 * 8 * 8 + 2 * 8 * 8 + 2 * 9 * 8 + 2 * 3 * 8 * 8
            + 2 * 3 * 8 * 6 + 2 * 5 * 6 + 2 * 5 * 6)
    assert fwd == {"float32": want}
    assert step.model_counts("gatv1").layer_widths(CFG) == [3, 8, 8]


def test_additive_calls_hand_counted():
    io = kernels_additive.additive_calls(e=10, nb=3, r=2, c=4, n=8, h=2)
    # coords, entries, el [2, 2], er [4, 2], the rows' self columns
    base = 20 + 48 + 16 + 32 + 8
    assert io["add_rowmax"] == (base + 16, 60)
    assert io["add_terms"] == (base + 128 + 16 + 4 * (4 + 16), 160 + 100)
    assert io["add_bwd_q"] == (base + 128 + 4 * (8 + 16) + 16, 160 + 160)
    assert io["add_bwd_kv"] == (base + 128 + 4 * (8 + 16) + 12
                                + 4 * (8 + 32), 320 + 160)


def test_metric_readers():
    rec = {"spec": dict(CFG, nhid=1024, classes=41, heads=[4, 4, 6]),
           "window": {"epochs": [{"epoch": "none"}], "steps": 10},
           "slice": {"tiles": [[{"e": 100, "nb": 3, "r": 8, "c": 16},
                                None, None]],
                     "eval_tiles": [],
                     "kernel_s": {"edge_attention_additive_kernel<1>": 1e-3,
                                  "edge_attention_kernel<1>": 5.0},
                     "kernel_calls": {"edge_attention_additive_kernel<1>": 4,
                                      "edge_attention_kernel<1>": 4}}}
    share = manifest.reader("gatv1.attn_roofline")(rec)
    io = kernels_additive.additive_calls(100, 3, 8, 16, 1024, 4)
    from portbench.counts import kernels
    want = 100 * sum(kernels.bound_s(*io[k]) for k in io) / 1e-3
    assert share == pytest.approx(want)
    # fewer traced calls than counted: nothing to read
    rec["slice"]["kernel_calls"]["edge_attention_additive_kernel<1>"] = 3
    assert manifest.reader("gatv1.attn_roofline")(rec) is None
    # a configuration without a list of heads, or no counter: nothing
    assert manifest.reader("gatv1.attn_roofline")(
        dict(rec, spec={"heads": 1})) is None
    assert manifest.reader("attn.dense_mentries")(rec) is None


@pytest.mark.cuda
def test_tiny_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port's kernels run on the card only")
    cell, cfg, tr = tiny(card=True)
    man = manifest.load_manifest()
    r = harness.run_cell(cell, cfg, tr, 2 ** 31 + 17, 1.0, True,
                         CARD_LIMITS,
                         metric_names=manifest.metrics_of(man, CELL, True))
    assert r["correct"], r["checks"]
    assert r["context"]["steps_checked"] == 9
    assert 0 < r["metrics"]["gatv1.attn_roofline"]["value"] <= 100
    assert r["metrics"]["attn.dense_mentries"]["value"] > 0
