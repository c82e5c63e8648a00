"""The frozen counts against hand-counted tiny batches."""
import pytest

import portbench_tiny  # noqa: F401
from portbench.counts import kernels, peaks, step


def test_k1_call_hand_counted():
    # 10 cold edges in 3 entries, 4 rows read, 2 written, width 8
    nbytes, flops = kernels.k1_call(e=10, nb=3, n_in=4, n_out=2, f=8,
                                    rows=2, cols=4)
    assert nbytes == 2 * 10 + 16 * 3 + 4 * 6 * 8 + 4 * 6
    assert flops == 2 * 10 * 8 + 6 * 8


def test_k3k4_calls_hand_counted():
    io = kernels.k3k4_calls(e=10, nb=3, r=2, c=4, n=8, h=1)
    base = 20 + 48
    qkv = 4 * (2 * 8 + 2 * 4 * 8)
    assert io["rowmax"] == (base + 4 * (16 + 32) + 8, 160)
    assert io["terms"] == (base + qkv + 8 + 4 * (2 + 16), 320)
    assert io["bwd_q"] == (base + qkv + 4 * (4 + 16) + 64, 480)
    assert io["bwd_kv"] == (base + qkv + 4 * (4 + 16) + 12 + 256, 640)


def test_bound_takes_the_larger():
    assert kernels.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert kernels.bound_s(0, 67e12) == pytest.approx(1.0)


CFG = {"model": "graphsage", "nhid": 4, "n_feats": 3, "orders": [1, 1],
       "classes": 2, "hot_dtype": "bfloat16"}


def test_graphsage_step_hand_counted():
    layers = [{"r": 5, "c": 7, "nnz": 9, "nnz_hot": 4},
              {"r": 2, "c": 5, "nnz": 3, "nnz_hot": 0}]
    fwd = step.model_counts("graphsage").forward_flops(CFG, layers, 2)
    # layer 0: B and W on 5 rows (3 -> 4), 5 cold and 4 hot edges at 3
    # layer 1: B and W on 2 rows (8 -> 4), 3 cold edges at 8
    # classifier: 2 rows, 8 -> 2
    f32 = (2 * 2 * 5 * 3 * 4 + 2 * 5 * 3 + 2 * 2 * 2 * 8 * 4 + 2 * 3 * 8
           + 2 * 2 * 8 * 2)
    assert fwd == {"float32": f32, "bfloat16": 2 * 4 * 3}
    want = 3 * (f32 / peaks.PEAK_FLOPS["float32"]
                + 24 / peaks.PEAK_FLOPS["bfloat16"])
    assert step.step_seconds_at_peak(CFG, layers, 2) == pytest.approx(want)


def test_gat_step_hand_counted():
    cfg = dict(CFG, model="gat")
    layers = [{"r": 5, "c": 7, "nnz": 9, "nnz_hot": 4},
              {"r": 2, "c": 5, "nnz": 3, "nnz_hot": 0}]
    fwd = step.model_counts("gat").forward_flops(cfg, layers, 2)
    # q, self on r rows; k, v on c rows; scores and sum over the edges
    f32 = (2 * (2 * 5 + 2 * 7) * 3 * 4 + 4 * 9 * 4
           + 2 * (2 * 2 + 2 * 5) * 4 * 4 + 4 * 3 * 4 + 2 * 2 * 4 * 2)
    assert fwd == {"float32": f32}


def test_layer_widths():
    assert step.model_counts("graphsage").layer_widths(CFG) == [3, 8]
    assert step.model_counts("gat").layer_widths(CFG) == [3, 4]
