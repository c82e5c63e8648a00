"""The reduction of a profiled slice against synthetic event lists."""
import pytest

import portbench_tiny  # noqa: F401
from portbench import trace


def test_union_counts_overlap_once():
    # [0,10) [5,15) overlap; [20,30) alone; [22,25) inside it
    s = [0, 5, 20, 22]
    e = [10, 15, 30, 25]
    assert trace.union_seconds(s, e) == pytest.approx(25e-9)
    assert trace.union_seconds([], []) == 0.0


def test_idle_gaps():
    gs, ge = trace.idle_gaps([10, 12, 40], [20, 15, 50], 0, 60)
    assert list(zip(gs, ge)) == [(0, 10), (20, 40), (50, 60)]


def test_reduce_slice_idle_share_and_labels():
    dev = [("k1", 10, 20), ("k2", 15, 30), ("memcpy", 50, 60),
           ("k1", 90, 100), ("outside", 200, 300)]
    host = [("portbench.slice", 0, 100), ("portbench.val_pass", 30, 50),
            ("aten::item", 32, 48)]
    sl = trace.reduce_slice(dev, host, 0, 100)
    assert sl["busy_s"] == pytest.approx(40e-9)
    assert sl["window_s"] == pytest.approx(100e-9)
    assert sl["kernel_calls"] == {"k1": 2, "k2": 1, "memcpy": 1}
    assert sl["device_ops"][0][0] in ("k1", "k2")
    labels = dict(sl["idle_gaps"])
    # 30-50 lies under aten::item (innermost), 60-90 and 0-10 under the
    # slice span
    assert labels["aten::item"] == pytest.approx(20e-9)
    assert labels["portbench.slice"] == pytest.approx(40e-9)


def test_sum_matching():
    secs, calls = trace.sum_matching(
        {"void edge_stream_kernel<0>": 1.0, "void edge_stream_kernel<1>": 2.0,
         "gemm": 5.0}, {"void edge_stream_kernel<0>": 3,
                        "void edge_stream_kernel<1>": 2, "gemm": 1},
        "edge_stream_kernel")
    assert (secs, calls) == (3.0, 5)
