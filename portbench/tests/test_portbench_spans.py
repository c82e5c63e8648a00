"""The per-layer metrics that read the port's span-and-counter recorder
(`gnn_tpu_torch.utils.timing.RECORDER`), each against a hand-seeded
recorder and a synthetic record: the window's epochs alone count (not
set-up, the warm-up, the checked steps or the profiled slice after it),
each reads in its manifest unit, and each reads None where nothing was
recorded or where the port has no recorder."""
import sys
import types

import pytest

import portbench_tiny  # noqa: F401  (puts the repo on the path)
from gnn_tpu_torch.utils.timing import RECORDER, SETUP
from portbench import harness, manifest

MAN = manifest.load_manifest()
NEW = ("setup.build_s", "setup.capture_s", "sampler.batch_ms",
       "pipeline.repad_ms", "dispatch.stage_mib", "dispatch.card_wait_ms",
       "device.replay_share", "eval.val_ms", "checkpoint.save_ms")
# set-up, the checked steps, two warm-up epochs, the window's two, the
# profiled slice's one
WARM, WINDOW, SLICE = (0, 1), (2, 3), (4,)
CHECK = (harness.CHECK_EPOCH, harness.CHECK_EPOCH + 1)
REC = {"window": {"epochs": [{"epoch": 2, "steps": 7},
                             {"epoch": 3, "steps": 9}],
                  "steps": 16, "seconds": 4.0}}


def _span(epoch, name, seconds, calls=1):
    RECORDER.epoch = epoch
    for _ in range(calls):
        ns = int(round(seconds * 1e9 / calls))
        RECORDER._add_span(name, ns, ns, None)


def _count(epoch, name, n):
    RECORDER.epoch = epoch
    RECORDER.count(name, n)


@pytest.fixture
def seeded():
    """Every quantity in every epoch, the window's at known values and
    the rest at values that would show if a reader took them."""
    RECORDER.reset()
    for e in (SETUP,) + CHECK + WARM + SLICE:
        for name in ("sampler.batch", "pipeline.repad",
                     "dispatch.card_wait", "eval.val", "checkpoint.save"):
            _span(e, name, 100.0)
        for name in ("sampler.batches", "dispatch.stage_bytes",
                     "dispatch.replay_device_s"):
            _count(e, name, 1000)
    for e in (SETUP,) + WINDOW + SLICE:
        _span(e, "dispatch.capture", 50.0)
    for e in CHECK + WARM:
        _span(e, "dispatch.capture", 1.5)
    _span(SETUP, "setup.cli", 2.0)
    _span(SETUP, "setup.features", 0.25)
    _span(SETUP, "setup.trainer", 0.5)
    _span(SETUP, "setup.kernels", 100.0)
    for e in WARM + WINDOW:
        _span(e, "setup.cli", 100.0)
    for e, k in zip(WINDOW, (1, 2)):
        _span(e, "sampler.batch", 0.6 * k, calls=3 * k)
        _count(e, "sampler.batches", 3 * k)
        _span(e, "pipeline.repad", 0.016 * k, calls=2)
        _count(e, "dispatch.stage_bytes", 2 ** 20 * 8 * k)
        _span(e, "dispatch.card_wait", 0.008 * k)
        _count(e, "dispatch.replay_device_s", 1.0 * k)
        _span(e, "eval.val", 0.05 * k)
        _span(e, "checkpoint.save", 0.1 * k)
    RECORDER.epoch = SETUP
    yield
    RECORDER.reset()


# per metric: its value from the window alone
EXPECTED = {
    "setup.build_s": 2.75,
    "setup.capture_s": 6.0,
    "sampler.batch_ms": 1e3 * 1.8 / 9,
    "pipeline.repad_ms": 1e3 * 0.048 / 16,
    "dispatch.stage_mib": 24 / 16,
    "dispatch.card_wait_ms": 1e3 * 0.024 / 16,
    "device.replay_share": 100.0 * 3.0 / 4.0,
    "eval.val_ms": 1e3 * 0.15 / 2,
    "checkpoint.save_ms": 1e3 * 0.3 / 2,
}
UNITS = {"setup.build_s": "s", "setup.capture_s": "s",
         "sampler.batch_ms": "ms", "pipeline.repad_ms": "ms",
         "dispatch.stage_mib": "MiB", "dispatch.card_wait_ms": "ms",
         "device.replay_share": "%", "eval.val_ms": "ms",
         "checkpoint.save_ms": "ms"}


def test_every_new_metric_is_declared():
    declared = {m["name"]: m for m in MAN["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["unit"] == UNITS[name]
        assert m["source"] in ("program_span", "program_counter")


@pytest.mark.parametrize("name", NEW)
def test_reads_the_window_alone(seeded, name):
    assert manifest.reader(name)(REC) == pytest.approx(EXPECTED[name],
                                                       rel=1e-9)


@pytest.mark.parametrize("name", NEW)
def test_none_where_nothing_was_recorded(name):
    RECORDER.reset()
    try:
        assert manifest.reader(name)(REC) is None
    finally:
        RECORDER.reset()


@pytest.mark.parametrize("name", NEW)
def test_none_where_the_port_has_no_recorder(name, monkeypatch):
    """The port of an earlier commit has a timing module without the
    recorder: the reader returns None and does not raise."""
    old = types.ModuleType("gnn_tpu_torch.utils.timing")
    monkeypatch.setitem(sys.modules, "gnn_tpu_torch.utils.timing", old)
    assert manifest.reader(name)(REC) is None


def test_empty_window_steps_read_none(seeded):
    rec = {"window": dict(REC["window"], steps=0)}
    for name in ("pipeline.repad_ms", "dispatch.stage_mib",
                 "dispatch.card_wait_ms"):
        assert manifest.reader(name)(rec) is None, name
