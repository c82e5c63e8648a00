"""The benchmark's manifest: names and units in the allowed characters,
and every cell's configuration, traffic and limits, every per-layer
metric's reader, found by name."""
import json
import os

import pytest

import portbench_tiny  # noqa: F401  (puts the repo on the path)
from portbench import check, manifest

MAN = manifest.load_manifest()


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            yield group, e


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=lambda x: x if isinstance(x, str)
                         else x.get("name"))
def test_names_and_units(group, entry):
    assert manifest.NAME.match(entry["name"]), entry["name"]
    if "unit" in entry:
        assert manifest.UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert manifest.NAME.match(entry[key])
    for k in entry.get("reduced", []):
        assert manifest.NAME.match(k)
    keys = ("why", "layer") + (("source",) if group == "configs" else ())
    for key in keys:
        if key in entry:
            v = entry[key]
            assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names))
    metrics = [e["name"] for e in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_resolves_by_name(cell):
    w = manifest.cell(MAN, cell)
    cfg = manifest.config(w["config"])
    tr = manifest.traffic(w["traffic"])
    assert check.load_limits(cell).keys() == set(check.NUMBERS)
    assert w["chips"] in (1, 4)
    spec = manifest.spec(cfg, tr)
    for key in ("model", "nhid", "orders", "n_feats", "classes", "hot_k",
                "batch_size", "samp_num", "steps_per_dispatch",
                "warmup_epochs", "profile_epochs"):
        assert key in spec, key
    e2e = {m["name"] for m in manifest.metrics_of(MAN, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.metrics_of(MAN, cell, True)


def test_configs_are_files_under_paths_and_used():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(manifest.ROOT, c["file"]))
        assert manifest.config(c["name"])["reduced"] == c["reduced"]


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_per_layer_reader_resolves(metric):
    m = next(x for x in MAN["per_layer"] if x["name"] == metric)
    assert callable(manifest.reader(metric))
    assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
    for cell in m.get("workloads", []):
        manifest.cell(MAN, cell)


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
