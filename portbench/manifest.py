"""The benchmark's data, found by name: the cells and metrics of
``BENCHMARK.json`` at the checkout's root, a configuration's
``portbench/configs/<config>.json``, a traffic mix's
``portbench/traffic/<traffic>.json``, a per-layer metric's reader
``portbench/metrics/<metric>.py`` and a cell's limits
``portbench/limits/<cell>.json``. A new cell, configuration, traffic mix
or metric is a new file (and its entry in ``BENCHMARK.json``); no file
of the harness changes."""
from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest(path: str = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json("configs", f"{name}.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def spec(cfg: dict, tr: dict) -> dict:
    """One configuration under one traffic mix: the configuration's keys
    with the traffic's, which the reference, the counts and the program
    read."""
    out = dict(cfg)
    out.update(tr)
    return out


def metrics_of(manifest: dict, cell_name: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones
    (``trace`` True): those without a ``workloads`` key and those whose
    key lists the cell."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str):
    """The ``read(record)`` function of a per-layer metric."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    sp = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read
