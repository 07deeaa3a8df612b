"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (its file is the entry's `file`) and a
traffic mix (`benchmark/traffic/<traffic>.json`); a per-layer metric's
reader is `benchmark/metrics/<name>.py`, a `read(obs)` that returns a
number or None. A later cell, mix or metric is a new file and a new
entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, root: str, workload: str):
    """(workload entry, configuration, traffic mix) of a cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{', '.join(sorted(cells))}")
    w = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        conf = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return w, conf, traffic


def metrics_of(bench: dict, workload: str, kind: str):
    """The metrics of `kind` ("end_to_end" or "per_layer") a cell reports:
    those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def reader(root: str, name: str):
    """The `read` function of benchmark/metrics/<name>.py."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "kbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
