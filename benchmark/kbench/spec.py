"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (its file is the entry's `file`) and a
traffic mix (`benchmark/traffic/<traffic>.json`); a per-layer metric's
reader is `benchmark/metrics/<name>.py`, a `read(obs)` that returns a
number or None; a configuration whose file has a `"reference"` key is
checked against `benchmark/references/<reference>.py`, and one without
it against `kbench/reference.py`. A later cell, mix, metric or reference
is a new file and a new entry: nothing here changes.

A reference module is the plain reference of one integrator's frame, for
the output check (kbench/check.py) and the budget sweep (sweep.py). It
imports nothing of the port, raises ValueError for a configuration it
does not cover, and has two functions:

  frame_update(frame, conf, box, device)
      The update of one frame, host arrays in as delivered to both sides
      (`frame` holds depth, labels, colors and T_G_C), over the dense box
      `box` (kbench/reference.py Box). It depends on the frame alone, so
      that a run's grid is the sum over frames of count times update
      (reference.py Accumulated). Returns a namespace of:
        idx             the frame's voxels (box indices, ascending) (K,)
        sums            (7, K) float64 by voxel: weight, weight times
                        clamped distance, colour-gated weight, the three
                        gated colour sums, the informative votes
        vote_voxel, vote_label, vote_count
                        the frame's votes, one row per (voxel, label)
        blocks          (B, 3) int64 storage blocks its updates touch
        outside         updates outside the box
        rays            the least max_rays at which it drops nothing
        carve_jobs      the least carve_budget at which it drops nothing
        entries         the update-stream entries its reduces take
        segments        the least segment_budget at which no reduce spills
        touched_blocks  B
        dropped_rays    what it drops past max_rays and carve_budget
        segment_overflow
                        what it spills past segment_budget and past
                        stream_active_fraction of stream_length(conf)
        rank_overflow   votes past sem_stage_ranks labels a voxel
  stream_length(conf)
      The update-stream slots the port sizes for the configuration's
      budgets (`conf["budgets"]`), over which `entries` is counted.
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


def _module(path: str, prefix: str, name: str):
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: str, name: str):
    """The `read` function of benchmark/metrics/<name>.py."""
    return _module(os.path.join(root, "benchmark", "metrics", name + ".py"),
                   "kbench_metric_", name).read


def reference(root: str, conf: dict):
    """The configuration's reference module: benchmark/references/
    <conf["reference"]>.py, or kbench/reference.py without the key."""
    if "reference" not in conf:
        from . import reference as ref
        return ref
    name = conf["reference"]
    return _module(os.path.join(root, "benchmark", "references",
                                name + ".py"), "kbench_reference_", name)
