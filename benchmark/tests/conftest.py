"""Helpers of the benchmark's own tests: a checkout-like root in a
temporary directory holding BENCHMARK.json with the tiny cells of
tests/data, and a run of one cell on the CPU."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
DATA = os.path.join(BENCH, "tests", "data")
for _p in (BENCH, REPO):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def make_root(tmp, extra=None):
    """A root with the repo's BENCHMARK.json plus the cells tiny.batch,
    tiny.stream and tiny_merged.batch (and `extra`'s entries), its metric
    readers, kernel counts and references copied."""
    root = os.path.join(str(tmp), "root")
    for d in ("configs", "traffic"):
        os.makedirs(os.path.join(root, "benchmark", d))
    for d in ("metrics", "kernel_counts", "references"):
        shutil.copytree(os.path.join(BENCH, d),
                        os.path.join(root, "benchmark", d),
                        ignore=shutil.ignore_patterns("__pycache__"))
    for c in ("tiny", "tiny_merged"):
        shutil.copy(os.path.join(DATA, c + ".json"),
                    os.path.join(root, "benchmark", "configs", c + ".json"))
    for t in ("tiny_batch", "tiny_stream"):
        shutil.copy(os.path.join(DATA, t + ".json"),
                    os.path.join(root, "benchmark", "traffic", t + ".json"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in ("tiny", "tiny_merged"):
        bench["configs"].append({"name": c, "source": "tests/data",
                                 "file": f"benchmark/configs/{c}.json",
                                 "reduced": [], "why": "the CPU tests' size"})
    for c, t in (("tiny", "batch"), ("tiny", "stream"),
                 ("tiny_merged", "batch")):
        bench["workloads"].append({"name": f"{c}.{t}", "config": c,
                                   "traffic": f"tiny_{t}", "chips": 1,
                                   "why": "the CPU tests' size"})
    # The mesh cycle's readers, which no cell of BENCHMARK.json reports
    # yet, for the meshing test cell.
    for name, unit in (("mesh.latency_p95_ms", "ms"),
                       ("mesh.stall_ms", "ms/frame")):
        bench["per_layer"].append({
            "name": name, "unit": unit, "better": "lower",
            "source": "program_counter", "layer": "mesh cycle",
            "moves": "frames_per_s", "workloads": ["tiny.stream"]})
    if extra:
        extra(root, bench)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def run_cell(root, workload, trace=0, seconds=1.0, seed=2147483911,
             extra=(), device="cpu"):
    """run.main on `device`: (exit code, stdout lines, stderr lines)."""
    import run
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace),
                       *extra], device=device, root=root)
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread, as the benchmark runs it."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """The CUDA device; skips where there is none (decided at run time)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run only there")
    return torch.device("cuda")
