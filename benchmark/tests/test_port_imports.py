"""What the benchmark imports: no module whose top-level name is jax,
jaxlib, flax or kimera_semantics_tpu (compared whole: the port's name
begins with the JAX package's) in a process that ran a cell, and nothing
of the port in the reference's modules."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from conftest import BENCH, REPO, make_root

FORBIDDEN = {"jax", "jaxlib", "flax", "kimera_semantics_tpu"}
PORT = "kimera_semantics_tpu_torch"
# The yardstick: it may import no module of the port.
REFERENCE = ("kbench/reference.py", "kbench/check.py", "kbench/scene.py",
             "kbench/stats.py", "kbench/roofline.py", "kbench/witness.py",
             "sweep.py", "witness.py") + tuple(
                 "references/" + n for n in sorted(os.listdir(
                     os.path.join(BENCH, "references"))) if n.endswith(".py"))


def _top_levels(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=REPO,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    """Every module a whole run of a cell imported, walked by top-level
    name."""
    root = make_root(tmp_path)
    code = f"""
import contextlib, io, json, sys
sys.path[:0] = [{BENCH!r}, {REPO!r}]
import run
with contextlib.redirect_stdout(io.StringIO()):
    rc = run.main(["--workload", "tiny.stream", "--seed", "5", "--seconds",
                   "1", "--trace", "1"], device="cpu", root={root!r})
assert rc == 0
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    names = _top_levels(code)
    assert PORT in names
    assert not names & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    code = f"""
import json, sys
sys.path[:0] = [{BENCH!r}]
import kbench.check, kbench.reference, kbench.roofline, kbench.scene
import kbench.stats, kbench.witness, sweep, witness
from kbench import spec
for name in {[n[:-3] for n in REFERENCE if n.startswith("references/")]!r}:
    spec.reference({REPO!r}, {{"reference": name[len("references/"):]}})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    names = _top_levels(code)
    assert PORT not in names and not names & FORBIDDEN
    for rel in REFERENCE:
        with open(os.path.join(BENCH, rel)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                top = m.split(".")[0]
                assert top != PORT and top not in FORBIDDEN, (rel, m)
