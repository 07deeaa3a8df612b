"""The harness end to end on the CPU at a test's size: the result line,
cells found as files alone, the output check against planted faults and
the bfloat16 control."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, DATA, REPO, make_root, run_cell


def _result(lines):
    return json.loads(lines[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(tmp_path, trace):
    root = make_root(tmp_path)
    rc, out, err = run_cell(root, "tiny.batch", trace=trace)
    assert rc == 0
    res = _result(out)
    assert list(res)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert res["device"]["count"] == 1
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"]: m["unit"] for m in bench[kind]
             if "tiny.batch" in m.get("workloads", ["tiny.batch"])}
    if trace:
        # On the CPU only the host readings exist.
        assert {"frame_ms.p95", "stage_ms.band", "stage_ms.reduce",
                "stage_ms.alloc"} <= set(res["metrics"])
        assert "breakdown" in res
    else:
        assert set(res["metrics"]) == set(names)
        assert res["metrics"]["frames_per_s"]["value"] > 0
    for k, v in res["metrics"].items():
        assert v["unit"] == names[k]
    # Each compared number beside its limit: the last lines of stderr.
    checks = [ln for ln in err if ln.startswith("check ")]
    assert err[-len(checks):] == checks
    assert len(checks) == len(res["checks"])
    assert any(ln.startswith("work ") for ln in out[:-1])
    assert any(ln.startswith("host ") for ln in out[:-1])


def _digest(path):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(path)):
        if "__pycache__" in d:
            continue
        for name in sorted(files):
            with open(os.path.join(d, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()


def test_new_cell_and_metric_are_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries run, with no file of the benchmark edited."""
    before = _digest(BENCH), _digest(os.path.join(REPO, "BENCHMARK.json"))

    def extra(root, bench):
        with open(os.path.join(DATA, "tiny.json")) as f:
            conf = json.load(f)
        conf["name"] = "tiny_far"
        conf["scene"]["orbit_radius"] = 3.0
        with open(os.path.join(root, "benchmark", "configs",
                               "tiny_far.json"), "w") as f:
            json.dump(conf, f)
        with open(os.path.join(DATA, "tiny_batch.json")) as f:
            mix = json.load(f)
        mix.update(name="tiny_short", frames=4)
        with open(os.path.join(root, "benchmark", "traffic",
                               "tiny_short.json"), "w") as f:
            json.dump(mix, f)
        with open(os.path.join(root, "benchmark", "metrics",
                               "frames_traced.py"), "w") as f:
            f.write("def read(obs):\n    return obs.traced.frames\n")
        bench["configs"].append({"name": "tiny_far", "source": "test",
                                 "file": "benchmark/configs/tiny_far.json",
                                 "reduced": [], "why": "test"})
        bench["workloads"].append({"name": "tiny_far.tiny_short",
                                   "config": "tiny_far",
                                   "traffic": "tiny_short", "chips": 1,
                                   "why": "test"})
        bench["per_layer"].append({
            "name": "frames_traced", "unit": "frames", "better": "higher",
            "source": "host_clock", "layer": "server loop",
            "moves": "frames_per_s", "workloads": ["tiny_far.tiny_short"]})
    root = make_root(tmp_path, extra)
    rc, out, _ = run_cell(root, "tiny_far.tiny_short", trace=1)
    assert rc == 0
    res = _result(out)
    assert res["correct"] is True
    assert res["metrics"]["frames_traced"]["value"] == 2
    work = json.loads(next(ln for ln in out if ln.startswith("work "))[5:])
    assert work["frames_in_loop"] == 4
    assert (_digest(BENCH), _digest(os.path.join(REPO, "BENCHMARK.json"))) \
        == before


def _skip_one_frame(monkeypatch):
    """A step that returns its state unchanged: the 8th frame the
    integrator sees is not integrated."""
    from kimera_semantics_tpu_torch.models import fast
    real = fast.FastSemanticTsdfIntegrator.integrate
    seen = []

    def integrate(self, grid, frame):
        seen.append(1)
        return grid if len(seen) == 8 else real(self, grid, frame)
    monkeypatch.setattr(fast.FastSemanticTsdfIntegrator, "integrate",
                        integrate)


def _half_the_rays(monkeypatch):
    """Half of a frame's band rays left out."""
    import dataclasses

    from kimera_semantics_tpu_torch.models import fast
    real = fast._band_prepare

    def band_prepare(*a, **kw):
        band, origin, dropped = real(*a, **kw)
        valid = band.valid.clone()
        valid[valid.shape[0] // 2:] = False
        return dataclasses.replace(band, valid=valid), origin, dropped
    monkeypatch.setattr(fast, "_band_prepare", band_prepare)


def _altered_answer(monkeypatch):
    """An answer altered where it is produced: the apply adds one vote
    too many to the first live voxel it writes."""
    from kimera_semantics_tpu_torch.ops import kernels
    real = kernels.block_rmw_add

    def block_rmw_add(wsum, wsdf, sem_count, *a, **kw):
        out = real(wsum, wsdf, sem_count, *a, **kw)
        slots = a[2]
        sem_count[int(slots[0]), 0] += 1.0
        return out
    monkeypatch.setattr(kernels, "block_rmw_add", block_rmw_add)


@pytest.mark.parametrize("fault", [_skip_one_frame, _half_the_rays,
                                   _altered_answer],
                         ids=["unchanged_step", "half_batch",
                              "altered_answer"])
def test_faults_come_out_not_correct(tmp_path, monkeypatch, fault):
    """The rest of a run, the timed path broken underneath: `correct`
    comes out false. (One card: no exchange between chips to leave
    out.)"""
    root = make_root(tmp_path)
    fault(monkeypatch)
    rc, out, _ = run_cell(root, "tiny.batch", seconds=1.5)
    assert rc == 0
    assert _result(out)["correct"] is False


@pytest.mark.parametrize("workload", ["tiny.batch", "tiny.stream"])
def test_control_fails_where_the_port_passes(tmp_path, workload):
    """The bfloat16 control, put in the port's place, fails the check that
    the port's own grid passes (the readings mode, two seeds)."""
    root = make_root(tmp_path)
    rc, out, _ = run_cell(root, workload, seconds=1.0,
                          extra=("--readings", "2", "--control"))
    assert rc == 0
    readings = [json.loads(ln[9:]) for ln in out
                if ln.startswith("readings ")]
    assert len(readings) == 2
    for r in readings:
        assert r["port_passes"] is True
        assert r["control_passes"] is False
        assert r["control"]["weight"] > 10 * r["port"]["weight"]


def test_refuses_without_a_card(tmp_path):
    """Without CUDA the command exits non-zero and prints no result."""
    root = make_root(tmp_path)
    shutil.copytree(os.path.join(BENCH, "kbench"),
                    os.path.join(root, "benchmark", "kbench"))
    shutil.copy(os.path.join(BENCH, "run.py"),
                os.path.join(root, "benchmark", "run.py"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "tiny.batch", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip().endswith("}")


def test_cells_on_card(cuda, tmp_path):
    """Each cell of BENCHMARK.json, one second, on the card: correct."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        rc, out, _ = run_cell(REPO, w["name"], seconds=1.0, device=cuda)
        assert rc == 0 and _result(out)["correct"] is True, w["name"]
