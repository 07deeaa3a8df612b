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
import torch

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


def test_new_reference_is_files_alone(tmp_path):
    """A configuration that names a new reference file runs against it,
    with no file of the benchmark edited: a copy of the merged reference
    comes out correct, a wrong one (every weight doubled) not."""
    before = _digest(BENCH), _digest(os.path.join(REPO, "BENCHMARK.json"))
    wrong = ("import importlib.util, os\n"
             "_p = os.path.join(os.path.dirname(__file__), 'merged_full.py')\n"
             "_s = importlib.util.spec_from_file_location('_base', _p)\n"
             "base = importlib.util.module_from_spec(_s)\n"
             "_s.loader.exec_module(base)\n"
             "stream_length = base.stream_length\n"
             "def frame_update(*a):\n"
             "    u = base.frame_update(*a)\n"
             "    u.sums[0] *= 2\n"
             "    return u\n")

    def extra(root, bench):
        refs = os.path.join(root, "benchmark", "references")
        shutil.copy(os.path.join(refs, "merged_full.py"),
                    os.path.join(refs, "merged_copy.py"))
        with open(os.path.join(refs, "merged_wrong.py"), "w") as f:
            f.write(wrong)
        with open(os.path.join(DATA, "tiny_merged.json")) as f:
            conf = json.load(f)
        for name in ("copy", "wrong"):
            conf.update(name=f"tiny_{name}", reference=f"merged_{name}")
            with open(os.path.join(root, "benchmark", "configs",
                                   f"tiny_{name}.json"), "w") as f:
                json.dump(conf, f)
            bench["configs"].append({
                "name": f"tiny_{name}", "source": "test",
                "file": f"benchmark/configs/tiny_{name}.json",
                "reduced": [], "why": "test"})
            bench["workloads"].append({
                "name": f"tiny_{name}.tiny_batch", "config": f"tiny_{name}",
                "traffic": "tiny_batch", "chips": 1, "why": "test"})
    root = make_root(tmp_path, extra)
    for name, correct in (("copy", True), ("wrong", False)):
        rc, out, _ = run_cell(root, f"tiny_{name}.tiny_batch")
        assert rc == 0
        assert _result(out)["correct"] is correct, name
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


def _merged_skip_one_frame(monkeypatch):
    """A step that returns its state unchanged: the 8th frame the merged
    integrator sees is not integrated."""
    from kimera_semantics_tpu_torch.models import merged
    real = merged.MergedSemanticTsdfIntegrator.integrate
    seen = []

    def integrate(self, grid, frame):
        seen.append(1)
        return grid if len(seen) == 8 else real(self, grid, frame)
    monkeypatch.setattr(merged.MergedSemanticTsdfIntegrator, "integrate",
                        integrate)


def _merged_half_the_bundles(monkeypatch):
    """Every second normal bundle of a frame left out."""
    from kimera_semantics_tpu_torch.models import merged
    real = merged._bundle_votes

    def bundle_votes(*a, **kw):
        bvalid, *rest = real(*a, **kw)
        bvalid = bvalid.clone()
        bvalid[1::2] = False
        return (bvalid, *rest)
    monkeypatch.setattr(merged, "_bundle_votes", bundle_votes)


def _merged_last_point(monkeypatch):
    """Clearing bins take their last point, not their first."""
    from kimera_semantics_tpu_torch.models import merged
    real = merged._bundle

    def bundle(points_G, weights, colors, labels, active, **kw):
        n = points_G.shape[0]
        out = list(real(*(x.flip(0) for x in (points_G, weights, colors,
                                                labels, active)), **kw))
        out[5] = torch.where(out[5] < n, n - 1 - out[5], out[5])
        return tuple(out)
    monkeypatch.setattr(merged, "_bundle", bundle)


def _merged_weight_is_count(monkeypatch):
    """A normal bundle's weight replaced by its bin's point count."""
    from kimera_semantics_tpu_torch.models import merged
    real = merged._bundle_scan

    def bundle_scan(*a, max_bundles, **kw):
        out = list(real(*a, max_bundles=max_bundles, **kw))
        seg, act = out[4], out[6]
        count = torch.bincount(seg[act].long(), minlength=max_bundles)
        out[2] = count[:max_bundles].float()
        return tuple(out)
    monkeypatch.setattr(merged, "_bundle_scan", bundle_scan)


def _merged_label_dropped(monkeypatch):
    """One label (the least) dropped from each bundle's histogram."""
    from kimera_semantics_tpu_torch.models import merged
    real = merged._bundle_votes

    def bundle_votes(*a, **kw):
        out = list(real(*a, **kw))
        ray, lab, valid, counts = out[5]
        first = valid.clone()
        first[1:] &= ray[1:] != ray[:-1]
        out[5] = (ray, lab, valid & ~first, counts)
        return tuple(out)
    monkeypatch.setattr(merged, "_bundle_votes", bundle_votes)


def _merged_no_clearing(monkeypatch):
    """The clearing pass skipped."""
    from kimera_semantics_tpu_torch.models import merged
    real = merged.integrate_ray_batch

    def integrate_ray_batch(grid, *a, **kw):
        return real(grid, *a, **kw) if kw.get("ag_own_bundle") else grid
    monkeypatch.setattr(merged, "integrate_ray_batch", integrate_ray_batch)


@pytest.mark.parametrize("fault,workload", [
    pytest.param(_skip_one_frame, "tiny.batch", id="unchanged_step"),
    pytest.param(_half_the_rays, "tiny.batch", id="half_batch"),
    pytest.param(_altered_answer, "tiny.batch", id="altered_answer"),
    pytest.param(_merged_skip_one_frame, "tiny_merged.batch",
                 id="merged_unchanged_step"),
    pytest.param(_merged_half_the_bundles, "tiny_merged.batch",
                 id="merged_half_batch"),
    pytest.param(_altered_answer, "tiny_merged.batch",
                 id="merged_altered_answer"),
    pytest.param(_merged_last_point, "tiny_merged.batch",
                 id="merged_clearing_last_point"),
    pytest.param(_merged_weight_is_count, "tiny_merged.batch",
                 id="merged_weight_is_count"),
    pytest.param(_merged_label_dropped, "tiny_merged.batch",
                 id="merged_label_dropped"),
    pytest.param(_merged_no_clearing, "tiny_merged.batch",
                 id="merged_no_clearing_pass")])
def test_faults_come_out_not_correct(tmp_path, monkeypatch, fault,
                                     workload):
    """The rest of a run, the timed path broken underneath: `correct`
    comes out false. (One card: no exchange between chips to leave
    out.)"""
    root = make_root(tmp_path)
    fault(monkeypatch)
    rc, out, _ = run_cell(root, workload, seconds=1.5)
    assert rc == 0
    assert _result(out)["correct"] is False


def test_tiny_merged_frames_have_clearing_bins():
    """The tiny scene's frames carry clearing bins of several points, so
    that the clearing faults above can show."""
    from kbench import reference as ref
    from kbench import scene, spec
    with open(os.path.join(DATA, "tiny_merged.json")) as f:
        conf = json.load(f)
    with open(os.path.join(DATA, "tiny_batch.json")) as f:
        traffic = json.load(f)
    mod = spec.reference(REPO, conf)
    dev = torch.device("cpu")
    for frame in scene.frames(conf, traffic, 2147483911, dev):
        fp = mod.frame_passes(frame, conf, dev)
        cbin = fp.clearing_bin
        assert fp.clearing["point"].shape[0] > 100
        assert int((torch.bincount(cbin[cbin >= 0]) > 1).sum()) > 100


@pytest.mark.parametrize("workload", ["tiny.batch", "tiny.stream",
                                      "tiny_merged.batch"])
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
