"""The port's span system (kimera_semantics_tpu_torch/utils/timing.py) on
the CPU: spans accumulate and nest, never wait for the device, open a
profiler range only while a profiler runs, and lie where PERF.md's layer
map says on a fast frame served through SemanticTsdfServer. The file
imports nothing of JAX."""

import threading

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from kimera_semantics_tpu_torch import config as tcfg
from kimera_semantics_tpu_torch.core.camera import PinholeIntrinsics
from kimera_semantics_tpu_torch.io import dataset as tdataset
from kimera_semantics_tpu_torch.models import common
from kimera_semantics_tpu_torch.server.pipeline import (SemanticTsdfServer,
                                                        ServerConfig)
from kimera_semantics_tpu_torch.utils import timing

INTR = PinholeIntrinsics(fx=60.0, fy=60.0, cx=39.5, cy=29.5, width=80,
                         height=60)
BAND_PARTS = ("points", "keep", "jobs", "carve_jobs")


@pytest.fixture(autouse=True)
def fresh_registry():
    timing.reset()
    yield
    timing.reset()


class TestTiming:
    def test_accumulation_and_report(self):
        with timing.span("unit/test"):
            pass
        with timing.span("unit/test"):
            pass
        total, count, mean = timing.get("unit/test")
        assert count == 2 and total >= 0
        assert "unit/test" in timing.report()


def test_spans_nest_and_count():
    with timing.span("unit/outer") as outer:
        for _ in range(3):
            with timing.span("unit/inner") as inner:
                pass
    assert timing.get("unit/outer")[1] == 1
    assert timing.get("unit/inner")[1] == 3
    assert inner.elapsed <= outer.elapsed == timing.get("unit/outer")[0]
    assert timing.get("unit/inner")[0] <= outer.elapsed
    timing.count("unit/things", 4)
    timing.count("unit/things")
    assert timing.get("unit/never") == (0.0, 0, 0.0)
    report = timing.report().splitlines()
    assert "host seconds" in report[0]
    assert any(ln.startswith("unit/inner") for ln in report)
    # The counters follow the spans.
    assert report[-2].split() == ["counter", "value"]
    assert report[-1].split() == ["unit/things", "5"]


def test_report_counts_per_frame():
    for _ in range(4):
        with timing.span("server/frame"):
            for _ in range(3):
                with timing.span("sync/unit"):
                    pass
    row = next(ln for ln in timing.report().splitlines()
               if ln.startswith("sync/unit"))
    assert row.split()[1] == "12" and row.split()[-1] == "3.000"


def test_spans_from_threads_all_count():
    def work():
        for _ in range(200):
            with timing.span("unit/thread"):
                pass
    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert timing.get("unit/thread")[1] == 1600


def test_a_span_never_synchronizes(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span synchronized the device")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    with timing.span("unit/sync_free"):
        x = torch.ones(4) * 2
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("unit/sync_free"):
            x = x + 1
    assert timing.get("unit/sync_free")[1] == 2


def test_no_profiler_no_range(monkeypatch):
    opened = []

    class Spy:
        def __init__(self, name, args=None):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.profiler, "record_function", Spy)
    assert not torch.autograd._profiler_enabled()
    with timing.span("unit/off"):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("unit/on", "7"):
            pass
    assert opened == ["unit/on"]
    assert timing.get("unit/off")[1] == timing.get("unit/on")[1] == 1


def _cfg():
    return tcfg.FusionConfig(
        grid=tcfg.GridConfig(voxel_size=0.2, voxels_per_side=8,
                             block_capacity=1024),
        tsdf=tcfg.TsdfConfig(truncation_distance=0.4, max_ray_length_m=8.0,
                             carve_mode="decimated"),
        semantic=tcfg.SemanticConfig(semantic_measurement_probability=0.8),
        pipeline=tcfg.PipelineConfig(block_budget=512, alloc_stride=2,
                                     max_rays=4096),
        integrator=tcfg.IntegratorType("fast"))


class _HostFrames:
    """A dataset of host arrays that the server uploads itself."""

    def __init__(self, n):
        ds = tdataset.SyntheticDataset(num_frames=8, intr=INTR,
                                       device="cpu")
        self.frames = []
        for i in range(n):
            f = ds.frame(i)
            self.frames.append({k: getattr(f, k).numpy()
                                for k in common.FRAME_FIELDS})

    def __len__(self):
        return len(self.frames)

    def host_frames(self):
        yield from self.frames

    def to_frame(self, h):
        return common.frame_from_images(device="cpu", **h)


def test_fast_frame_spans_nest_under_the_profiler():
    srv = SemanticTsdfServer(_cfg(), INTR, server_cfg=ServerConfig(),
                             device="cpu")
    data = _HostFrames(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert srv.run(data) == 3
    ev = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    by = {}
    for e in ev:
        by.setdefault(e.name, []).append((e.time_range.start,
                                          e.time_range.end, e))

    def inside(name, outer):
        """Every `name` span lies in some `outer` span."""
        return all(any(a <= s and e <= b for a, b, _ in by[outer])
                   for s, e, _ in by[name])

    frames = by["server/frame"]
    assert len(frames) == 3
    assert len(by["server/upload"]) == 3
    assert len(by["server/prefetch_wait"]) >= 3
    assert inside("sync/upload", "server/upload")
    assert inside("integrate/fast", "server/frame")
    stages = [n for n in by if n.startswith("integrate_frame/")]
    assert {"integrate_frame/band", "integrate_frame/reduce",
            "integrate_frame/stage"} <= set(stages)
    for n in stages:
        assert inside(n, "server/frame"), n
        assert len(by[n]) % 3 == 0, n
    for part in BAND_PARTS:
        name = f"integrate_frame/band/{part}"
        assert len(by[name]) == 3, name
        assert inside(name, "integrate_frame/band"), name
    for n in ("sync/stage.tile_groups", "sync/stage.glut",
              "sync/stage.votes", "sync/runs.keep", "sync/runs.rank_max",
              "sync/runs.last", "sync/apply.updated"):
        assert inside(n, "server/frame"), n
    # The upload runs before its frame, not inside it.
    assert not any(any(a <= s and e <= b for a, b, _ in frames)
                   for s, e, _ in by["server/upload"])
    # The registry counted what the profiler saw.
    assert timing.get("server/frame")[1] == 3
    assert timing.get("integrate_frame/band/keep")[1] == 3
    assert np.isfinite(timing.get("sync/upload")[0])


def test_sync_sites_sorts_syncs_by_their_innermost_sync_span(monkeypatch):
    """utils/syncs.py sync_sites on a hand-made trace (us): a sync in a
    sync/ span counts for that site, one in a span of the port but in no
    sync/ span for the innermost span, one in no span as "(none)"."""
    import types

    from kimera_semantics_tpu_torch.utils import syncs

    def ev(name, start, end):
        return types.SimpleNamespace(
            name=name, time_range=types.SimpleNamespace(start=start, end=end))
    events = [ev("server/frame", 0, 1000),
              ev("integrate_frame/stage", 100, 600),
              ev("sync/stage.glut", 200, 260),
              ev("cudaStreamSynchronize", 210, 250),
              ev("cudaMemcpy", 300, 310),
              ev("cudaLaunchKernel", 320, 321),
              ev("cudaDeviceSynchronize", 1500, 1600)]
    monkeypatch.setattr(syncs, "_traced", lambda fn: events)
    declared, undeclared, launches = syncs.sync_sites(lambda: None)
    assert declared == {"sync/stage.glut": 1}
    assert undeclared == {"integrate_frame/stage": 1, "(none)": 1}
    assert launches == 1


def test_kernel_build_is_a_span_and_counts_its_libraries(tmp_path,
                                                         monkeypatch):
    """ops/_build.py build_all under a stand-in nvcc that writes its -o
    file: one kernels/build span and kernels/built counts each library
    compiled; a second call finds them built and adds neither."""
    import os
    import stat
    import sys

    from kimera_semantics_tpu_torch.ops import _build
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\n"
                    "import sys\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "open(out, 'w').close()\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD", str(tmp_path / "build"))
    paths = _build.build_all()
    assert all(os.path.exists(p) for p in paths.values())
    assert timing.get("kernels/build")[1] == 1
    assert timing.report().splitlines()[-1].split() == [
        "kernels/built", str(len(_build.SOURCES))]
    _build.build_all()
    assert timing.get("kernels/build")[1] == 1
    assert timing.report().splitlines()[-1].split() == [
        "kernels/built", str(len(_build.SOURCES))]
