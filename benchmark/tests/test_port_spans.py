"""The readers of the port's spans on hand-made traces: the band's parts
and the upload a frame, the host's wait in sync/ spans, and the host syncs
that lie in a span of the port but in no sync/ span (one outside every
span of the port is not counted). Each reads nothing from a trace of a
port without those spans."""

from __future__ import annotations

import types

import pytest

import conftest
from kbench import spec
from kbench.trace import Traced

SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize"}


def _ev(name, start, end, cuda=False):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        is_user_annotation=False,
        time_range=types.SimpleNamespace(
            start=start, end=end, elapsed_us=lambda: end - start))


def _obs(host, frames=2):
    """Two frames (us): frame 0 in [0, 1000], frame 1 in [2000, 3000], a
    device kernel in each."""
    dev = [_ev("k", 10, 20, cuda=True), _ev("k", 2010, 2020, cuda=True)]
    t = Traced(host + dev, window_s=0.004, frames=frames, launches=[])
    return types.SimpleNamespace(traced=t, is_host_sync=SYNCS.__contains__)


def _frames():
    return [_ev("server/frame", 0, 1000), _ev("server/frame", 2000, 3000)]


def read(name, obs):
    return spec.reader(conftest.REPO, name)(obs)


def test_band_parts_and_upload_a_frame():
    host = _frames() + [
        _ev("integrate_frame/band", 100, 900),
        _ev("integrate_frame/band/keep", 100, 400),
        _ev("integrate_frame/band/carve_jobs", 500, 900),
        _ev("integrate_frame/band", 2100, 2900),
        _ev("integrate_frame/band/keep", 2100, 2300),
        _ev("integrate_frame/band/carve_jobs", 2400, 2800),
        _ev("upload (frame_from_images)", 1500, 1900),
        _ev("server/upload", 1550, 1850),
        _ev("server/upload", 3100, 3200)]
    obs = _obs(host)
    # (300 + 200) us over 2 frames; (400 + 400) us; (300 + 100) us.
    assert read("stage_ms.band.keep", obs) == pytest.approx(0.25)
    assert read("stage_ms.band.carve_jobs", obs) == pytest.approx(0.4)
    assert read("stage_ms.upload", obs) == pytest.approx(0.2)
    # The band as a whole reads as before.
    assert read("stage_ms.band", obs) == pytest.approx(0.8)


def test_sync_wait_and_undeclared_syncs():
    host = _frames() + [
        _ev("integrate_frame/stage", 100, 600),
        _ev("sync/stage.glut", 200, 260),
        _ev("cudaStreamSynchronize", 210, 250),
        # in a span of the port, in no sync/ span: undeclared
        _ev("cudaStreamSynchronize", 300, 310),
        _ev("server/upload", 1500, 1900),
        _ev("sync/upload", 1600, 1700),
        _ev("cudaStreamSynchronize", 1610, 1690),
        _ev("integrate_frame/reduce", 2100, 2500),
        _ev("sync/runs.rank_max", 2200, 2240),
        _ev("cudaDeviceSynchronize", 2205, 2235),
        # the harness's own synchronize after the drive: in no span of
        # the port, not counted
        _ev("cudaDeviceSynchronize", 3500, 3900),
        # not a sync
        _ev("cudaLaunchKernel", 2300, 2301)]
    obs = _obs(host)
    # (60 + 100 + 40) us over 2 frames.
    assert read("sync_ms.wait", obs) == pytest.approx(0.1)
    assert read("syncs_undeclared_per_frame", obs) == pytest.approx(0.5)
    # Every sync declared: 0, not nothing.
    obs = _obs([e for e in host if e.time_range.start != 300])
    assert read("syncs_undeclared_per_frame", obs) == 0.0
    # syncs_per_frame still counts every sync, the harness's too.
    assert read("syncs_per_frame", obs) == pytest.approx(2.0)


def test_a_port_without_the_spans_reads_nothing():
    """The parent's trace: its own stages, no server/ or sync/ spans."""
    host = [_ev("upload (frame_from_images)", 0, 100),
            _ev("integrate_frame/band", 100, 900),
            _ev("integrate_frame/stage", 900, 1000),
            _ev("cudaStreamSynchronize", 950, 960),
            _ev("cudaDeviceSynchronize", 990, 999)]
    obs = _obs(host)
    for name in ("stage_ms.band.keep", "stage_ms.band.carve_jobs",
                 "stage_ms.upload", "sync_ms.wait",
                 "syncs_undeclared_per_frame"):
        assert read(name, obs) is None, name
    assert read("stage_ms.band", obs) == pytest.approx(0.4)


@pytest.mark.parametrize("name", ["stage_ms.band.keep",
                                  "stage_ms.band.carve_jobs",
                                  "stage_ms.upload", "sync_ms.wait",
                                  "syncs_undeclared_per_frame"])
def test_no_trace_or_no_device_reads_nothing(name):
    assert read(name, types.SimpleNamespace(traced=None)) is None
    t = Traced(_frames(), window_s=0.004, frames=0, launches=[])
    assert read(name, types.SimpleNamespace(
        traced=t, is_host_sync=SYNCS.__contains__)) is None
