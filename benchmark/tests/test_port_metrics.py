"""The metric arithmetic on hand-worked inputs: the window rate, the p95
over all frames, the roofline's byte counts, the trace's union of device
spans and its idle gaps, and readers that find nothing."""

from __future__ import annotations

import os
import types

import pytest

import conftest  # noqa: F401  (puts the benchmark on the path)
from kbench import port, roofline, stats, spec
from kbench.trace import Traced


def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile(vals[::-1], 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                             15, 16, 17, 18, 19, 20], 95) == 19
    assert stats.percentile([], 95) is None


def test_frame_times_and_window_rate():
    stamps = [10.0, 10.02, 10.05, 10.09]
    times = port.frame_times(stamps, 10.10)
    assert times == pytest.approx([0.02, 0.03, 0.04, 0.01])
    # The rate is every frame over every second of the window.
    window_s = 10.10 - 10.0
    assert len(times) / window_s == pytest.approx(40.0)
    assert sum(times) == pytest.approx(window_s)


def test_p95_reader_over_all_frames():
    read = spec.reader(conftest.REPO, "frame_ms.p95")
    obs = types.SimpleNamespace(frame_s=[0.001 * i for i in range(1, 201)])
    assert read(obs) == pytest.approx(190.0)


def test_k1_bytes_by_hand():
    # R 4 jobs, S 3 steps, MAXR 5: 53 B a job in, 25 B a step out, the
    # run keys 4 B each.
    assert roofline.k1_bytes(4, 3, 5, False) == 53 * 4 + 25 * 12 + 4 * 5 * 4
    assert roofline.k1_bytes(4, 3, 5, False) == 592
    assert roofline.k1_bytes(4, 3, 5, True) == 25 * 4 + 5 * 12 == 160


def test_k6_h1_h2_k5_bytes_by_hand():
    # K6 at S 10, R 100, MAXR 5: run keys in and slots out 2000 B each,
    # 21 B a step in and 21 out, 5 B a job.
    assert roofline.k6_bytes(100, 10, 5) == 2000 + 21000 + 500 + 21000 \
        + 2000
    assert roofline.h1_bytes(512) == 8192
    # H2: a 32768-entry table (two int32 words, read and written), 16376
    # block coordinates (12 B, read and written), 1000 keys and flags.
    assert roofline.h2_bytes(32768, 16376, 1000) == \
        2 * 8 * 32768 + 2 * 12 * 16376 + 5 * 1000
    # K5: 16 live rows of V3 8 with 3 + 2 planes; 10 nonzero w, 6 counts,
    # 7 votes, each word read and written.
    assert roofline.k5_bytes(16, 8, 2, False, 10, 6, 7) == \
        16 * 8 * 4 * 5 + 8 * (20 + 6 + 7)


def test_least_time_takes_the_larger_bound():
    assert roofline.least_s(3.35e12) == pytest.approx(1.0)
    assert roofline.least_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.least_s(3.35e12, 134e12) == pytest.approx(2.0)


def _ev(name, start, end, cuda=True, annotation=False):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        is_user_annotation=annotation,
        time_range=types.SimpleNamespace(
            start=start, end=end, elapsed_us=lambda: end - start))


def _counts():
    return roofline.load_counts(os.path.join(conftest.BENCH,
                                             "kernel_counts"))


PORT_NAMES = {"hash_lookup_kernel", "dda_kernel", "dda_kernel_keys",
              "block_meta_kernel"}


def test_kernel_base_names():
    assert roofline.kernel_base(
        "void (anonymous namespace)::hash_insert_kernel_smem<512, 1>"
        "(int const*, int*)") == "hash_insert_kernel_smem"
    assert roofline.kernel_base("dda_kernel(float const*)") == "dda_kernel"
    assert roofline.kernel_base(
        "void at::native::vectorized_elementwise_kernel<4>(int)") == \
        "vectorized_elementwise_kernel"


def test_port_kernels_are_read_from_the_sources():
    from kimera_semantics_tpu_torch.ops import kernels
    names = roofline.port_kernel_names(kernels)
    assert {"dda_kernel", "dda_kernel_keys", "hash_lookup_kernel",
            "hash_insert_kernel_smem", "block_rmw_kernel",
            "slot_resolve_kernel"} <= names
    # Every kernel a count claims is one of the port's.
    for mod in _counts().values():
        assert set(mod.KERNELS) <= names


def test_roofline_share_matches_launches_to_spans():
    t = 1e-6
    launches = [("hash_lookup", lambda: 2 * t), ("hash_lookup", lambda: t),
                ("dda_job_stream", lambda: 3 * t)]
    events = [_ev("void hash_lookup_kernel<16>", 0, 5),
              _ev("void hash_lookup_kernel<16>", 10, 13),
              _ev("dda_kernel", 20, 24),
              _ev("other_kernel", 30, 90)]
    kw = dict(port_names=PORT_NAMES, counts=_counts(),
              port_launches={"hash_lookup": 2, "dda_job_stream": 1})
    # (2 + 1 + 3) us least over (5 + 3 + 4) us of their device time.
    share, report = roofline.roofline_share(launches, events, **kw)
    assert share == pytest.approx(50.0)
    assert report["wrappers"]["hash_lookup"] == {"launches": 2, "spans": 2}
    assert report["problems"] == []
    # A lost span is reported, not scaled away.
    share, report = roofline.roofline_share(launches, events[1:], **kw)
    assert share is None
    assert report["problems"] == ["hash_lookup: 2 launches, 1 spans"]
    # A port kernel in the trace that no count claims: no reading.
    share, report = roofline.roofline_share(
        launches, events + [_ev("block_meta_kernel", 95, 96)], **kw)
    assert share is None
    assert "block_meta_kernel" in report["problems"][0]
    # Launches the port counted of a wrapper with no count: no reading.
    share, _ = roofline.roofline_share(
        launches, events, **dict(kw, port_launches={"block_meta": 1}))
    assert share is None
    # A launch whose count failed: no reading.
    share, _ = roofline.roofline_share(
        [("hash_lookup", None)], events[:1],
        **dict(kw, problems=["hash_lookup: KeyError"]))
    assert share is None


def test_a_new_kernel_count_is_a_file_alone(tmp_path):
    """A kernel that no count claims reads nothing; a count file added for
    its wrapper, and nothing else, makes the reading."""
    import shutil
    d = tmp_path / "kernel_counts"
    shutil.copytree(os.path.join(conftest.BENCH, "kernel_counts"), d)
    events = [_ev("void block_meta_kernel<8>(int const*)", 0, 4)]
    kw = dict(port_names=PORT_NAMES, port_launches={"block_meta": 1})
    assert roofline.roofline_share([], events, counts=roofline.load_counts(
        str(d)), **kw)[0] is None
    (d / "block_meta.py").write_text(
        "from kbench.roofline import least_s\n"
        "KERNELS = ('block_meta_kernel',)\n"
        "def count(a):\n"
        "    return lambda: least_s(32 * a['fcoords'].shape[0])\n")
    counts = roofline.load_counts(str(d))
    thunk = counts["block_meta"].count(
        {"fcoords": types.SimpleNamespace(shape=(50, 3))})
    share, report = roofline.roofline_share([("block_meta", thunk)], events,
                                            counts=counts, **kw)
    assert report["problems"] == []
    # 1600 bytes at 3.35 TB/s over the span's 4 us.
    assert share == pytest.approx(100.0 * 1600 / 3.35e12 / 4e-6)


def _fake_kernels(launch=True, rename=False):
    """A module like the port's ops/kernels.py with one wrapper, H1."""
    import torch
    mod = types.SimpleNamespace(launches={"hash_lookup": 0})

    def hash_lookup(table_keys, table_slots, keys, table_size, rounds):
        if launch:
            mod.launches["hash_lookup"] += 1
        return keys

    def hash_lookup_renamed(table_keys, table_slots, queries, table_size,
                            rounds):
        mod.launches["hash_lookup"] += 1
        return queries
    mod.hash_lookup = hash_lookup_renamed if rename else hash_lookup
    mod.keys = torch.zeros(512, dtype=torch.int32)
    return mod


def test_recorder_counts_by_parameter_name_and_port_launches():
    k = _fake_kernels()
    with roofline.Recorder(k, _counts()) as rec:
        k.hash_lookup(None, None, table_size=8, rounds=2, keys=k.keys)
    assert [n for n, _ in rec.launches] == ["hash_lookup"]
    assert rec.launches[0][1]() == pytest.approx(16 * 512 / 3.35e12)
    assert rec.port_launches() == {"hash_lookup": 1}
    assert rec.problems == []
    # A call that launched nothing adds no launch.
    k = _fake_kernels(launch=False)
    with roofline.Recorder(k, _counts()) as rec:
        k.hash_lookup(None, None, k.keys, 8, 2)
    assert rec.launches == [] and rec.port_launches() == {}
    # A changed signature is reported, and the launch has no count.
    k = _fake_kernels(rename=True)
    with roofline.Recorder(k, _counts()) as rec:
        k.hash_lookup(None, None, k.keys, 8, 2)
    assert rec.launches == [("hash_lookup", None)]
    assert rec.problems and "keys" in rec.problems[0]


def test_trace_busy_union_and_idle_gaps():
    dev = [_ev("k1", 0, 10), _ev("k2", 5, 15), _ev("k3", 30, 40),
           _ev("k4", 60, 70)]
    host = [_ev("integrate_frame/band", 14, 35, cuda=False, annotation=True),
            _ev("upload (frame_from_images)", 40, 62, cuda=False,
                annotation=True),
            _ev("integrate_frame/reduce", 18, 22, cuda=False,
                annotation=True)]
    tr = Traced(dev + host, window_s=100e-6, frames=2, launches=[])
    assert tr.busy_s() == pytest.approx(35e-6)
    # Gap 15-30 (middle 22.5: band) and 40-60 (middle 50: upload).
    gaps = dict(tr.idle_gaps())
    assert gaps == pytest.approx({"integrate_frame/band": 15e-6,
                                  "upload (frame_from_images)": 20e-6})
    assert tr.range_s("integrate_frame/band") == pytest.approx(21e-6)
    ops = dict(tr.device_ops())
    assert ops["k1"] == pytest.approx(10e-6)
    read = spec.reader(conftest.REPO, "device.idle_share")
    assert read(types.SimpleNamespace(traced=tr)) == pytest.approx(65.0)


@pytest.mark.parametrize("name", ["mesh.latency_p95_ms", "mesh.stall_ms",
                                  "kernels_roofline", "device.idle_share",
                                  "syncs_per_frame", "stage_ms.band"])
def test_readers_with_nothing_to_read_return_nothing(name):
    obs = types.SimpleNamespace(frame_s=[], frames=0, mesh_cycle_s=[],
                                mesh_stall_s=0.0, traced=None,
                                is_host_sync=lambda n: False)
    assert spec.reader(conftest.REPO, name)(obs) is None
