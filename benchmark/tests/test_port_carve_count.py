"""The count of the decimated carve jobs' kernels (kernel_counts/
carve_jobs_compact.py): its bytes at the uhumans2 cell's shapes by hand,
and a trace of its three kernels read without a problem."""

from __future__ import annotations

import inspect
import os
import types

import pytest

import conftest  # noqa: F401  (puts the benchmark on the path)
from kbench import roofline


def _counts():
    return roofline.load_counts(os.path.join(conftest.BENCH,
                                             "kernel_counts"))


def _ev(name, start, end):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA, is_user_annotation=False,
        time_range=types.SimpleNamespace(
            start=start, end=end, elapsed_us=lambda: end - start))


def _uhumans2_plan():
    """The cell's plan: 10 m rays, 0.05 m voxels, TESSE's 720x480 camera."""
    import kimera_semantics_tpu_torch as kt
    from kimera_semantics_tpu_torch import config as tcfg
    from kimera_semantics_tpu_torch.ops import carve
    cfg = tcfg.FusionConfig(
        grid=tcfg.GridConfig(voxel_size=0.05, voxels_per_side=32),
        tsdf=tcfg.TsdfConfig(truncation_distance=0.1, max_ray_length_m=10.0),
        pipeline=tcfg.PipelineConfig(carve_budget=240640, carve_steps=32,
                                     carve_k_max=32))
    intr = kt.PinholeIntrinsics(fx=415.69219381653056,
                                fy=415.69219381653056, cx=360.0, cy=240.0,
                                width=720, height=480)
    return carve.plan_carve(cfg, intr)


def test_carve_bytes_at_the_uhumans2_cell_by_hand():
    mod = _counts()["carve_jobs_compact"]
    plan = _uhumans2_plan()
    # 720x480 padded to 736x480; levels k 2-32 with 6, 4, 2, 1, 1 chunks.
    assert mod.slots(plan, 480, 720) == (6 * 240 * 368 + 4 * 120 * 184
                                         + 2 * 60 * 92 + 30 * 46 + 15 * 23)
    assert mod.slots(plan, 480, 720) == 631005
    # depth and labels 4 B a pixel, 12 pose words, 240640 jobs of 17
    # words and a flag, the count.
    b = mod.carve_bytes(480, 720, 631005, 240640)
    assert b == 2 * 4 * 720 * 480 + 4 * 12 + 240640 * (17 * 4 + 1) + 4
    assert b == 19369012
    assert mod.carve_bytes(480, 720, 631005, 10 ** 6) == \
        19369012 + 69 * (631005 - 240640)
    thunk = mod.count({"depth": types.SimpleNamespace(shape=(480, 720)),
                       "plan": plan, "budget": 240640})
    # Three launches share the least time.
    assert 3 * thunk() == pytest.approx(19369012 / 3.35e12)


def test_the_count_reads_the_wrappers_parameters():
    from kimera_semantics_tpu_torch.ops import kernels
    names = list(inspect.signature(kernels.carve_jobs_compact).parameters)
    for p in ("depth", "plan", "budget"):
        assert p in names
    assert set(_counts()["carve_jobs_compact"].KERNELS) <= \
        roofline.port_kernel_names(kernels)


def test_a_trace_of_the_carve_kernels_reads_without_a_problem():
    counts = _counts()
    mod = counts["carve_jobs_compact"]
    thunk = mod.count({"depth": types.SimpleNamespace(shape=(480, 720)),
                       "plan": _uhumans2_plan(), "budget": 240640})
    launches = [("carve_jobs_compact", thunk)] * 3 + [
        ("hash_lookup", lambda: 1e-6)]
    events = [_ev("carve_reach_kernel(float const*, int const*)", 0, 4),
              _ev("carve_count_kernel(int const*)", 5, 8),
              _ev("carve_write_kernel(int const*)", 9, 19),
              _ev("void hash_lookup_kernel<16>", 20, 22),
              _ev("void at::native::vectorized_elementwise_kernel<4>", 30,
                  90)]
    port = {"carve_reach_kernel", "carve_count_kernel", "carve_write_kernel",
            "hash_lookup_kernel"}
    share, report = roofline.roofline_share(
        launches, events, port_names=port, counts=counts,
        port_launches={"carve_jobs_compact": 3, "hash_lookup": 1})
    assert report["problems"] == []
    assert report["wrappers"]["carve_jobs_compact"] == {"launches": 3,
                                                        "spans": 3}
    least = 19369012 / 3.35e12 + 1e-6
    assert share == pytest.approx(100.0 * least / 19e-6)
    # A lost span of the chain is reported, not scaled away.
    share, report = roofline.roofline_share(
        launches, events[1:], port_names=port, counts=counts,
        port_launches={"carve_jobs_compact": 3, "hash_lookup": 1})
    assert share is None
    assert report["problems"] == ["carve_jobs_compact: 3 launches, 2 spans"]
