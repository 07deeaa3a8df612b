"""The port's traversal jobs, carve plan, octave band keep and start-voxel
dedup (ops/carve.py, ops/dedup.py) against the jitted JAX functions on the
same inputs (CPU)."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kimera_semantics_tpu.core.camera import PinholeIntrinsics
from kimera_semantics_tpu.core.color import LabelColorMap
from kimera_semantics_tpu.io.dataset import SyntheticDataset
from kimera_semantics_tpu.models import common as jcommon
from kimera_semantics_tpu.ops import carve as jcarve
from kimera_semantics_tpu.ops import dedup as jdedup

import kimera_semantics_tpu_torch as kt
from kimera_semantics_tpu_torch.ops import carve as tcarve
from kimera_semantics_tpu_torch.ops import dedup as tdedup
from kimera_semantics_tpu_torch.ops import kernels

from test_torch_fast import INTR, TINTR, N, configs

FIELDS = tcarve.JOB_FIELDS


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def frame():
    ds = SyntheticDataset(num_frames=3, intr=INTR,
                          label_map=LabelColorMap.random(21))
    return ds.frame(1)


def prepared(frame, cfg_j):
    out = jax.jit(functools.partial(jcommon.prepare_points, intr=INTR,
                                    cfg=cfg_j))(frame)
    return [N(x) for x in out]


def assert_jobs_equal(tj, jj, rtol=1e-6):
    for f in FIELDS:
        a, b = N(getattr(jj, f)), N(getattr(tj, f))
        assert a.shape == b.shape, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("fx,voxel,k_max", [(40.0, 0.2, 16), (320.0, 0.05, 16),
                                            (600.0, 0.05, 4)])
def test_plan_carve_equal(fx, voxel, k_max):
    cj, ct = (dataclasses.replace(c, grid=dataclasses.replace(
        c.grid, voxel_size=voxel), pipeline=dataclasses.replace(
        c.pipeline, carve_k_max=k_max)) for c in configs("decimated"))
    intr = PinholeIntrinsics(fx=fx, fy=fx, cx=319.5, cy=239.5, width=640,
                             height=480)
    pj = jcarve.plan_carve(cj, intr)
    pt = tcarve.plan_carve(ct, kt.PinholeIntrinsics(**intr.__dict__))
    assert (pt.levels, pt.chunks, pt.k_max) == (pj.levels, pj.chunks,
                                                 pj.k_max)


@pytest.mark.parametrize("kind,carving", [("full", True), ("full", False),
                                          ("band", True)])
def test_ray_jobs_match(frame, kind, carving):
    cj, ct = (dataclasses.replace(c, tsdf=dataclasses.replace(
        c.tsdf, voxel_carving_enabled=carving)) for c in configs("full"))
    _, pts_G, origin, colors, labels, weights, valid, clearing = prepared(
        frame, cj)
    assert clearing.any() and valid.any()
    args = (pts_G, weights, labels, colors, clearing, valid)
    jfn = getattr(jcarve, f"{kind}_jobs")
    jj = jax.jit(lambda o, *a: jfn(jnp.broadcast_to(o, pts_G.shape), *a,
                                   cfg=cj))(origin, *args)
    tj = getattr(tcarve, f"{kind}_jobs")(T(origin)[None, :],
                                         *(T(a) for a in args), cfg=ct)
    assert_jobs_equal(tj, jj)


@pytest.mark.parametrize("budget,route", [
    pytest.param(2048, "parts", id="2048"),
    pytest.param(300, "parts", id="300"),
    pytest.param(2048, "wrapper", id="wrapper-2048"),
    pytest.param(300, "wrapper", id="wrapper-300")])
def test_carve_jobs_and_compaction_match(frame, budget, route):
    """carve_jobs, then compact_jobs, against the JAX package's; the
    "wrapper" cases take the frame's one entry point (decimated_jobs, then
    kernels.carve_jobs_compact, whose CPU path is the plain version)."""
    cj, ct = configs("decimated")
    plan = jcarve.plan_carve(cj, INTR)
    jj = jax.jit(functools.partial(jcarve.carve_jobs, intr=INTR, cfg=cj,
                                   plan=plan))(frame.depth, frame.labels,
                                               frame.T_G_C)
    jc, jdrop = jax.jit(functools.partial(jcarve.compact_jobs,
                                          budget=budget))(jj)
    if route == "parts":
        tj = tcarve.carve_jobs(T(frame.depth), T(frame.labels),
                               T(frame.T_G_C), TINTR, ct,
                               tcarve.plan_carve(ct, TINTR))
        assert_jobs_equal(tj, jj)
        tc, tdrop = tcarve.compact_jobs(tj, budget)
    else:
        ct = dataclasses.replace(ct, pipeline=dataclasses.replace(
            ct.pipeline, carve_budget=budget))
        kernels.reset_launches()
        tc, tdrop = tcarve.decimated_jobs(T(frame.depth), T(frame.labels),
                                          T(frame.T_G_C), TINTR, ct)
        assert kernels.launches["carve_jobs_compact"] == 0
    assert_jobs_equal(tc, jc)
    assert tdrop.dtype == torch.int32 and tdrop.shape == ()
    assert int(tdrop) == int(jdrop)
    assert (int(tdrop) > 0) == (budget < 2048)


UHUMANS2 = dict(fx=415.69219381653056, fy=415.69219381653056, cx=360.0,
                cy=240.0, width=720, height=480)


@pytest.mark.parametrize("camera,voxel,max_ray,k_max,total", [
    (UHUMANS2, 0.05, 10.0, 32, 631005),
    (dict(fx=40.0, fy=40.0, cx=319.5, cy=239.5, width=640, height=480),
     0.2, 5.0, 16, None),
    (dict(fx=320.0, fy=320.0, cx=319.5, cy=239.5, width=641, height=479),
     0.05, 5.0, 64, None),
    (dict(fx=600.0, fy=600.0, cx=319.5, cy=239.5, width=640, height=480),
     0.05, 5.0, 4, None)])
def test_carve_table_matches_the_plan(camera, voxel, max_ray, k_max, total):
    """ops/carve.py carve_table, the plan as csrc/carve.cu reads it: one row
    a chunk in plan order with its level, the level's padded shape and
    plane, the float32 bounds and threshold torch compares in, and slot
    offsets that tile the plain carve_jobs union, which has `total` slots
    at the uhumans2 camera."""
    _, ct = configs("decimated")
    ct = dataclasses.replace(
        ct, grid=dataclasses.replace(ct.grid, voxel_size=voxel),
        tsdf=dataclasses.replace(ct.tsdf, max_ray_length_m=max_ray),
        pipeline=dataclasses.replace(ct.pipeline, carve_k_max=k_max,
                                     carve_steps=32, carve_gamma=1.0))
    intr = kt.PinholeIntrinsics(**camera)
    plan = tcarve.plan_carve(ct, intr)
    H, W = intr.height, intr.width
    tab = tcarve.carve_table(plan, H, W)
    km = plan.k_max
    assert (tab.Hp, tab.Wp) == (-(-H // km) * km, -(-W // km) * km)
    rows = [(k, t0, t1) for (k, _, _), ch in zip(plan.levels, plan.chunks)
            for (t0, t1) in ch]
    assert tab.chunks.shape == (len(rows), 8)
    bounds = tab.chunks[:, 5:].copy().view(np.float32)
    slot, cells = 0, 0
    for row, b, (k, t0, t1) in zip(tab.chunks, bounds, rows):
        hk, wk = tab.Hp // k, tab.Wp // k
        assert list(row[:4]) == [slot, k, hk, wk]
        assert row[4] == (tab.planes[k.bit_length() - 1] if k <= 32 else -1)
        assert b[0] == np.float32(t0) and b[1] == np.float32(t1)
        assert b[2] == np.float32(float(np.float32(t0))
                                  + float(np.float32(1e-6)))
        slot += hk * wk
    for i, off in enumerate(tab.planes):
        k = 1 << i
        if any(lk == k for lk, _, _ in plan.levels):
            assert off == cells
            cells += (tab.Hp // k) * (tab.Wp // k)
        else:
            assert off == -1
    assert tab.base_off == (cells if km > 32 else -1)
    assert tab.cells == cells + (
        (tab.Hp // 32) * (tab.Wp // 32) if km > 32 else 0)
    assert tab.total == slot
    union = tcarve.carve_jobs(torch.zeros(H, W), torch.zeros(
        H, W, dtype=torch.int32), torch.eye(4), intr, ct, plan)
    assert union.valid.shape == (slot,)
    if total is not None:
        assert slot == total


@pytest.mark.parametrize("density", ["octave", "matched"])
@pytest.mark.parametrize("source", ["frame", "random"])
def test_band_octave_keep_matches(frame, density, source):
    """floor(log2(T/d)) picks each pixel's level; the reference computes it
    through XLA's log, the port through torch's. At these inputs, random
    distances over every octave included, no kept pixel differs (allowed:
    0)."""
    cj, ct = (dataclasses.replace(c, tsdf=dataclasses.replace(
        c.tsdf, band_density=density)) for c in configs("projective"))
    intr = INTR
    if source == "frame":
        pts_C, valid = prepared(frame, cj)[0], prepared(frame, cj)[6]
    else:
        intr = PinholeIntrinsics(fx=320.0, fy=320.0, cx=319.5, cy=239.5,
                                 width=640, height=480)
        rng = np.random.RandomState(9)
        n = intr.width * intr.height
        dirs = rng.randn(n, 3)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        pts_C = (dirs * np.exp(rng.uniform(np.log(0.01), np.log(20.0), n))
                 [:, None]).astype(np.float32)
        valid = rng.rand(n) > 0.05
    tintr = kt.PinholeIntrinsics(**intr.__dict__)
    for salt in (0, 12345, -7):
        kj = jax.jit(functools.partial(jcarve.band_octave_keep, cfg=cj,
                                       intr=intr))(pts_C, valid,
                                                   salt=jnp.int32(salt))
        kt_ = tcarve.band_octave_keep(T(pts_C), T(valid), ct, tintr,
                                      salt=torch.tensor(salt,
                                                        dtype=torch.int32))
        assert int((N(kt_) != N(kj)).sum()) == 0
        assert 0 < N(kj).sum() < valid.sum()


@pytest.mark.parametrize("fill", [0.0, 0.5])
def test_start_voxel_dedup_matches(frame, fill):
    """Keep flags and the new set exactly; among rays contending for one
    bucket the same ray wins (the reference's last write)."""
    cj, _ = configs("full")
    pts_G, valid = prepared(frame, cj)[1], prepared(frame, cj)[6]
    pts_G = np.concatenate([pts_G, pts_G[::3]])       # more contention
    valid = np.concatenate([valid, valid[::3]])
    D = 1 << 10
    rng = np.random.RandomState(int(fill * 10))
    start_set = np.where(rng.rand(D) < fill,
                         rng.randint(-2 ** 31, 2 ** 31 - 1, D), -1
                         ).astype(np.int32)
    kw = dict(voxel_size_inv=1.0 / 0.2, subsampling_factor=2.0)
    kj, sj = jax.jit(functools.partial(jdedup.start_voxel_dedup, **kw))(
        start_set, pts_G, valid)
    kt_, st = tdedup.start_voxel_dedup(T(start_set), T(pts_G), T(valid),
                                       **kw)
    np.testing.assert_array_equal(N(kt_), N(kj))
    np.testing.assert_array_equal(N(st), N(sj))
    assert 0 < N(kj).sum() < valid.sum()
