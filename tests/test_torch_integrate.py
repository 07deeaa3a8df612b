"""The port's update-stream reduce (ops/reduce.py) against the JAX package,
and its ray-batch integrate (ops/integrate.py integrate_ray_batch) against
tests/oracle.py, the numpy reference of the C++ semantics (CPU)."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from kimera_semantics_tpu.ops import reduce as jreduce

from kimera_semantics_tpu_torch import config as tcfg
from kimera_semantics_tpu_torch.grid import blocks as tblocks
from kimera_semantics_tpu_torch.ops import integrate as tinteg
from kimera_semantics_tpu_torch.ops import reduce as treduce
from kimera_semantics_tpu_torch.ops import semantic as tsem

import oracle

TRASH = 0x7FFFFFFF


def N(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def T(x):
    return torch.from_numpy(np.array(x))


def stream(n, n_keys, seed, trash_frac=0.4):
    """A duplicate-heavy update stream: keys from a small set, trash
    entries with zero channel values."""
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, n_keys, n).astype(np.int32) * 37
    trash = rng.rand(n) < trash_frac
    keys[trash] = TRASH
    chans = tuple(np.where(trash, 0, rng.uniform(0, 3, n)).astype(np.float32)
                  for _ in range(2)) + (
        np.where(trash, 0, rng.randint(0, 2, n)).astype(np.float32),)
    return keys, chans


@pytest.mark.parametrize("n,n_keys,budget,frac", [
    (6000, 900, 4096, None),     # everything fits
    (6000, 900, 500, None),      # the budget cuts the ascending tail
    (6000, 900, 4096, 0.45),     # active_frac slices real entries off
    (800, 3000, 4096, None)])    # mostly unique keys
def test_segment_compact_reduce_matches(n, n_keys, budget, frac):
    keys, chans = stream(n, n_keys, seed=n_keys)
    kj, sj, dj = jax.jit(lambda k, c: jreduce.segment_compact_reduce(
        k, c, budget, max_run=n, active_frac=frac))(keys, chans)
    kt, st, dt = treduce.segment_compact_reduce(
        T(keys), tuple(T(c) for c in chans), budget, max_run=n,
        active_frac=frac)
    np.testing.assert_array_equal(N(kt), N(kj))
    assert int(dt) == int(dj)
    if budget < 4096 or frac:
        assert int(dt) > 0
    for a, b in zip(sj, st):
        np.testing.assert_allclose(N(b), N(a), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(N(st[2]), N(sj[2]))    # integral counts


@pytest.mark.parametrize("n", [1000, 600_000])
def test_stable_compact_order_matches(n):
    """Both of the reference's forms (packed key below 500k entries, a
    stable two-operand sort above)."""
    rng = np.random.RandomState(n % 97)
    mask = rng.rand(n) < 0.3
    for max_out in (n // 2, n // 10):
        kj, oj = jax.jit(lambda m: jreduce.stable_compact_order(m, max_out))(
            mask)
        kt, ot = treduce.stable_compact_order(T(mask), max_out)
        np.testing.assert_array_equal(N(kt), N(kj))
        np.testing.assert_array_equal(N(ot), N(oj))


def test_segmented_scan_sums_match():
    rng = np.random.RandomState(5)
    start = rng.rand(3000) < 0.1
    start[0] = True
    vals = (rng.uniform(-2, 2, 3000).astype(np.float32),)
    (a,) = jax.jit(lambda s, v: jreduce.segmented_scan_sums(s, v, 64))(start,
                                                                      vals)
    (b,) = treduce.segmented_scan_sums(T(start), (T(vals[0]),), 64)
    np.testing.assert_array_equal(N(b), N(a))


def test_add_sorted_runs_is_the_in_order_scatter():
    rng = np.random.RandomState(6)
    idx = np.sort(rng.randint(0, 50, 400)).astype(np.int64)
    vals = rng.uniform(-1, 1, (2, 400)).astype(np.float32)
    keep = rng.rand(400) < 0.8
    buf = torch.zeros((2, 60))
    treduce.add_sorted_runs(buf, T(idx), T(vals), T(keep))
    ref = np.zeros((2, 60), np.float32)
    for i in range(400):
        if keep[i]:
            ref[:, idx[i]] += vals[:, i]
    np.testing.assert_array_equal(N(buf), ref)


# ---------------------------------------------------------------------------
# integrate_ray_batch against the oracle (tests/test_integrate.py's cases)
# ---------------------------------------------------------------------------

def make_cfg(carving=True, const_weight=True, color=False, max_rays=64):
    return tcfg.FusionConfig(
        grid=tcfg.GridConfig(voxel_size=0.2, voxels_per_side=8,
                             block_capacity=256),
        tsdf=tcfg.TsdfConfig(truncation_distance=0.4, max_ray_length_m=5.0,
                             voxel_carving_enabled=carving,
                             use_const_weight=const_weight),
        semantic=tcfg.SemanticConfig(
            semantic_measurement_probability=0.9,
            color_mode=tcfg.ColorMode.COLOR if color
            else tcfg.ColorMode.SEMANTIC),
        # Dense vote staging: near the origin a voxel sees more distinct
        # labels than the packed staging's ranks hold.
        pipeline=tcfg.PipelineConfig(max_rays=max_rays,
                                     dedup_table_size=1 << 12, max_steps=128,
                                     sem_stage_mode="dense"))


def run_rays(cfg, origin, pts, labels, clearing, colors, weights, cube):
    n = len(pts)
    R = cfg.pipeline.max_rays
    pad = lambda a, dt: T(np.pad(np.asarray(a, dt),  # noqa: E731
                                 [(0, R - n)] + [(0, 0)] * (np.ndim(a) - 1)))
    valid = np.zeros(R, bool)
    valid[:n] = True
    origin = torch.tensor(origin, dtype=torch.float32)
    grid = tblocks.create(cfg, device="cpu")
    return tinteg.integrate_ray_batch(
        grid, cfg, origin, pad(pts, np.float32), pad(weights, np.float32),
        pad(colors, np.float32), pad(labels, np.int32),
        pad(clearing, bool), T(valid),
        cube_origin=origin if cube else None)


def oracle_run(cfg, origin, pts, labels, clearing, colors, weights):
    og = oracle.OracleGrid(cfg.grid.voxel_size, cfg.grid.num_labels)
    lk = tsem.make_likelihood(cfg.semantic)
    oracle.integrate_rays(
        og, origin, pts, weights, colors, labels, clearing,
        np.ones(len(pts), bool), truncation=cfg.tsdf.truncation_distance,
        max_ray_length=cfg.tsdf.max_ray_length_m,
        carving=cfg.tsdf.voxel_carving_enabled, log_match=lk.log_match,
        log_nonmatch=lk.log_nonmatch)
    idxs = np.array(list(og.voxels.keys()), dtype=np.int32)
    vs = list(og.voxels.values())
    return idxs, dict(distance=np.array([v.distance for v in vs]),
                      weight=np.array([v.weight for v in vs]),
                      color=np.stack([v.color for v in vs]),
                      label=np.array([v.label for v in vs]),
                      logodds=np.stack([v.logodds for v in vs]))


def grid_voxels(cfg, grid, idxs):
    block, lin = tblocks.voxel_to_block_local(T(idxs),
                                              cfg.grid.voxels_per_side)
    s = N(tblocks.lookup_slots(grid, block, cfg.grid))
    lin = N(lin)
    lk = tsem.make_likelihood(cfg.semantic)
    return dict(
        allocated=s < cfg.grid.block_capacity,
        distance=N(tblocks.tsdf_distance(
            grid, cfg.tsdf.truncation_distance))[s, lin],
        weight=N(grid.wsum)[s, lin],
        color=N(tblocks.voxel_color(grid))[:, s, lin].T,
        label=N(tblocks.mle_labels(grid))[s, lin],
        logodds=N(tblocks.label_logodds(grid, lk.log_match,
                                        lk.log_nonmatch))[:, s, lin].T)


@pytest.mark.parametrize("carving", [True, False])
@pytest.mark.parametrize("cube", [False, True])
def test_random_rays_match_oracle(carving, cube):
    """tests/test_integrate.py's random-ray case (COLOR mode, 1/z^2
    weights), through the hash-lookup resolve and through the frame cube
    (K6)."""
    cfg = make_cfg(carving=carving, const_weight=False, color=True)
    rng = np.random.RandomState(3)
    origin = np.array([0.1, 0.2, -0.1])
    n = 40
    pts_c = rng.uniform(0.5, 4.0, (n, 3)) * rng.choice([-1, 1], (n, 3))
    pts = origin + pts_c
    labels = rng.randint(0, 21, n)
    weights = 1.0 / np.maximum(np.abs(pts_c[:, 2]) ** 2, 1e-12)
    colors = rng.uniform(0, 255, (n, 3))
    clearing = np.zeros(n, bool)
    grid = run_rays(cfg, origin, pts, labels, clearing, colors, weights, cube)
    assert int(grid.overflow) == 0
    idxs, exp = oracle_run(cfg, origin, pts, labels, clearing, colors,
                           weights)
    got = grid_voxels(cfg, grid, idxs)
    assert got["allocated"].all()
    np.testing.assert_allclose(got["weight"], exp["weight"], rtol=3e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["distance"], exp["distance"], atol=2e-3)
    np.testing.assert_allclose(got["logodds"], exp["logodds"], atol=1e-3)
    heavy = exp["weight"] > 1e-3
    diff = np.abs(got["color"][heavy].astype(np.float64)
                  - exp["color"][heavy])
    assert (diff <= 2.0).mean() > 0.95, diff.max()
    top2 = np.sort(exp["logodds"], axis=-1)[:, -2:]
    tied = (top2[:, 1] - top2[:, 0]) < 1e-4
    assert ((got["label"] == exp["label"]) | tied).all()


@pytest.mark.parametrize("cube", [False, True])
def test_single_and_clearing_rays_match_oracle(cube):
    """A generic surface ray and a clearing ray. (tests/test_integrate.py's
    surface point (1.0, 0.3, 0.2) lies on a voxel corner, where the DDA's
    tie goes either way with the last bit of the step times: the port, like
    the jitted JAX function, steps through another voxel there than the
    float64 oracle.)"""
    cfg = make_cfg()
    for pts, labels, clearing in (([[1.03, 0.31, 0.23]], [5], [False]),
                                  ([[7.0, 0.0, 0.0]], [4], [True])):
        args = (np.zeros(3), np.array(pts), np.array(labels),
                np.array(clearing), np.full((1, 3), 100.0), np.ones(1))
        grid = run_rays(cfg, *args, cube)
        idxs, exp = oracle_run(cfg, *args)
        assert len(idxs) > 0
        got = grid_voxels(cfg, grid, idxs)
        assert got["allocated"].all()
        np.testing.assert_allclose(got["distance"], exp["distance"],
                                   atol=1e-4)
        np.testing.assert_allclose(got["weight"], exp["weight"], atol=1e-4)
        np.testing.assert_array_equal(got["label"], exp["label"])
        np.testing.assert_allclose(got["logodds"], exp["logodds"], atol=1e-4)


def test_not_yet_ported_options_raise():
    """Sharding and multi-frame anti-grazing wait for slice E; the plain
    scatter modes run (tests/test_torch_scatter_modes.py)."""
    cfg = make_cfg()
    args = (np.zeros(3), np.array([[1.0, 0.3, 0.2]]), np.array([5]),
            np.array([False]), np.full((1, 3), 100.0), np.ones(1), False)
    direct = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, scatter_mode="direct"))
    assert float(run_rays(direct, *args).wsum.sum()) > 0
    grid = tblocks.create(cfg, device="cpu")
    for kw in (dict(shard_id=torch.tensor(0), num_shards=2),
               dict(ag_frames=2)):
        with pytest.raises(NotImplementedError, match="slice E"):
            tinteg.integrate_jobs(grid, cfg, [], **kw)
