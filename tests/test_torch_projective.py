"""The port's projective main path as a whole against the JAX package:
three frames integrated by both, compared block by block; a grid carried
across mid-sequence and compared slot for slot; the unfused route (K4 + K5)
against the JAX package's kernel route, at 32^3 literal storage, at an
odd vps, and against the fused route bit for bit; the port's import hygiene and device
rules (CPU)."""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from kimera_semantics_tpu import config as jcfg
from kimera_semantics_tpu.core.camera import PinholeIntrinsics
from kimera_semantics_tpu.core.color import LabelColorMap
from kimera_semantics_tpu.grid import blocks as jblocks
from kimera_semantics_tpu.io.dataset import SyntheticDataset
from kimera_semantics_tpu.models import projective as jproj_model

import kimera_semantics_tpu_torch as kt
from kimera_semantics_tpu_torch import config as tcfg
from kimera_semantics_tpu_torch import interop
from kimera_semantics_tpu_torch.grid import blocks as tblocks
from kimera_semantics_tpu_torch.models import common as tcommon
from kimera_semantics_tpu_torch.models import projective as tproj_model

INTR = PinholeIntrinsics(fx=60.0, fy=60.0, cx=39.5, cy=29.5, width=80,
                         height=60)
TINTR = kt.PinholeIntrinsics(**INTR.__dict__)


def configs(voxel_size=0.25, capacity=768, budget=256, **pipeline):
    return [m.FusionConfig(
        grid=m.GridConfig(voxel_size=voxel_size, voxels_per_side=8,
                          block_capacity=capacity),
        tsdf=m.TsdfConfig(truncation_distance=0.5, max_ray_length_m=8.0),
        semantic=m.SemanticConfig(semantic_measurement_probability=0.8),
        pipeline=m.PipelineConfig(**{**dict(block_budget=budget,
                                             alloc_stride=4), **pipeline}))
        for m in (jcfg, tcfg)]


def N(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def frames(n=3, intr=INTR):
    ds = SyntheticDataset(num_frames=6, intr=intr,
                          label_map=LabelColorMap.random())
    return [ds.frame(i) for i in range(n)]


def to_port(f):
    return tcommon.frame_from_images(
        np.asarray(f.depth), labels=np.asarray(f.labels),
        colors=np.asarray(f.colors), T_G_C=np.asarray(f.T_G_C), device="cpu")


CHANNELS = ("wsum", "wsdf", "sem_count", "sem_delta", "wcolor")


def rows(grid, name, slots):
    a = N(getattr(grid, name))
    return a[:, slots] if a.ndim == 3 else a[slots]


@pytest.mark.parametrize("width,voxel_size,capacity,budget",
                         [(80, 0.25, 768, 256), (320, 0.1, 4096, 1024)])
def test_three_frames_match_jax(width, voxel_size, capacity, budget):
    """At 80x60 with 0.25 m voxels, and at 320x240 (three mip levels) with
    0.1 m voxels, where float32 products with the voxel size round."""
    intr = PinholeIntrinsics(fx=0.75 * width, fy=0.75 * width,
                             cx=width / 2 - 0.5, cy=0.375 * width - 0.5,
                             width=width, height=width * 3 // 4)
    cj, ct = configs(voxel_size, capacity, budget)
    fs = frames(3, intr)
    g = jblocks.create(cj)
    tg = tblocks.create(ct, device="cpu")
    for f in fs:
        g = jproj_model.integrate_frame(g, f, cj, intr)
        tg = tproj_model.integrate_frame(
            tg, to_port(f), ct, kt.PinholeIntrinsics(**intr.__dict__),
            device="cpu")
        assert int(tg.overflow) == int(g.overflow) == 0
        assert int(tg.n_blocks) == int(g.n_blocks) > 0
    nb = int(g.n_blocks)
    coords = N(g.block_coords)[:nb]
    assert set(map(tuple, N(tg.block_coords)[:nb])) == set(map(tuple, coords))
    sj = np.arange(nb)
    st = N(tblocks.lookup_slots(tg, torch.tensor(coords), ct.grid))
    assert (st < ct.grid.block_capacity).all()
    for name in ("wsum", "wsdf"):
        np.testing.assert_allclose(rows(tg, name, st), rows(g, name, sj),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(rows(tg, "sem_count", st),
                                  rows(g, "sem_count", sj))
    np.testing.assert_allclose(rows(tg, "sem_delta", st),
                               rows(g, "sem_delta", sj), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(rows(tg, "wcolor", st),
                                  rows(g, "wcolor", sj))
    seen = rows(g, "wsum", sj) > 0
    assert seen.sum() > 500
    np.testing.assert_array_equal(N(tblocks.mle_labels(tg))[st][seen],
                                  N(jblocks.mle_labels(g))[sj][seen])
    np.testing.assert_array_equal(N(tg.updated)[st], N(g.updated)[sj])
    assert not N(tg.updated)[ct.grid.block_capacity:].any()


@pytest.mark.parametrize("stride", [4, 3])
def test_allocate_from_depth_matches_jax(stride):
    """The raw-image allocation (every stride-th pixel, exact 1/stride
    intrinsics, a stride that does not divide the image included) over two
    frames: the tables and the frame list equal the JAX package's, array
    for array."""
    cj, ct = configs(alloc_stride=stride)
    g = jblocks.create(cj)
    tg = tblocks.create(ct, device="cpu")
    for f in frames(2):
        tf = to_port(f)
        g, *lj = jproj_model.allocate_from_depth(g, f.depth, f.labels,
                                                 f.T_G_C, cj, INTR)
        tg, *lt = tproj_model.allocate_from_depth(tg, tf.depth, tf.labels,
                                                  tf.T_G_C, ct, TINTR)
        for name in ("table_keys", "table_slots", "block_coords",
                     "n_blocks", "overflow"):
            np.testing.assert_array_equal(N(getattr(tg, name)),
                                          N(getattr(g, name)), err_msg=name)
        for a, b in zip(lt, lj):
            np.testing.assert_array_equal(N(a), N(b))
    assert int(g.n_blocks) > 20


def test_carried_grid_matches_slot_for_slot():
    """A JAX grid after two frames crosses into the port; one more frame in
    both packages then agrees slot for slot."""
    cj, ct = configs()
    fs = frames(3)
    g = jblocks.create(cj)
    for f in fs[:2]:
        g = jproj_model.integrate_frame(g, f, cj, INTR)
    tg = interop.grid_from_numpy(
        {n: np.asarray(getattr(g, n)) for n in tblocks.FIELDS}, ct,
        device="cpu")
    g = jproj_model.integrate_frame(g, fs[2], cj, INTR)
    tg = tproj_model.integrate_frame(tg, to_port(fs[2]), ct, TINTR,
                                     device="cpu")
    out = interop.grid_to_numpy(tg)
    for name in ("table_keys", "table_slots", "block_coords", "n_blocks",
                 "overflow", "updated", "sem_count"):
        np.testing.assert_array_equal(out[name], np.asarray(getattr(g, name)),
                                      err_msg=name)
    for name in ("wsum", "wsdf", "sem_delta", "wcolor"):
        np.testing.assert_allclose(out[name], np.asarray(getattr(g, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_integrate_frames_is_sequential():
    _, ct = configs()
    fs = [to_port(f) for f in frames(2)]
    a = tblocks.create(ct, device="cpu")
    for f in fs:
        a = tproj_model.integrate_frame(a, f, ct, TINTR, device="cpu")
    batched = tcommon.Frame(*(torch.stack([getattr(f, n) for f in fs])
                              for n in ("depth", "labels", "colors", "T_G_C")))
    b = tproj_model.integrate_frames(tblocks.create(ct, device="cpu"),
                                     batched, ct, TINTR, device="cpu")
    integ = tproj_model.ProjectiveSemanticTsdfIntegrator(ct, TINTR, "cpu")
    c = tblocks.create(ct, device="cpu")
    for f in fs:
        c = integ.integrate(c, f)
    for name in CHANNELS + ("table_keys", "n_blocks"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
        assert torch.equal(getattr(a, name), getattr(c, name)), name


def run_jax_kernel_route(cfg, fs, intr=INTR):
    """Frames through the JAX integrator on its kernel route (Pallas
    interpreted)."""
    jproj_model.FORCE_PALLAS_INTERPRET = True
    try:
        jproj_model.integrate_frame.clear_cache()
        g = jblocks.create(cfg)
        for f in fs:
            g = jproj_model.integrate_frame(g, f, cfg, intr)
        return g
    finally:
        jproj_model.FORCE_PALLAS_INTERPRET = False
        jproj_model.integrate_frame.clear_cache()


def by_coords(g, tg, ct):
    """The JAX grid's allocated slots and the port's slots of the same
    block coordinates (the block sets must agree)."""
    nb = int(g.n_blocks)
    assert int(tg.n_blocks) == nb > 0
    coords = N(g.block_coords)[:nb]
    st = N(tblocks.lookup_slots(tg, torch.tensor(coords), ct.grid))
    assert (st < ct.grid.block_capacity).all()
    return np.arange(nb), st


def test_unfused_matches_jax_kernel_route():
    """fused_apply=False: the port's K4 + K5 route against the JAX
    package's projective_sample_update + block_rmw_add, both Pallas
    kernels interpreted. Allocation, counters and updated flags agree
    exactly; the Pallas sampler reads depth through a bf16 hi/lo split
    (|err| < depth * 2^-18), so band-edge voxels may flip: channel values
    differ by more than 1e-3 + 1e-3 |ref| on fewer than 0.5% of voxels."""
    cj, ct = configs(fused_apply=False)
    fs = frames(2)
    g = run_jax_kernel_route(cj, fs)
    tg = tblocks.create(ct, device="cpu")
    for f in fs:
        tg = tproj_model.integrate_frame(tg, to_port(f), ct, TINTR,
                                         device="cpu")
    assert int(tg.overflow) == int(g.overflow) == 0
    sj, st = by_coords(g, tg, ct)
    for name in CHANNELS:
        a, b = rows(g, name, sj), rows(tg, name, st)
        bad = np.abs(b - a) > 1e-3 + 1e-3 * np.abs(a)
        assert bad.mean() < 5e-3, (name, bad.mean())
    assert (rows(tg, "wsum", st) > 0).sum() > 300
    np.testing.assert_array_equal(N(tg.updated)[st], N(g.updated)[sj])


def test_literal_vps32_matches_jax():
    """32^3 blocks stored literally (V3 = 32768 > the fused kernel's
    8192) take K4 + K5 in the port; against the JAX package's XLA route
    over two frames, by block coordinate, at the tolerances of
    test_three_frames_match_jax."""
    cj, ct = [dataclasses.replace(c, grid=dataclasses.replace(
        c.grid, voxels_per_side=32)) for c in configs(0.1, 64, 64)]
    assert ct.grid.vps3 > tproj_model.FUSED_MAX_V3
    fs = frames(2)
    g = jblocks.create(cj)
    tg = tblocks.create(ct, device="cpu")
    for f in fs:
        g = jproj_model.integrate_frame(g, f, cj, INTR)
        tg = tproj_model.integrate_frame(tg, to_port(f), ct, TINTR,
                                         device="cpu")
    assert int(tg.overflow) == int(g.overflow) == 0
    sj, st = by_coords(g, tg, ct)
    for name in ("wsum", "wsdf"):
        np.testing.assert_allclose(rows(tg, name, st), rows(g, name, sj),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(rows(tg, "sem_count", st),
                                  rows(g, "sem_count", sj))
    np.testing.assert_allclose(rows(tg, "sem_delta", st),
                               rows(g, "sem_delta", sj), rtol=0, atol=1e-6)
    assert (rows(g, "wsum", sj) > 0).sum() > 500


def test_unfused_odd_vps_matches_jax():
    """vps 5 (V3 125, not a multiple of 8) with fused_apply=False: the
    port's K4 + K5 route (K5's generic instance on the card) against the
    JAX package, which routes such V3 to XLA, over two frames, by block
    coordinate, at the tolerances of test_three_frames_match_jax."""
    cj, ct = [dataclasses.replace(c, grid=dataclasses.replace(
        c.grid, voxels_per_side=5)) for c in configs(fused_apply=False)]
    assert ct.grid.vps3 % 8
    fs = frames(2)
    g = jblocks.create(cj)
    tg = tblocks.create(ct, device="cpu")
    for f in fs:
        g = jproj_model.integrate_frame(g, f, cj, INTR)
        tg = tproj_model.integrate_frame(tg, to_port(f), ct, TINTR,
                                         device="cpu")
    assert int(tg.overflow) == int(g.overflow) == 0
    sj, st = by_coords(g, tg, ct)
    for name in ("wsum", "wsdf"):
        np.testing.assert_allclose(rows(tg, name, st), rows(g, name, sj),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(rows(tg, "sem_count", st),
                                  rows(g, "sem_count", sj))
    np.testing.assert_allclose(rows(tg, "sem_delta", st),
                               rows(g, "sem_delta", sj), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(N(tg.updated)[st], N(g.updated)[sj])
    assert (rows(g, "wsum", sj) > 0).sum() > 300


@pytest.mark.parametrize("color", [False, True])
def test_fused_equals_unfused_bit_for_bit(color):
    """The fused (K3) and unfused (K4 + K5) routes add the same float terms
    once per voxel, so three frames leave identical grids."""
    _, ct = configs()
    if color:
        ct = dataclasses.replace(ct, semantic=dataclasses.replace(
            ct.semantic, color_mode=tcfg.ColorMode.COLOR))
    cu = dataclasses.replace(ct, pipeline=dataclasses.replace(
        ct.pipeline, fused_apply=False))
    fs = [to_port(f) for f in frames(3)]
    grids = []
    for cfg in (ct, cu):
        tg = tblocks.create(cfg, device="cpu")
        for f in fs:
            tg = tproj_model.integrate_frame(tg, f, cfg, TINTR, device="cpu")
        grids.append(tg)
    for name in tblocks.FIELDS:
        assert torch.equal(getattr(grids[0], name),
                           getattr(grids[1], name)), name
    assert bool((grids[0].wsum > 0).any())


def test_default_device_is_the_card():
    """Without `device`, entry points ask for CUDA: they raise on a machine
    without a card rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, ct = configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tblocks.create(ct)
    grid = tblocks.create(ct, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tproj_model.integrate_frame(grid, to_port(frames(1)[0]), ct, TINTR)


def test_port_imports_no_jax():
    """Importing every module of the port leaves no JAX and nothing of the
    JAX package in sys.modules (checked in a fresh interpreter)."""
    code = r"""
import importlib, json, pkgutil, sys
before = set(sys.modules)
import kimera_semantics_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in set(sys.modules) - before
             if m in ("jax", "jaxlib", "kimera_semantics_tpu")
             or m.startswith(("jax.", "jaxlib.", "kimera_semantics_tpu.")))
print(json.dumps({"modules": names, "bad": bad}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(__import__("pathlib").Path(__file__)
                                 .resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert "kimera_semantics_tpu_torch.ops.kernels" in res["modules"]
    assert len(res["modules"]) >= 15
