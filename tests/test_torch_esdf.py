"""The port's batch ESDF (kimera_semantics_tpu_torch/ops/esdf.py) and the
`.vxblx` ESDF layer (io/vxblx.py) against the JAX package (CPU): a JAX
grid carried across with interop.py, the neighbour tables, block
coordinates and observed flags exact, distances within 1e-5 m; the
brute-force Euclidean oracle of tests/test_esdf_blocked.py (under one
voxel of error outside the band); the golden bag's ESDF statistics against
the pins of tests/test_golden.py; and `tsdf_esdf.vxblx` bytes equal to the
JAX writer's, on 8^3 blocks and regrouped from 8^3 tiles into 16^3 blocks.

The distance tolerance: the two packages take the same jump-flood passes in
the same order, and differ only in how a float32 Euclidean norm rounds
(XLA may contract its sum of squares into fused multiply-adds), a few ulps
of distances of at most a few metres; a near-tie flipped by such an ulp
changes a distance by no more than that ulp.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kimera_semantics_tpu import config as jcfg
from kimera_semantics_tpu.core.camera import PinholeIntrinsics
from kimera_semantics_tpu.core.color import LabelColorMap
from kimera_semantics_tpu.grid import blocks as jblocks
from kimera_semantics_tpu.io import vxblx as jvxblx
from kimera_semantics_tpu.io.dataset import SyntheticDataset
from kimera_semantics_tpu.models import fast as jfast
from kimera_semantics_tpu.ops import esdf as jesdf

from kimera_semantics_tpu_torch import config as tcfg
from kimera_semantics_tpu_torch import interop
from kimera_semantics_tpu_torch.core.color import LabelColorMap as TLmap
from kimera_semantics_tpu_torch.grid import blocks as tblocks
from kimera_semantics_tpu_torch.io import vxblx as tvxblx
from kimera_semantics_tpu_torch.io.rosbag import RosbagDataset
from kimera_semantics_tpu_torch.models import fast as tfast
from kimera_semantics_tpu_torch.ops import esdf as tesdf

INTR = PinholeIntrinsics(fx=40.0, fy=40.0, cx=39.5, cy=29.5, width=80,
                         height=60)
DIST_ATOL = 1e-5


def cfg_pair(io_vps=0):
    """tests/test_esdf_blocked.py's configuration in both packages."""
    return [m.FusionConfig(
        grid=m.GridConfig(voxel_size=0.2, voxels_per_side=8,
                          block_capacity=512, io_voxels_per_side=io_vps),
        tsdf=m.TsdfConfig(truncation_distance=0.4, max_ray_length_m=4.0),
        pipeline=m.PipelineConfig(max_rays=2048, dedup_table_size=1 << 14,
                                  segment_budget=1 << 16, carve_budget=4096,
                                  carve_steps=16))
        for m in (jcfg, tcfg)]


@pytest.fixture(scope="module")
def grids():
    """A JAX grid of the multi-object eval world (4 fast frames) and the
    same grid carried into the port."""
    cj, ct = cfg_pair()
    ds = SyntheticDataset(num_frames=4, intr=INTR,
                          label_map=LabelColorMap.random(21))
    g = jblocks.create(cj)
    for i in range(4):
        g = jfast.integrate_frame(g, ds.frame(i), cj, INTR)
    arr = {f: np.asarray(getattr(g, f)) for f in tblocks.FIELDS}
    return g, interop.grid_from_numpy(arr, ct, device="cpu"), cj, ct


@pytest.fixture(scope="module")
def results(grids):
    g, tg, cj, ct = grids
    return (jesdf.compute_esdf_blocked(g, cj, max_dist=1.6),
            tesdf.compute_esdf_blocked(tg, ct, max_dist=1.6))


def test_neighbor_tables_and_steps_match():
    rng = np.random.RandomState(3)
    coords = np.unique(rng.randint(-6, 6, (300, 3)), axis=0).astype(np.int32)
    ks = [1, 2, 4]
    jt = jesdf.neighbor_tables(coords, ks, 512)
    tt = tesdf.neighbor_tables(coords, ks, 512)
    assert set(jt) == set(tt)
    for k in ks:
        np.testing.assert_array_equal(tt[k], jt[k])
    for vps, d in ((8, 8), (16, 80), (8, 13)):
        assert (tesdf._blocked_jfa_steps(vps, d)
                == jesdf._blocked_jfa_steps(vps, d))


def test_blocked_esdf_matches_jax(results):
    jr, tr = results
    np.testing.assert_array_equal(tr.block_coords, jr.block_coords)
    np.testing.assert_array_equal(tr.observed, jr.observed)
    assert tr.distance.dtype == np.float32 and tr.vps == jr.vps
    np.testing.assert_allclose(tr.distance, jr.distance, rtol=0,
                               atol=DIST_ATOL)
    assert tr.observed.sum() > 1000
    # The dense wrapper and the sampler agree too.
    jd, td = jr.to_dense(), tr.to_dense()
    np.testing.assert_array_equal(td.origin_voxel, jd.origin_voxel)
    np.testing.assert_array_equal(td.observed, jd.observed)
    pts = np.argwhere(jd.observed)[:500] + jd.origin_voxel
    np.testing.assert_allclose(tr.sample(pts), jr.sample(pts), atol=DIST_ATOL)


def test_blocked_matches_brute_force_euclidean(grids, results):
    """The port's ESDF against the exact nearest-seed Euclidean distance:
    under one voxel of error outside the truncation band (the bound of
    tests/test_esdf_blocked.py)."""
    _, tg, _, ct = grids
    _, res = results
    nb = res.block_coords.shape[0]
    vps, v = res.vps, ct.grid.voxel_size
    trunc = ct.tsdf.truncation_distance
    tsdf = tblocks.tsdf_distance(tg, trunc)[:nb].numpy()
    wsum = tg.wsum[:nb].numpy()
    li = np.arange(vps, dtype=np.float32) + 0.5
    local = np.stack(np.meshgrid(li, li, li, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    centers = ((res.block_coords[:, None, :] * vps + local[None]) * v
               ).astype(np.float32)
    observed = wsum > 1e-6
    near = observed & (np.abs(tsdf) < trunc * 0.99)
    seeds, resid = centers[near], np.abs(tsdf[near])
    rng = np.random.RandomState(0)
    cand = np.argwhere(observed & ~near)
    sel = cand[rng.choice(len(cand), size=min(600, len(cand)),
                          replace=False)]
    pts = centers[sel[:, 0], sel[:, 1]]
    brute = np.empty(len(pts), np.float32)
    for i in range(0, len(pts), 128):
        d = np.linalg.norm(pts[i:i + 128, None, :] - seeds[None], axis=-1)
        brute[i:i + 128] = (d + resid[None]).min(axis=1)
    brute = np.clip(brute, 0.0, 1.6)
    err = np.abs(np.abs(res.distance[sel[:, 0], sel[:, 1]]) - brute)
    assert float(err.max()) < v
    # Near-surface voxels carry the TSDF itself.
    np.testing.assert_array_equal(res.distance[near], tsdf[near])


def test_empty_grid():
    _, ct = cfg_pair()
    res = tesdf.compute_esdf_blocked(tblocks.create(ct, device="cpu"), ct)
    assert res.block_coords.shape == (0, 3) and res.distance.shape == (0,
                                                                       512)
    assert tesdf.compute_esdf(tblocks.create(ct, device="cpu"),
                              ct).distance.size == 0


def test_golden_bag_esdf_statistics():
    """The batch-ESDF tail on the golden bag (its 12 frames through the
    port's fast integrator at the golden "default" configuration) against
    the pinned statistics of tests/test_golden.py:162-176, with their
    tolerances."""
    cfg = tcfg.FusionConfig(
        grid=tcfg.GridConfig(voxel_size=0.1, voxels_per_side=8,
                             block_capacity=1024),
        tsdf=tcfg.TsdfConfig(truncation_distance=0.2, max_ray_length_m=5.0),
        semantic=tcfg.SemanticConfig(semantic_measurement_probability=0.8),
        pipeline=tcfg.PipelineConfig(max_rays=12288,
                                     dedup_table_size=1 << 16,
                                     segment_budget=1 << 17,
                                     carve_budget=16384, carve_steps=24,
                                     block_budget=512))
    ds = RosbagDataset("tests/fixtures/golden_scene.bag",
                       label_map=TLmap.random(21, seed=0),
                       depth_topic="/depth/image_raw",
                       semantic_topic="/semantic/image_raw",
                       cam_info_topic="/depth/camera_info", device="cpu")
    g = tblocks.create(cfg, device="cpu")
    for i in range(len(ds)):
        tfast.integrate_frame(g, ds.frame(i), cfg, ds.intr, device="cpu")
    assert int(g.overflow) == 0
    res = tesdf.compute_esdf(g, cfg, max_dist=2.0)
    vals = res.distance[res.observed]
    assert vals.size > 10000
    stats = (float(vals.mean()), float(np.abs(vals).mean()),
             float((vals < 0).mean()))
    exp = (0.5808, 0.6058, 0.1137)
    assert stats[0] == pytest.approx(exp[0], abs=0.05)
    assert stats[1] == pytest.approx(exp[1], rel=0.15)
    assert stats[2] == pytest.approx(exp[2], abs=0.05)


@pytest.mark.parametrize("io_vps", [0, 16])
def test_tsdf_esdf_vxblx_bytes_match(grids, tmp_path, io_vps):
    """save_vxblx(esdf=) writes the JAX writer's bytes: the TSDF layer, then
    the ESDF layer, on 8^3 blocks or regrouped into 16^3 IO blocks; both
    layers read back."""
    g, tg, _, _ = grids
    cj, ct = cfg_pair(io_vps)
    jr = jesdf.compute_esdf_blocked(g, cj, max_dist=1.6)
    tr = tesdf.compute_esdf_blocked(tg, ct, max_dist=1.6)
    # One ESDF for both writers: the test is of the bytes, not the ulps.
    tr = dataclasses.replace(tr, distance=jr.distance)
    pj, pt = str(tmp_path / "j.vxblx"), str(tmp_path / "t.vxblx")
    jvxblx.save_vxblx(pj, g, cj, esdf=jr)
    tvxblx.save_vxblx(pt, tg, ct, esdf=tr)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    secs = tvxblx.read_sections(pt)
    assert [s.type for s in secs] == ["tsdf", "esdf"]
    assert secs[1].voxels_per_side == (io_vps or 8)
    words = secs[1].voxel_data.reshape(len(secs[1].block_origins), -1, 2)
    ref = tvxblx.esdf_to_section(tr, ct)
    np.testing.assert_array_equal(words.reshape(ref.voxel_data.shape),
                                  ref.voxel_data)
    back = tvxblx.load_vxblx(pt, ct, device="cpu")
    assert int(back.n_blocks) > 0
    # The dense result writes the same layer as the blocked one where
    # they cover the same blocks.
    dense = tvxblx.esdf_to_section(tr.to_dense(), ct)
    assert dense.type == "esdf" and len(dense.block_origins) == len(
        ref.block_origins)
