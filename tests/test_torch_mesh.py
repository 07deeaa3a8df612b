"""The port's marching cubes (kimera_semantics_tpu_torch/ops/mesh.py) against
the JAX package's, on the same grid: a JAX grid after three projective
frames is carried into the port slot for slot (interop.grid_from_numpy),
and both packages mesh it (CPU).

Tolerances: triangle counts, triangle rows and colours exact; vertices
within 1e-6 m absolute (0.1 m voxels); normals within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kimera_semantics_tpu import config as jcfg
from kimera_semantics_tpu.core.camera import PinholeIntrinsics
from kimera_semantics_tpu.core.color import LabelColorMap as JLabelColorMap
from kimera_semantics_tpu.grid import blocks as jblocks
from kimera_semantics_tpu.io.dataset import SyntheticDataset
from kimera_semantics_tpu.models import projective as jproj_model
from kimera_semantics_tpu.ops import mesh as jmesh

from kimera_semantics_tpu_torch import config as tcfg
from kimera_semantics_tpu_torch import interop
from kimera_semantics_tpu_torch.core.color import LabelColorMap
from kimera_semantics_tpu_torch.grid import blocks as tblocks
from kimera_semantics_tpu_torch.ops import mesh as tmesh

INTR = PinholeIntrinsics(fx=90.0, fy=90.0, cx=59.5, cy=44.5, width=120,
                         height=90)
VERT_ATOL = 1e-6
NORMAL_ATOL = 1e-5
MODES = ("color", "semantic", "semantic_probability")


def configs(mode="semantic"):
    return [m.FusionConfig(
        grid=m.GridConfig(voxel_size=0.1, voxels_per_side=8,
                          block_capacity=1024),
        tsdf=m.TsdfConfig(truncation_distance=0.3, max_ray_length_m=6.0),
        semantic=m.SemanticConfig(semantic_measurement_probability=0.8,
                                  color_mode=m.ColorMode(mode)),
        pipeline=m.PipelineConfig(block_budget=512, alloc_stride=2))
        for m in (jcfg, tcfg)]


@pytest.fixture(scope="module")
def arrays():
    """Grid arrays after three COLOR-mode projective frames (the colour
    and the semantic channels both accumulate), with the semantic votes of
    every third allocated block cleared (observed voxels whose log-odds are
    all zero: argmax ties) and garbage in the trash tile."""
    cj, _ = configs("color")
    ds = SyntheticDataset(num_frames=8, intr=INTR,
                          label_map=JLabelColorMap.random())
    g = jblocks.create(cj)
    for i in range(3):
        g = jproj_model.integrate_frame(g, ds.frame(i), cj, INTR)
    out = {n: np.array(getattr(g, n)) for n in tblocks.FIELDS}
    nb = int(out["n_blocks"])
    assert nb > 40
    out["sem_delta"][:, 0:nb:3] = 0.0
    out["sem_count"][0:nb:3] = 0.0
    cap = cj.grid.block_capacity
    rng = np.random.RandomState(0)
    for name in ("wsum", "wsdf", "sem_count"):
        out[name][cap:] = rng.uniform(-5, 5, out[name][cap:].shape)
    out["updated"][:] = False
    out["updated"][1:nb:4] = True
    return out


def grids(arrays, mode):
    cj, ct = configs(mode)
    g = jblocks.VoxelGrid(**{n: np.asarray(a) for n, a in arrays.items()})
    return cj, ct, g, interop.grid_from_numpy(arrays, ct, device="cpu")


def check_same(a, b):
    assert a.num_triangles == b.num_triangles > 0
    np.testing.assert_allclose(b.vertices, a.vertices, rtol=0,
                               atol=VERT_ATOL)
    np.testing.assert_array_equal(b.colors, a.colors)
    np.testing.assert_array_equal(b.triangles, a.triangles)
    assert (a.normals is None) == (b.normals is None)
    if a.normals is not None:
        np.testing.assert_allclose(b.normals, a.normals, rtol=0,
                                   atol=NORMAL_ATOL)


LMAP = (JLabelColorMap.random(), LabelColorMap.random())


@pytest.mark.parametrize("mode,normals", [
    ("color", True), ("semantic", False), ("semantic_probability", False)])
def test_extract_mesh_matches_jax(arrays, mode, normals):
    cj, ct, g, tg = grids(arrays, mode)
    a = jmesh.extract_mesh(g, cj, LMAP[0], with_normals=normals)
    b = tmesh.extract_mesh(tg, ct, LMAP[1], with_normals=normals)
    check_same(a, b)
    if mode == "semantic":      # the cleared blocks mesh in label 0's colour
        white = (b.colors == np.array(LMAP[1].label_colors[0])).all(axis=1)
        assert white.any() and not white.all()


def test_incremental_blocks_match_jax(arrays):
    """only_updated with return_blocks: the same meshed rows and the same
    row per triangle; the complete per-batch path gives the same mesh."""
    cj, ct, g, tg = grids(arrays, "semantic")
    a, rows_a, tri_a = jmesh.extract_mesh(g, cj, LMAP[0], only_updated=True,
                                          return_blocks=True)
    b, rows_b, tri_b = tmesh.extract_mesh(tg, ct, LMAP[1], only_updated=True,
                                          return_blocks=True)
    check_same(a, b)
    np.testing.assert_array_equal(rows_b, rows_a)
    np.testing.assert_array_equal(tri_b, tri_a)
    assert set(tri_b.tolist()) <= set(rows_b.tolist())
    c, rows_c, tri_c = tmesh.extract_mesh(tg, ct, LMAP[1], only_updated=True,
                                          return_blocks=True, batch=5)
    check_same(a, c)
    np.testing.assert_array_equal(rows_c, rows_a)
    np.testing.assert_array_equal(tri_c, tri_a)


def test_connect_mesh_matches_jax(arrays):
    cj, ct, g, tg = grids(arrays, "semantic")
    a = jmesh.connect_mesh(jmesh.extract_mesh(g, cj, LMAP[0]), 0.1)
    b = tmesh.connect_mesh(tmesh.extract_mesh(tg, ct, LMAP[1]), 0.1)
    assert len(b.vertices) < 3 * b.num_triangles
    check_same(a, b)


def test_cycle_async_collect_contract(arrays):
    """The async cycle: collect() returns the synchronous mesh; the hint
    smaller than the mesh still gives every triangle; total_rows is the
    triangle count; a page smaller than the selection is incomplete with
    hold_grid=False (None) and paged with hold_grid=True."""
    _, ct, _, tg = grids(arrays, "semantic")
    ref, rows, tri = tmesh.extract_mesh(tg, ct, LMAP[1], return_blocks=True,
                                        batch=64)
    collect = tmesh.extract_mesh_cycle_async(
        tg, ct, LMAP[1], return_blocks=True, hint_rows=1, hold_grid=False)
    m, rows_m, tri_m = collect()
    check_same(ref, m)
    np.testing.assert_array_equal(rows_m, rows)
    np.testing.assert_array_equal(tri_m, tri)
    assert collect.total_rows == ref.num_triangles
    small = dict(return_blocks=True, page_blocks=8)
    assert tmesh.extract_mesh_cycle_async(tg, ct, LMAP[1], hold_grid=False,
                                          **small)() is None
    m, rows_m, tri_m = tmesh.extract_mesh_cycle_async(
        tg, ct, LMAP[1], hold_grid=True, **small)()
    check_same(ref, m)
    np.testing.assert_array_equal(rows_m, rows)


def test_empty_grid_and_trash_rows():
    """An empty grid meshes to nothing; a grid whose only state is in the
    trash tile too."""
    _, ct = configs()
    tg = tblocks.create(ct, device="cpu")
    tg.wsum[ct.grid.block_capacity:] = 1.0
    tg.wsdf[ct.grid.block_capacity:] = -0.1
    for fn in (tmesh.extract_mesh, tmesh.extract_mesh_cycle):
        m = fn(tg, ct, LMAP[1], with_normals=True)
        assert m.num_triangles == 0 and m.vertices.shape == (0, 3)
        assert m.normals.shape == (0, 3)
    m, rows, tri = tmesh.extract_mesh(tg, ct, LMAP[1], return_blocks=True)
    assert len(rows) == len(tri) == 0


def test_render_colors_match_jax(arrays):
    for mode in MODES:
        cj, ct, g, tg = grids(arrays, mode)
        a = np.asarray(jmesh.render_colors(g, cj, LMAP[0]))
        b = tmesh.render_colors(tg, ct, LMAP[1]).numpy()
        cap = cj.grid.block_capacity
        np.testing.assert_array_equal(b[:, :cap], a[:, :cap], err_msg=mode)


def test_semantic_needs_a_label_map(arrays):
    _, ct, _, tg = grids(arrays, "semantic")
    with pytest.raises(ValueError, match="LabelColorMap"):
        tmesh.extract_mesh(tg, ct, None)
    cfg = dataclasses.replace(ct, semantic=dataclasses.replace(
        ct.semantic, color_mode=tcfg.ColorMode.COLOR))
    assert tmesh.extract_mesh(tg, cfg, None).num_triangles > 0
