"""The port's block hash table and voxel grid against the JAX package: the
frame-list insert, its group-aligned layout, lookup, and the grid readouts
of a grid carried across from JAX (CPU)."""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kimera_semantics_tpu import config as jcfg
from kimera_semantics_tpu.core.camera import PinholeIntrinsics
from kimera_semantics_tpu.core.color import LabelColorMap
from kimera_semantics_tpu.grid import blocks as jblocks
from kimera_semantics_tpu.grid import hash as jhash
from kimera_semantics_tpu.io.dataset import SyntheticDataset
from kimera_semantics_tpu.models import projective as jproj_model

from kimera_semantics_tpu_torch import config as tcfg
from kimera_semantics_tpu_torch import interop
from kimera_semantics_tpu_torch.core import camera as tcam
from kimera_semantics_tpu_torch.grid import blocks as tblocks
from kimera_semantics_tpu_torch.grid import hash as thash
from kimera_semantics_tpu_torch.models import common as tcommon
from kimera_semantics_tpu_torch.models import projective as tproj_model

INTR = PinholeIntrinsics(fx=60.0, fy=60.0, cx=39.5, cy=29.5, width=80,
                         height=60)
TINTR = tcam.PinholeIntrinsics(**INTR.__dict__)


def configs(capacity=768, budget=256):
    return [m.FusionConfig(
        grid=m.GridConfig(voxel_size=0.25, voxels_per_side=8,
                          block_capacity=capacity),
        tsdf=m.TsdfConfig(truncation_distance=0.5, max_ray_length_m=8.0),
        semantic=m.SemanticConfig(semantic_measurement_probability=0.8),
        pipeline=m.PipelineConfig(block_budget=budget, alloc_stride=4))
        for m in (jcfg, tcfg)]


def N(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def T(x):
    return torch.from_numpy(np.array(x))


def random_keys(rng, n, extent, spread=6):
    coords = rng.randint(-spread, spread, (n, 3)).astype(np.int32)
    keys = N(jhash.pack_block_coords(jnp.asarray(coords), extent))
    active = rng.rand(n) > 0.2
    return keys, active


def check_group_aligned(fs, real, fcoords, n_blocks, block_coords, cap,
                        budget):
    """The frame list contract of grid/hash.py insert_frame_list."""
    assert np.array_equal(fs % 8, np.arange(budget) % 8)
    tile_groups = fs[::8] // 8
    real_tiles = tile_groups < cap // 8
    assert not np.any(np.diff(real_tiles.astype(int)) > 0)
    rg = tile_groups[real_tiles]
    assert np.all(np.diff(rg) > 0)            # distinct, ascending
    assert np.all(tile_groups[~real_tiles] == cap // 8)
    assert np.unique(fs[real]).size == real.sum()
    assert np.all(fs[real] < cap)
    np.testing.assert_array_equal(block_coords[fs[real]], fcoords[real])
    assert real.sum() <= n_blocks


@pytest.mark.parametrize("capacity,budget,n", [(768, 256, 1500),
                                               (64, 128, 1500)])
def test_insert_frame_list_matches(capacity, budget, n):
    """The same tables (keys, slots, block coordinates), n_blocks, overflow
    and frame list as the JAX insert, array for array, over two successive
    frames (the second re-touches some blocks); the second case overflows
    both the budget and the capacity."""
    cj, ct = configs(capacity, budget)
    g = cj.grid
    rng = np.random.RandomState(0)
    jstate = (jnp.full((g.table_size,), -1, jnp.int32),
              jnp.full((g.table_size,), -1, jnp.int32),
              jnp.zeros((capacity, 3), jnp.int32), jnp.int32(0))
    tstate = (torch.full((g.table_size,), -1, dtype=torch.int32),
              torch.full((g.table_size,), -1, dtype=torch.int32),
              torch.zeros((capacity, 3), dtype=torch.int32),
              torch.zeros((), dtype=torch.int32))
    args = (g.table_size, capacity, g.world_extent_blocks, budget)
    for frame in range(2):
        keys, active = random_keys(rng, n, g.world_extent_blocks)
        rj = jhash.insert_frame_list(*jstate, jnp.asarray(keys),
                                     jnp.asarray(active), *args)
        rt = thash.insert_frame_list(*tstate, T(keys), T(active), *args)
        jstate, tstate = rj[:4], rt[:4]
        nb = int(rj[3])
        assert int(rt[3]) == nb and int(rt[4]) == int(rj[4])
        # the largest batch index wins a contested position in both
        # packages, so the tables and the list agree entry for entry
        for i in (0, 1, 2, 5, 6, 7):
            np.testing.assert_array_equal(N(rt[i]), N(rj[i]),
                                          err_msg=f"output {i}")
        ft, realt = N(rt[6]), N(rt[7])
        check_group_aligned(ft, realt, N(rt[5]), nb, N(rt[2]), capacity,
                            budget)
        # every inserted key looks up to the slot holding its coordinates
        slots = N(thash.lookup(rt[0], rt[1], T(keys), g.table_size))
        found = slots >= 0
        coords = N(thash.unpack_block_key(T(keys), g.world_extent_blocks))
        np.testing.assert_array_equal(N(rt[2])[slots[found]], coords[found])
        assert found.sum() > 0
    if capacity < 256:
        assert int(rj[4]) > 0


def test_soa_pack_and_bounds_match():
    """The component-wise pack_block_coords and in_bounds against the JAX
    package's, out-of-range coordinates included."""
    rng = np.random.RandomState(3)
    ext = 64
    c = rng.randint(-ext - 3, ext + 3, (3, 2000)).astype(np.int32)
    bx, by, bz = c
    np.testing.assert_array_equal(
        N(thash.in_bounds_soa(T(bx), T(by), T(bz), ext)),
        N(jhash.in_bounds_soa(jnp.asarray(bx), jnp.asarray(by),
                              jnp.asarray(bz), ext)))
    ok = N(jhash.in_bounds_soa(jnp.asarray(bx), jnp.asarray(by),
                               jnp.asarray(bz), ext))
    got = N(thash.pack_block_coords_soa(T(bx), T(by), T(bz), ext))
    np.testing.assert_array_equal(
        got, N(jhash.pack_block_coords_soa(jnp.asarray(bx), jnp.asarray(by),
                                           jnp.asarray(bz), ext)))
    np.testing.assert_array_equal(
        got[ok], N(thash.pack_block_coords(T(c.T[ok].copy()), ext)))


def test_frame_list_from_a_frame():
    """The group-aligned layout assertions of the JAX package's own test,
    on the port's allocation of a rendered frame."""
    cj, ct = configs()
    fr = SyntheticDataset(num_frames=4, intr=INTR,
                          label_map=LabelColorMap.random()).frame(0)
    tf = tcommon.Frame(*(T(x) for x in (fr.depth, fr.labels, fr.colors,
                                        fr.T_G_C)))
    plan = tproj_model.make_plan(ct, TINTR)
    from kimera_semantics_tpu_torch.ops import mip as tmip
    atlas = tmip.build_atlas(tf.depth, tf.labels, tf.colors, plan)
    grid = tblocks.create(ct, device="cpu")
    grid, fcoords, fslots, freal = tproj_model.allocate_from_atlas(
        grid, atlas, tf.T_G_C, ct, TINTR, plan)
    real = N(freal)
    assert real.sum() == int(grid.n_blocks) > 0
    check_group_aligned(N(fslots), real, N(fcoords), int(grid.n_blocks),
                        N(grid.block_coords), ct.grid.block_capacity,
                        ct.pipeline.block_budget)
    coords = grid.block_coords[:int(grid.n_blocks)]
    slots = tblocks.lookup_slots(grid, coords, ct.grid)
    np.testing.assert_array_equal(N(slots), np.arange(int(grid.n_blocks)))
    missing = tblocks.lookup_slots(grid, torch.tensor([[400, 400, 400],
                                                       [600, 0, 0]]), ct.grid)
    assert N(missing).tolist() == [ct.grid.block_capacity] * 2


def test_mix_and_pack_match():
    rng = np.random.RandomState(1)
    keys = rng.randint(-2 ** 31, 2 ** 31 - 1, 4096, dtype=np.int64).astype(
        np.int32)
    np.testing.assert_array_equal(N(thash.mix(T(keys))),
                                  N(jhash.mix(jnp.asarray(keys))))
    coords = rng.randint(-512, 512, (100, 3)).astype(np.int32)
    k = thash.pack_block_coords(T(coords), 512)
    np.testing.assert_array_equal(N(k), N(jhash.pack_block_coords(
        jnp.asarray(coords), 512)))
    np.testing.assert_array_equal(N(thash.unpack_block_key(k, 512)), coords)


def test_readouts_on_carried_grid():
    """A JAX grid after one frame, carried across: every readout agrees,
    and the grid carries back unchanged."""
    cj, ct = configs()
    fr = SyntheticDataset(num_frames=4, intr=INTR,
                          label_map=LabelColorMap.random()).frame(1)
    g = jproj_model.integrate_frame(jblocks.create(cj), fr, cj, INTR)
    arrays = {f: np.asarray(getattr(g, f)) for f in tblocks.FIELDS}
    tg = interop.grid_from_numpy(arrays, ct, device="cpu")
    back = interop.grid_to_numpy(tg)
    for f in tblocks.FIELDS:
        np.testing.assert_array_equal(back[f], arrays[f], err_msg=f)
    t = cj.tsdf
    def jit(fn, grid, *args):
        return jax.jit(lambda gr: fn(gr, *args))(grid)
    pairs = [
        (tblocks.tsdf_distance(tg, t.truncation_distance),
         jit(jblocks.tsdf_distance, g, t.truncation_distance)),
        (tblocks.tsdf_weight(tg, t.max_weight),
         jit(jblocks.tsdf_weight, g, t.max_weight)),
        (tblocks.voxel_color(tg), jit(jblocks.voxel_color, g)),
        (tblocks.mle_labels(tg), jit(jblocks.mle_labels, g)),
        (tblocks.label_logodds(tg, -0.2, -1.6),
         jit(jblocks.label_logodds, g, -0.2, -1.6)),
    ]
    for a, b in pairs:
        np.testing.assert_array_equal(N(a), N(b))
    assert N(tblocks.mle_labels(tg)).max() > 0
    with pytest.raises(ValueError):
        interop.grid_from_numpy({**arrays, "wsum": arrays["wsum"][:-1]}, ct,
                                device="cpu")


@pytest.mark.parametrize("capacity", [768, 40])
def test_insert_compacted_and_unique_keys_match(capacity):
    """The ray integrators' run insert: duplicate-heavy keys compacted to
    their unique values first; the same key set, n_blocks and overflow as
    the JAX insert (at capacity 40 the uniques overflow)."""
    cj, _ = configs(capacity)
    g = cj.grid
    rng = np.random.RandomState(3)
    keys, active = random_keys(rng, 3000, g.world_extent_blocks, spread=4)
    keys = np.concatenate([keys, keys[:1000]])
    active = np.concatenate([active, active[:1000]])
    uj = jhash.unique_keys(jnp.asarray(keys), jnp.asarray(active), 256)
    ut = thash.unique_keys(T(keys), T(active), 256)
    np.testing.assert_array_equal(N(ut[0]), N(uj[0]))
    assert int(ut[1]) == int(uj[1]) > 0
    rj = jhash.insert_compacted(
        jnp.full((g.table_size,), -1, jnp.int32),
        jnp.full((g.table_size,), -1, jnp.int32),
        jnp.zeros((capacity, 3), jnp.int32), jnp.int32(0),
        jnp.asarray(keys), jnp.asarray(active), g.table_size, capacity,
        g.world_extent_blocks)
    rt = thash.insert_compacted(
        torch.full((g.table_size,), -1, dtype=torch.int32),
        torch.full((g.table_size,), -1, dtype=torch.int32),
        torch.zeros((capacity, 3), dtype=torch.int32),
        torch.zeros((), dtype=torch.int32), T(keys), T(active),
        g.table_size, capacity, g.world_extent_blocks)
    nb = int(rj[3])
    assert int(rt[3]) == nb > 0 and int(rt[4]) == int(rj[4])
    assert (int(rj[4]) > 0) == (capacity < 256)
    live = lambda k: set(N(k)[N(k) >= 0].tolist())  # noqa: E731
    assert live(rt[0]) == live(rj[0])
    assert set(map(tuple, N(rt[2])[:nb])) == set(map(tuple, N(rj[2])[:nb]))


def test_voxel_block_maps_match():
    rng = np.random.RandomState(4)
    pts = rng.uniform(-20, 20, (4000, 3)).astype(np.float32)
    pts[:8] = [[0, 0, 0], [-0.2, 0.2, 0.4], [0.6, -0.6, 1e-7],
               [-1e-7, 0, 0], [0.19999999, 0, 0], [-0.4, -0.8, 1.2],
               [3.0, -3.0, 0.6], [-0.6, 0.0, -1.0]]
    jv = jax.jit(lambda p: jblocks.point_to_voxel(p, 1.0 / 0.2))(pts)
    tv = tblocks.point_to_voxel(T(pts), 1.0 / 0.2)
    np.testing.assert_array_equal(N(tv), N(jv))
    for vps in (8, 16):
        jb, jl = jblocks.voxel_to_block_local(jv, vps)
        tb, tl = tblocks.voxel_to_block_local(tv, vps)
        np.testing.assert_array_equal(N(tb), N(jb))
        np.testing.assert_array_equal(N(tl), N(jl))
    assert (N(tv) < 0).any()
