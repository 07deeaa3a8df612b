"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case needs a CUDA card and skips without one (decided inside the
`cuda` fixture). The file imports nothing of JAX, so it also runs where JAX
is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Both sides compute the same float32 operations in the same order (fused
multiply-adds at the same places), so every output must be bit-identical.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import kimera_semantics_tpu_torch as kt
from kimera_semantics_tpu_torch import config as tcfg
from kimera_semantics_tpu_torch.core import transforms
from kimera_semantics_tpu_torch.grid import blocks
from kimera_semantics_tpu_torch.grid import hash as bhash
from kimera_semantics_tpu_torch.io.dataset import SyntheticDataset
from kimera_semantics_tpu_torch.models import fast, merged
from kimera_semantics_tpu_torch.models import projective as proj
from kimera_semantics_tpu_torch.ops import carve
from kimera_semantics_tpu_torch.ops import integrate
from kimera_semantics_tpu_torch.ops import kernels
from kimera_semantics_tpu_torch.ops import mip as mip_ops
from kimera_semantics_tpu_torch.ops import raycast
from kimera_semantics_tpu_torch.ops import semantic as sem_ops
from kimera_semantics_tpu_torch.sim.render import orbit_pose

INTR = kt.PinholeIntrinsics(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160,
                            height=120)


@pytest.fixture
def cuda():
    """The CUDA device; skips where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def config(carving=True, color=False, dropoff=True, const_weight=False,
           near_surface=False):
    return tcfg.FusionConfig(
        grid=tcfg.GridConfig(voxel_size=0.1, voxels_per_side=8,
                             block_capacity=2048),
        tsdf=tcfg.TsdfConfig(truncation_distance=0.3, max_ray_length_m=6.0,
                             voxel_carving_enabled=carving,
                             use_weight_dropoff=dropoff,
                             use_const_weight=const_weight),
        semantic=tcfg.SemanticConfig(
            semantic_measurement_probability=0.8,
            color_mode=tcfg.ColorMode.COLOR if color
            else tcfg.ColorMode.SEMANTIC,
            update_near_surface_only=near_surface),
        pipeline=tcfg.PipelineConfig(block_budget=512, alloc_stride=2))


def dda_jobs(cfg, dev, R=3001, seed=0):
    rng = np.random.RandomState(seed)
    origin = torch.tensor(rng.uniform(-1, 1, 3), dtype=torch.float32)
    dirs = rng.randn(R, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dist = rng.uniform(0.05, 9.0, R)
    pts = origin + torch.tensor(dirs * dist[:, None], dtype=torch.float32)
    t = cfg.tsdf
    start, end = raycast.setup_rays(
        origin[None], pts, torch.tensor(dist > t.max_ray_length_m),
        voxel_size=1.0, truncation_distance=t.truncation_distance,
        max_ray_length_m=t.max_ray_length_m,
        voxel_carving_enabled=t.voxel_carving_enabled)
    soa = lambda a: a.T.contiguous().to(dev)  # noqa: E731
    return (soa(origin.expand(R, 3)), soa(pts), soa(start), soa(end),
            torch.tensor(rng.uniform(0.1, 2.0, R), dtype=torch.float32,
                         device=dev),
            torch.tensor(rng.rand(R) > 0.1, device=dev))


@pytest.mark.parametrize("carving", [True, False])
@pytest.mark.parametrize("dropoff", [True, False])
@pytest.mark.parametrize("block_view", [True, False])
def test_dda(cuda, carving, dropoff, block_view):
    cfg = config(carving=carving, dropoff=dropoff)
    if block_view:
        cfg = dataclasses.replace(cfg, grid=dataclasses.replace(
            cfg.grid, voxel_size=cfg.grid.block_size, voxels_per_side=1))
    S = 16 if block_view else 128
    jobs = dda_jobs(cfg, cuda)
    before = kernels.launches["dda_job_stream"]
    got = kernels.dda_job_stream(cfg, S, *jobs)
    assert kernels.launches["dda_job_stream"] == before + 1
    ref = kernels.dda_job_stream_plain(cfg, S, *jobs)
    assert bool(ref[5].any())
    for name, a, b in zip(("key", "local", "w", "wsdf", "wc", "valid",
                           "run_key", "run_idx"), got, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("width,height", [(320, 240), (640, 480)])
def test_block_meta(cuda, width, height):
    intr = kt.PinholeIntrinsics(fx=width / 2, fy=width / 2,
                                cx=width / 2 - 0.5, cy=height / 2 - 0.5,
                                width=width, height=height)
    plan = mip_ops.make_plan(height, width)
    rng = np.random.RandomState(width)
    K = 1000
    coords = torch.tensor(rng.randint(-8, 8, (K, 3)), dtype=torch.int32,
                          device=cuda)
    real = torch.tensor(rng.rand(K) > 0.3, device=cuda)
    for angle in (0.0, 1.3, 4.0):
        T_C_G = transforms.inverse(torch.tensor(orbit_pose(angle),
                                                device=cuda))
        args = (coords, real, T_C_G, intr, plan, 0.8)
        got = kernels.block_meta(*args)
        ref = kernels.block_meta_plain(*args)
        assert torch.equal(got, ref)
    assert len(set(got[:, 3].tolist())) > 1


def frame_list(cfg, dev, frame_index=1):
    """A rendered frame's atlas and group-aligned block list, on `dev`."""
    ds = SyntheticDataset(num_frames=6, intr=INTR,
                          label_map=kt.LabelColorMap.random(), device=dev)
    f = ds.frame(frame_index)
    plan = proj.make_plan(cfg, INTR)
    atlas = mip_ops.build_atlas(f.depth, f.labels, f.colors, plan)
    grid, fcoords, fslots, freal = proj.allocate_from_atlas(
        blocks.create(cfg, device=dev), atlas, f.T_G_C, cfg, INTR, plan)
    return f, plan, atlas, fcoords, fslots, freal


@pytest.mark.parametrize("kw", [
    dict(), dict(color=True), dict(carving=False), dict(const_weight=True),
    dict(near_surface=True), dict(dropoff=False)])
@pytest.mark.parametrize("region", ["all", "carve"])
def test_apply(cuda, kw, region):
    cfg = config(**kw)
    f, plan, atlas, fcoords, fslots, freal = frame_list(cfg, cuda)
    T_C_G = transforms.inverse(f.T_G_C)
    meta = kernels.block_meta(fcoords, freal, T_C_G, INTR, plan,
                              cfg.grid.block_size)
    lk = sem_ops.make_likelihood_cached(cfg).delta
    color = cfg.semantic.color_mode == tcfg.ColorMode.COLOR
    grids = []
    for fn in (kernels.projective_apply_fused,
               kernels.projective_apply_fused_plain):
        g = blocks.create(cfg, device=cuda)
        g.wsum += 0.5        # in place onto existing state
        fn(g.wsum, g.wsdf, g.sem_count, g.sem_delta, g.wcolor, fslots, meta,
           T_C_G, atlas, cfg, INTR, plan, lk, with_color=color,
           region=region)
        grids.append(g)
    if region == "all":
        assert bool((grids[1].wsum > 0.5).any())
    for name in ("wsum", "wsdf", "sem_count", "sem_delta", "wcolor"):
        assert torch.equal(getattr(grids[0], name),
                           getattr(grids[1], name)), name


@contextlib.contextmanager
def plain_kernels():
    names = tuple(kernels.launches)
    saved = {n: getattr(kernels, n) for n in names}
    try:
        for n in names:
            setattr(kernels, n, getattr(kernels, n + "_plain"))
        yield
    finally:
        for n, fn in saved.items():
            setattr(kernels, n, fn)


def test_main_path_matches_plain(cuda):
    """Three frames through integrate_frame: the kernels' grid equals the
    plain versions' grid block for block, and each kernel launched once per
    frame."""
    cfg = config()
    ds = SyntheticDataset(num_frames=6, intr=INTR,
                          label_map=kt.LabelColorMap.random(), device=cuda)
    frames = [ds.frame(i) for i in range(3)]
    g = blocks.create(cfg, device=cuda)
    kernels.reset_launches()
    for f in frames:
        proj.integrate_frame(g, f, cfg, INTR, device=cuda)
    assert kernels.launches == dict(
        dda_job_stream=3, block_meta=3, projective_apply_fused=3,
        projective_sample_update=0, slot_resolve_stream=0, block_rmw_add=0,
        add_f32=0)
    ref = blocks.create(cfg, device=cuda)
    with plain_kernels():
        for f in frames:
            proj.integrate_frame(ref, f, cfg, INTR, device=cuda)
    n = int(g.n_blocks)
    assert n == int(ref.n_blocks) > 0 and int(g.overflow) == 0
    coords = g.block_coords[:n]
    a = blocks.lookup_slots(g, coords, cfg.grid).long()
    b = blocks.lookup_slots(ref, coords, cfg.grid).long()
    assert bool((b < cfg.grid.block_capacity).all())
    for name in ("wsum", "wsdf", "sem_count", "sem_delta", "wcolor"):
        x, y = getattr(g, name), getattr(ref, name)
        x, y = (x[:, a], y[:, b]) if x.dim() == 3 else (x[a], y[b])
        assert torch.equal(x, y), name


# ---------------------------------------------------------------------------
# The ray integrators' kernels: K6 slot_resolve_stream, K5 block_rmw_add
# ---------------------------------------------------------------------------

def ray_config(carve_mode="projective", near_surface=False, **pipeline):
    cfg = config(near_surface=near_surface)
    return dataclasses.replace(
        cfg, tsdf=dataclasses.replace(cfg.tsdf, carve_mode=carve_mode,
                                      band_density="matched"),
        pipeline=dataclasses.replace(
            cfg.pipeline, **{**dict(max_rays=4096, segment_budget=1 << 16,
                                    carve_budget=4096), **pipeline}))


def slot_inputs(cfg, dev, n_frames=1):
    """K6's inputs as the fast path makes them: the band jobs of
    `n_frames` frames concatenated along the ray axis, expanded by K1,
    their runs inserted, and the frames' cubes (every 5th cell cleared, so
    some runs miss)."""
    ds = SyntheticDataset(num_frames=6, intr=INTR,
                          label_map=kt.LabelColorMap.random(), device=dev)
    grid = blocks.create(cfg, device=dev)
    jobs, origins = [], []
    for i in range(n_frames):
        grid, batches, origin = fast._frame_batches(grid, ds.frame(i + 1),
                                                    cfg, INTR)
        (band, S), = batches
        jobs.append(band)
        origins.append(origin)
    band = carve.JobBatch(*(torch.cat([getattr(j, f) for j in jobs])
                            for f in carve.JOB_FIELDS))
    st = integrate.expand_jobs(cfg, band, S)
    g = cfg.grid
    keys = st.run_key.reshape(-1)
    (grid.table_keys, grid.table_slots, grid.block_coords, grid.n_blocks,
     _) = bhash.insert_compacted(
        grid.table_keys, grid.table_slots, grid.block_coords, grid.n_blocks,
        keys, keys >= 0, g.table_size, g.block_capacity,
        g.world_extent_blocks)
    cube, cam = integrate.frame_cube(grid, cfg, torch.stack(origins))
    cube[:, ::5] = -1.0
    lab_shift = max(1, (g.num_labels - 1).bit_length())
    inform = sem_ops.informative(st.labels) & st.job_valid
    return (cfg, cube, cam, st.run_key, st.run_idx, st.local, st.w,
            st.w_sdf, st.wc_gate, st.step_valid, st.labels, inform,
            lab_shift)


@pytest.mark.parametrize("n_frames", [1, 2])
@pytest.mark.parametrize("gate_near", [False, True])
def test_slot_resolve(cuda, n_frames, gate_near):
    args = slot_inputs(ray_config(near_surface=gate_near), cuda, n_frames)
    before = kernels.launches["slot_resolve_stream"]
    got = kernels.slot_resolve_stream(*args, gate_near)
    assert kernels.launches["slot_resolve_stream"] == before + 1
    ref = kernels.slot_resolve_stream_plain(*args, gate_near)
    assert bool(ref[5].any()) and bool((ref[6] == -1).any())
    for name, a, b in zip(("k2", "w", "wsdf", "cnt", "key", "valid",
                           "run_slots"), got, ref):
        assert torch.equal(a, b), name


def rmw_inputs(mode, color=False, V3=512, L=21, K=64, capacity=256, P=4,
               seed=0):
    """K5's inputs in numpy: grid channels (capacity + 8 rows), a
    group-aligned slot list whose last two tiles are trash tiles, and
    sparse deltas; the semantic votes as one label per voxel (onehot),
    counts per label (dense) or P rank planes of count * 32 + label with
    distinct labels per voxel (packed)."""
    rng = np.random.RandomState(seed)
    rows = capacity + 8
    f = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)  # noqa
    chans = [f(0, 3, rows, V3), f(-1, 1, rows, V3),
             rng.randint(0, 9, (rows, V3)).astype(np.float32),
             f(-6, 0, L, rows, V3), f(0, 500, 3, rows, V3)]
    n_live = K // 8 - 2
    groups = np.concatenate([rng.choice(capacity // 8, n_live, replace=False),
                             [capacity // 8] * 2])
    slots = (np.repeat(groups, 8) * 8 + np.tile(np.arange(8), K // 8)
             ).astype(np.int32)
    hit = rng.rand(K, V3) < 0.3
    d_w = np.where(hit, f(0.1, 2, K, V3), 0).astype(np.float32)
    d_wsdf = np.where(hit, f(-0.3, 0.3, K, V3), 0).astype(np.float32)
    d_cnt = np.where(hit & (rng.rand(K, V3) < 0.7),
                     rng.randint(1, 6, (K, V3)), 0).astype(np.float32)
    d_lab = d_sem = None
    if mode == "onehot":
        d_lab = rng.randint(0, L, (K, V3)).astype(np.int32)
    elif mode == "dense":
        d_sem = np.where(rng.rand(L, K, V3) < 0.05,
                         rng.randint(1, 5, (L, K, V3)), 0).astype(np.float32)
    else:
        labs = np.argsort(rng.rand(L, K, V3), axis=0)[:P]
        cnt = np.where(rng.rand(P, K, V3) < np.linspace(0.6, 0.1, P)[:, None,
                                                                     None],
                       rng.randint(1, 40, (P, K, V3)), 0)
        d_sem = np.where(cnt > 0, cnt * 32 + labs, 0).astype(np.float32)
    d_wc = (np.where(hit[:, None], f(0, 300, K, 3, V3), 0).astype(np.float32)
            if color else None)
    return chans, slots, (d_w, d_wsdf, d_cnt, d_lab, d_wc), d_sem


def rmw_call(fn, chans, slots, deltas, d_sem, lk, P, dev):
    t = lambda a: None if a is None else torch.tensor(a, device=dev)  # noqa
    chs = [t(c) for c in chans]
    fn(*chs, t(slots), *(t(d) for d in deltas), lk, d_sem=t(d_sem),
       sem_packed_ranks=P if d_sem is not None and len(d_sem) == P else 0)
    return chs


@pytest.mark.parametrize("mode", ["onehot", "dense", "packed"])
@pytest.mark.parametrize("color", [False, True])
def test_block_rmw(cuda, mode, color):
    chans, slots, deltas, d_sem = rmw_inputs(mode, color)
    lk = 1.3862943649291992
    before = kernels.launches["block_rmw_add"]
    got = rmw_call(kernels.block_rmw_add, chans, slots, deltas, d_sem, lk, 4,
                   cuda)
    assert kernels.launches["block_rmw_add"] == before + 1
    ref = rmw_call(kernels.block_rmw_add_plain, chans, slots, deltas, d_sem,
                   lk, 4, cuda)
    assert not torch.equal(ref[3], torch.from_numpy(chans[3]).to(cuda))
    for name, a, b in zip(("wsum", "wsdf", "sem_count", "sem_delta",
                           "wcolor"), got, ref):
        assert torch.equal(a, b), name


def test_block_rmw_wide(cuda):
    """V3 = 32768 (32^3 blocks): the lane chunks of one tile span the whole
    row."""
    chans, slots, deltas, d_sem = rmw_inputs("onehot", True, V3=32768, L=4,
                                             K=32, capacity=32)
    got = rmw_call(kernels.block_rmw_add, chans, slots, deltas, d_sem, 1.7, 4,
                   cuda)
    ref = rmw_call(kernels.block_rmw_add_plain, chans, slots, deltas, d_sem,
                   1.7, 4, cuda)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model,carve_mode", [
    (fast, "projective"), (fast, "decimated"), (fast, "full"),
    (merged, "projective"), (merged, "decimated")])
def test_ray_paths_match_plain(cuda, model, carve_mode):
    """Three frames through the fast or merged integrate_frame: the kernels'
    grid equals the plain versions' grid block for block; K6 launched once
    per job stream (two in carve_mode "decimated": band and carve jobs) and
    K5 once per frame."""
    cfg = ray_config(carve_mode)
    ds = SyntheticDataset(num_frames=6, intr=INTR,
                          label_map=kt.LabelColorMap.random(), device=cuda)
    frames = [ds.frame(i) for i in range(3)]
    g = blocks.create(cfg, device=cuda)
    kernels.reset_launches()
    for f in frames:
        model.integrate_frame(g, f, cfg, INTR, device=cuda)
    streams = 2 if carve_mode == "decimated" else 1
    assert kernels.launches["slot_resolve_stream"] == 3 * streams
    assert kernels.launches["dda_job_stream"] == 3 * (
        streams + (carve_mode == "projective"))
    assert kernels.launches["block_rmw_add"] == 3
    ref = blocks.create(cfg, device=cuda)
    with plain_kernels():
        for f in frames:
            model.integrate_frame(ref, f, cfg, INTR, device=cuda)
    n = int(g.n_blocks)
    assert n == int(ref.n_blocks) > 0 and int(g.overflow) == 0
    assert int(g.dropped_rays) == int(ref.dropped_rays)
    coords = g.block_coords[:n]
    a = blocks.lookup_slots(g, coords, cfg.grid).long()
    b = blocks.lookup_slots(ref, coords, cfg.grid).long()
    assert bool((b < cfg.grid.block_capacity).all())
    for name in ("wsum", "wsdf", "sem_count", "sem_delta", "wcolor"):
        x, y = getattr(g, name), getattr(ref, name)
        x, y = (x[:, a], y[:, b]) if x.dim() == 3 else (x[a], y[b])
        assert torch.equal(x, y), name


# ---------------------------------------------------------------------------
# K4 projective_sample_update, the unfused route, and meshing on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(color=True), dict(carving=False),
                                dict(near_surface=True)])
@pytest.mark.parametrize("region", ["all", "carve"])
def test_sample_update(cuda, kw, region):
    """K4 against its plain version on the tiles K5 reads (slot group not
    the trash group): every output bit-identical."""
    cfg = config(**kw)
    f, plan, atlas, fcoords, fslots, freal = frame_list(cfg, cuda)
    T_C_G = transforms.inverse(f.T_G_C)
    meta = kernels.block_meta(fcoords, freal, T_C_G, INTR, plan,
                              cfg.grid.block_size)
    color = cfg.semantic.color_mode == tcfg.ColorMode.COLOR
    args = (meta, fslots, T_C_G, atlas, cfg, INTR, plan)
    before = kernels.launches["projective_sample_update"]
    got = kernels.projective_sample_update(*args, with_color=color,
                                           region=region)
    assert kernels.launches["projective_sample_update"] == before + 1
    ref = kernels.projective_sample_update_plain(*args, with_color=color,
                                                 region=region)
    live = (torch.div(fslots, 8, rounding_mode="floor")
            != cfg.grid.block_capacity // 8)
    assert bool(live.any()) and not bool(live.all())
    if region == "all":
        assert bool(ref[0][live].any())
    for name, a, b in zip(("d_w", "d_wsdf", "d_cnt", "d_lab", "d_wc"), got,
                          ref):
        if b is None:
            assert a is None and not color, name
            continue
        assert torch.equal(a[live], b[live]), name


def test_unfused_matches_fused(cuda):
    """Three frames with fused_apply=False (K4 then K5, once per frame each,
    K3 never) leave the grid of the fused route (K3), bit for bit and slot
    for slot."""
    cfg = config()
    cu = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, fused_apply=False))
    ds = SyntheticDataset(num_frames=6, intr=INTR,
                          label_map=kt.LabelColorMap.random(), device=cuda)
    frames = [ds.frame(i) for i in range(3)]
    grids = []
    for c in (cfg, cu):
        g = blocks.create(c, device=cuda)
        kernels.reset_launches()
        for f in frames:
            proj.integrate_frame(g, f, c, INTR, device=cuda)
        grids.append(g)
    assert kernels.launches["projective_sample_update"] == 3
    assert kernels.launches["block_rmw_add"] == 3
    assert kernels.launches["projective_apply_fused"] == 0
    a, b = grids
    assert int(a.n_blocks) == int(b.n_blocks) > 0
    for name in blocks.FIELDS:
        if name in ("table_keys", "table_slots", "block_coords"):
            continue     # racing hash claims may differ between runs
        if name in ("wsum", "wsdf", "sem_count", "sem_delta", "wcolor",
                    "updated"):
            coords = a.block_coords[:int(a.n_blocks)]
            sa = blocks.lookup_slots(a, coords, cfg.grid).long()
            sb = blocks.lookup_slots(b, coords, cfg.grid).long()
            x, y = getattr(a, name), getattr(b, name)
            x, y = (x[:, sa], y[:, sb]) if x.dim() == 3 else (x[sa], y[sb])
        else:
            x, y = getattr(a, name), getattr(b, name)
        assert torch.equal(x, y), name


def mesh_grid(dev, n_frames=3):
    cfg = config()
    ds = SyntheticDataset(num_frames=6, intr=INTR,
                          label_map=kt.LabelColorMap.random(), device=dev)
    g = blocks.create(cfg, device=dev)
    for i in range(n_frames):
        proj.integrate_frame(g, ds.frame(i), cfg, INTR, device=dev)
    return cfg, g, ds


def grid_to(grid, dev):
    return blocks.VoxelGrid(**{n: getattr(grid, n).to(dev)
                               for n in blocks.FIELDS})


@pytest.mark.parametrize("normals", [False, True])
def test_mesh_on_card_matches_cpu(cuda, normals):
    """extract_mesh on the card against the same grid meshed on the CPU:
    triangle counts, rows and colours exact, vertices within 1e-6 m,
    normals within 1e-5."""
    from kimera_semantics_tpu_torch.ops import mesh
    cfg, g, _ = mesh_grid(cuda)
    lmap = kt.LabelColorMap.random()
    a, rows_a, tri_a = mesh.extract_mesh(g, cfg, lmap, with_normals=normals,
                                         return_blocks=True)
    b, rows_b, tri_b = mesh.extract_mesh(grid_to(g, "cpu"), cfg, lmap,
                                         with_normals=normals,
                                         return_blocks=True)
    assert a.num_triangles == b.num_triangles > 0
    np.testing.assert_allclose(a.vertices, b.vertices, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(a.colors, b.colors)
    np.testing.assert_array_equal(rows_a, rows_b)
    np.testing.assert_array_equal(tri_a, tri_b)
    if normals:
        np.testing.assert_allclose(a.normals, b.normals, rtol=0, atol=1e-5)


def test_async_mesh_reads_the_grid_at_dispatch(cuda):
    """Dispatch a mesh cycle, integrate a frame at once (in place on the
    grid), then collect: the mesh equals a synchronous extract_mesh of a
    clone of the grid taken just before the dispatch."""
    from kimera_semantics_tpu_torch.ops import mesh
    cfg, g, ds = mesh_grid(cuda, 2)
    lmap = kt.LabelColorMap.random()
    snap = blocks.VoxelGrid(**{n: getattr(g, n).clone()
                               for n in blocks.FIELDS})
    collect = mesh.extract_mesh_cycle_async(g, cfg, lmap, only_updated=True,
                                            return_blocks=True,
                                            hold_grid=False)
    g.updated.zero_()
    proj.integrate_frame(g, ds.frame(3), cfg, INTR, device=cuda)
    got = collect()
    ref = mesh.extract_mesh(snap, cfg, lmap, only_updated=True,
                            return_blocks=True)
    assert got is not None
    assert got[0].num_triangles == ref[0].num_triangles > 0
    np.testing.assert_array_equal(got[0].vertices, ref[0].vertices)
    np.testing.assert_array_equal(got[0].colors, ref[0].colors)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])
    now = mesh.extract_mesh(g, cfg, lmap)
    assert now.num_triangles != ref[0].num_triangles or not np.array_equal(
        now.vertices, ref[0].vertices)


# ---------------------------------------------------------------------------
# K7 add_f32, the plain scatter modes, the ESDF and ICP on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 128), (1000,), (3, 5, 7)])
def test_add_f32(cuda, shape):
    rng = np.random.RandomState(sum(shape))
    x, y = (torch.tensor(rng.standard_normal(shape).astype(np.float32),
                         device=cuda) for _ in range(2))
    before = kernels.launches["add_f32"]
    got = kernels.add_f32(x, y)
    assert kernels.launches["add_f32"] == before + 1
    assert torch.equal(got, kernels.add_f32_plain(x, y))
    with pytest.raises(ValueError):
        kernels.add_f32(x.double(), y.double())


def card_and_cpu_grids(cfg, cuda, n_frames=3, model=fast):
    """The same frames through `model` on the card and on the CPU."""
    ds = SyntheticDataset(num_frames=6, intr=INTR,
                          label_map=kt.LabelColorMap.random(), device=cuda)
    frames = [ds.frame(i) for i in range(n_frames)]
    g = blocks.create(cfg, device=cuda)
    c = blocks.create(cfg, device="cpu")
    for f in frames:
        model.integrate_frame(g, f, cfg, INTR, device=cuda)
        fc = dataclasses.replace(f, **{k: getattr(f, k).cpu() for k in (
            "depth", "labels", "colors", "T_G_C")})
        model.integrate_frame(c, fc, cfg, INTR, device="cpu")
    return g, c


@pytest.mark.parametrize("mode", ["direct", "sorted"])
def test_plain_scatter_modes_on_card(cuda, mode):
    """scatter_mode "direct" and "sorted" on the card against the same
    frames on the CPU: block sets, counters and counts exact. "direct" adds
    with float atomics on the card: floats within 1e-5 relative plus 1e-5
    of the channel's largest value. "sorted" takes each frame's segment sums
    as differences of one running cumsum, a parallel scan on the card and a
    sequential one on the CPU, so they differ by ulps of that prefix:
    within 8 eps P, P the channel's grid total (for wsdf, truncation times
    wsum's), which no frame's prefix exceeds."""
    cfg = ray_config("projective")
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, scatter_mode=mode))
    g, c = card_and_cpu_grids(cfg, cuda)
    n = int(g.n_blocks)
    assert n == int(c.n_blocks) > 0 and int(g.overflow) == int(c.overflow)
    coords = g.block_coords[:n]
    a = blocks.lookup_slots(g, coords, cfg.grid).long().cpu()
    b = blocks.lookup_slots(c, coords.cpu(), cfg.grid).long()
    assert bool((b < cfg.grid.block_capacity).all())
    for name in ("wsum", "wsdf", "sem_count", "sem_delta"):
        x, y = getattr(g, name).cpu(), getattr(c, name)
        x, y = (x[:, a], y[:, b]) if x.dim() == 3 else (x[a], y[b])
        if name == "sem_count":
            assert torch.equal(x, y)
            continue
        if mode == "direct":
            tol = 1e-5 * (y.abs() + y.abs().max())
        else:
            P = (cfg.tsdf.truncation_distance * float(c.wsum[b].sum())
                 if name == "wsdf" else float(y.abs().sum()))
            tol = 8 * float(torch.finfo(torch.float32).eps) * P
        assert bool(((x - y).abs() <= tol).all()), name


def test_esdf_and_icp_on_card_match_cpu(cuda):
    """The batch ESDF and one ICP alignment of the same grid on the card
    and on the CPU: ESDF block coordinates and observed flags exact,
    distances within 1e-5 m; the refined pose within 1e-4."""
    from kimera_semantics_tpu_torch.core import camera as cam
    from kimera_semantics_tpu_torch.ops import esdf, icp
    cfg = ray_config("projective")
    g, _ = card_and_cpu_grids(cfg, cuda, n_frames=3)
    c = blocks.VoxelGrid(**{k: getattr(g, k).cpu()
                            for k in blocks.FIELDS})
    rg = esdf.compute_esdf_blocked(g, cfg, max_dist=1.6)
    rc = esdf.compute_esdf_blocked(c, cfg, max_dist=1.6)
    np.testing.assert_array_equal(rg.block_coords, rc.block_coords)
    np.testing.assert_array_equal(rg.observed, rc.observed)
    np.testing.assert_allclose(rg.distance, rc.distance, rtol=0, atol=1e-5)
    ds = SyntheticDataset(num_frames=12, intr=INTR,
                          label_map=kt.LabelColorMap.random(), device=cuda)
    f = ds.frame(1)
    xi = torch.tensor([0.01, -0.01, 0.01, 0.02, -0.015, 0.015],
                      device=cuda)
    T = f.T_G_C.float() @ icp._exp_se3(xi)
    pts, valid = cam.backproject(f.depth, INTR)
    tg, rms_g, ratio_g = icp.align_to_map(g, cfg, pts, valid, T)
    tc, rms_c, ratio_c = icp.align_to_map(c, cfg, pts.cpu(), valid.cpu(),
                                          T.cpu())
    assert float(ratio_g) == pytest.approx(float(ratio_c), abs=1e-3)
    np.testing.assert_allclose(tg.cpu().numpy(), tc.numpy(), atol=1e-4)
