"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case needs a CUDA card and skips without one (decided inside the
`cuda` fixture). The file imports nothing of JAX, so it also runs where JAX
is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Both sides compute the same float32 operations in the same order (fused
multiply-adds at the same places), so every output must be bit-identical.
"""

import contextlib
import ctypes
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
from kimera_semantics_tpu_torch.ops import _build, carve
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


def edge_jobs(cfg, dev, R, seed):
    """dda_jobs with its last R // 16 rays made zero-length (end = start);
    a tenth of the jobs are invalid."""
    origin3, point3, start3, end3, weights, valid = dda_jobs(cfg, dev, R=R,
                                                             seed=seed)
    n = R // 16
    if n:
        end3[:, -n:] = start3[:, -n:]
    return origin3, point3, start3, end3, weights, valid


@pytest.mark.parametrize("vps", [1, 5, 8, 16, 32])
@pytest.mark.parametrize("keys_only", [False, True])
@pytest.mark.parametrize("R", [1, 127, 4800, 28672])
def test_dda_instances(cuda, vps, keys_only, R):
    """Every vps instance of K1 (1 is the allocation walk's view of 8^3
    blocks; 5 the generic one), keys only and full, against the plain
    version bit for bit: S 40 (three 16-step chunks, the last one partial;
    12 at R 28672), a world extent of about 2 m so that most rays leave it,
    zero-length rays and invalid jobs."""
    g = config().grid
    grid = (dataclasses.replace(g, voxel_size=g.block_size, voxels_per_side=1)
            if vps == 1 else dataclasses.replace(g, voxels_per_side=vps))
    grid = dataclasses.replace(
        grid, world_extent_blocks=max(1, round(2.0 / grid.block_size)))
    cfg = dataclasses.replace(config(), grid=grid)
    S = 40 if R < 28672 else 12
    jobs = edge_jobs(cfg, cuda, R, seed=R + vps)
    before = kernels.launches["dda_job_stream"]
    got = kernels.dda_job_stream(cfg, S, *jobs, keys_only=keys_only)
    assert kernels.launches["dda_job_stream"] == before + 1
    ref = kernels.dda_job_stream_plain(cfg, S, *jobs, keys_only=keys_only)
    if R > 1:
        assert bool(ref[5].any()) and not bool(ref[5].all())
    for name, a, b in zip(("key", "local", "w", "wsdf", "wc", "valid",
                           "run_key", "run_idx"), got, ref):
        if b is None:
            assert a is None and keys_only, name
            continue
        assert a.dtype == b.dtype and torch.equal(a, b), name


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


# Blocks of side 1 m seen by the identity camera of EDGE_INTR (640x480,
# full level 3): the first needs exactly 2^2 (its u span 504 px times the
# float32 reciprocal of the column threshold 126 is 4.0), the second exactly
# 2^3 = 2^full_level; the third straddles the camera plane (4 corners in
# front), the fourth lies behind it, the others in front.
EDGE_BLOCKS = ((0, 0, 2), (0, 0, 1), (0, 0, 0), (0, 0, -1), (3, 2, 5),
               (-2, -1, 4), (1, 1, 20), (-5, 3, 3))
EDGE_INTR = kt.PinholeIntrinsics(fx=1008.0, fy=400.0, cx=0.0, cy=0.0,
                                 width=640, height=480)


@pytest.mark.parametrize("K", [8, 512, 4104])
def test_block_meta_sizes(cuda, K):
    """K2 against its plain version bit for bit at K 8, 512 (the main
    path's) and 4104: the edge blocks under the identity pose, and random
    blocks around the camera (behind it, straddling its plane, in front)
    under two orbit poses at 320x240."""
    rng = np.random.RandomState(K)
    coords = torch.tensor(np.concatenate(
        [EDGE_BLOCKS, rng.randint(-6, 7, (K - len(EDGE_BLOCKS), 3))]),
        dtype=torch.int32, device=cuda)
    real = torch.tensor(rng.rand(K) > 0.3, device=cuda)
    intr = kt.PinholeIntrinsics(fx=160.0, fy=160.0, cx=159.5, cy=119.5,
                                width=320, height=240)
    cases = [(EDGE_INTR, torch.eye(4, device=cuda), 1.0)] + [
        (intr, transforms.inverse(torch.tensor(orbit_pose(a), device=cuda)),
         0.8) for a in (1.3, 4.0)]
    for it, T_C_G, bs in cases:
        plan = mip_ops.make_plan(it.height, it.width)
        before = kernels.launches["block_meta"]
        got = kernels.block_meta(coords, real, T_C_G, it, plan, bs)
        assert kernels.launches["block_meta"] == before + 1
        ref = kernels.block_meta_plain(coords, real, T_C_G, it, plan, bs)
        assert torch.equal(got, ref)
        # corners in front of the camera plane, per block
        off = torch.tensor([[(c >> 2) & 1, (c >> 1) & 1, c & 1]
                            for c in range(8)], device=cuda)
        z = ((coords[:, None].float() + off) * bs) @ T_C_G[2, :3] \
            + T_C_G[2, 3]
        n_front = (z > 1e-3).sum(dim=1)
        if K > len(EDGE_BLOCKS) or bs == 1.0:
            assert bool(((n_front > 0) & (n_front < 8)).any())
            assert bool((n_front == 0).any())
    # the edge blocks under the identity pose: levels 2 and 3 (need exactly
    # 4 and 8), the full-image fallback for the straddling and the behind
    # block
    got = kernels.block_meta(coords[:8], real[:8], torch.eye(4, device=cuda),
                             EDGE_INTR, mip_ops.make_plan(480, 640), 1.0)
    assert got[:4, 3].tolist() == [2, 3, 3, 3]


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


def assert_same_tables(g, ref):
    """The hash kernels are deterministic and equal their plain versions:
    runs that inserted the same key streams hold the same tables, slot ids
    included."""
    for name in ("table_keys", "table_slots", "block_coords"):
        assert torch.equal(getattr(g, name), getattr(ref, name)), name


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
        add_f32=0, hash_lookup=3, hash_insert=3, carve_jobs_compact=0)
    ref = blocks.create(cfg, device=cuda)
    with plain_kernels():
        for f in frames:
            proj.integrate_frame(ref, f, cfg, INTR, device=cuda)
    n = int(g.n_blocks)
    assert n == int(ref.n_blocks) > 0 and int(g.overflow) == 0
    assert_same_tables(g, ref)
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


def slot_inputs(cfg, dev, n_frames=1, shard=None):
    """K6's inputs as the fast path makes them: the band jobs of
    `n_frames` frames concatenated along the ray axis, expanded by K1,
    their runs inserted, and the frames' cubes (every 5th cell cleared, so
    some runs miss; with `shard` = (my, num), the cells of other shards'
    blocks hold -1 too)."""
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
    cube, cam = integrate.frame_cube(grid, cfg, torch.stack(origins),
                                     *(shard or ()))
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
               seed=0, trash=None, distinct=True):
    """K5's inputs in numpy: grid channels (capacity + 8 rows), a
    group-aligned slot list whose trash tiles sit at the tile positions
    `trash` (default: the last two tiles), and sparse deltas; the semantic
    votes as one label per voxel (onehot), counts per label (dense) or P
    rank planes of count * 32 + label (packed), each rank empty with its own
    probability (so an empty rank may sit below a full one), with distinct
    labels per voxel unless `distinct` is false."""
    rng = np.random.RandomState(seed)
    rows = capacity + 8
    f = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)  # noqa
    chans = [f(0, 3, rows, V3), f(-1, 1, rows, V3),
             rng.randint(0, 9, (rows, V3)).astype(np.float32),
             f(-6, 0, L, rows, V3), f(0, 500, 3, rows, V3)]
    n_tiles = K // 8
    trash = (n_tiles - 2, n_tiles - 1) if trash is None else tuple(trash)
    live = rng.choice(capacity // 8, n_tiles - len(trash), replace=False)
    groups = np.full(n_tiles, capacity // 8)
    groups[[i for i in range(n_tiles) if i not in trash]] = live
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
        labs = (np.argsort(rng.rand(L, K, V3), axis=0)[:P] if distinct
                else rng.randint(0, L, (P, K, V3)))
        cnt = np.where(rng.rand(P, K, V3) < np.linspace(0.6, 0.1, P)[:, None,
                                                                     None],
                       rng.randint(1, 40, (P, K, V3)), 0)
        d_sem = np.where(cnt > 0, cnt * 32 + labs, 0).astype(np.float32)
    d_wc = (np.where(hit[:, None], f(0, 300, K, 3, V3), 0).astype(np.float32)
            if color else None)
    return chans, slots, (d_w, d_wsdf, d_cnt, d_lab, d_wc), d_sem


def on_card(a, dev, shift=0):
    """numpy array `a` on the card, `shift` elements past the start of its
    buffer (shift 1 moves it off every 16-byte boundary)."""
    if a is None:
        return None
    a = torch.from_numpy(np.ascontiguousarray(a))
    flat = torch.empty(a.numel() + shift, dtype=a.dtype, device=dev)
    out = flat[shift:].view(a.shape)
    out.copy_(a)
    return out


def rmw_call(fn, chans, slots, deltas, d_sem, lk, P, dev, shift_chans=0,
             shift_deltas=0):
    chs = [on_card(c, dev, shift_chans) for c in chans]
    d = lambda a: on_card(a, dev, shift_deltas)  # noqa: E731
    fn(*chs, d(slots), *(d(x) for x in deltas), lk, d_sem=d(d_sem),
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


@pytest.mark.parametrize("mode,P,V3,trash,distinct", [
    ("packed", 1, 512, (0, 3, 5), True),
    ("packed", 8, 4096, (1, 4), True),
    ("packed", 8, 512, (2,), False),       # ranks of one voxel share labels
    ("packed", 21, 512, (0, 6), True),     # P == L: the packed override
    ("packed", 5, 512, (3,), True),        # the generic rank count
    ("dense", 21, 4096, (5,), True),
    ("dense", 4, 512, (0,), True),         # the generic label count
    ("onehot", 0, 32768, (0, 2), True)])
@pytest.mark.parametrize("color", [False, True])
def test_block_rmw_edges(cuda, mode, P, V3, trash, distinct, color):
    """K5's redesign against its plain version, every channel bit for bit:
    trash tiles between live ones, 1 to 21 packed ranks with empty ranks
    below full ones (and repeated labels), dense counts, V3 from 512 to
    32768 (one bulk-copy chunk to 64 per tile)."""
    L = 4 if (mode, P) == ("dense", 4) else 21
    kw = dict(K=32, capacity=32) if V3 == 32768 else {}
    chans, slots, deltas, d_sem = rmw_inputs(
        mode, color, V3=V3, L=L, P=max(P, 1), trash=trash,
        distinct=distinct, **kw)
    if mode == "packed" and P > 1:     # an empty rank below a full one
        assert ((d_sem[0] == 0) & (d_sem[-1] > 0)).any()
    P = P if mode == "packed" else 0
    got = rmw_call(kernels.block_rmw_add, chans, slots, deltas, d_sem, 1.7,
                   P, cuda)
    ref = rmw_call(kernels.block_rmw_add_plain, chans, slots, deltas, d_sem,
                   1.7, P, cuda)
    assert not torch.equal(ref[3], torch.from_numpy(chans[3]).to(cuda))
    for name, a, b in zip(("wsum", "wsdf", "sem_count", "sem_delta",
                           "wcolor"), got, ref):
        assert torch.equal(a, b), name


def test_block_rmw_persistent_grid(cuda):
    """61 tiles of 8 chunks (488 work items, more than the persistent grid
    of a 132-SM card holds and no multiple of it), three of them trash
    tiles spread through the list: every channel bit for bit."""
    chans, slots, deltas, d_sem = rmw_inputs(
        "packed", True, V3=4096, K=8 * 61, capacity=512, P=8,
        trash=(5, 29, 60))
    got = rmw_call(kernels.block_rmw_add, chans, slots, deltas, d_sem, 1.3,
                   8, cuda)
    ref = rmw_call(kernels.block_rmw_add_plain, chans, slots, deltas, d_sem,
                   1.3, 8, cuda)
    for name, a, b in zip(("wsum", "wsdf", "sem_count", "sem_delta",
                           "wcolor"), got, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("mode", ["onehot", "dense", "packed"])
@pytest.mark.parametrize("color", [False, True])
@pytest.mark.parametrize("V3,shift_chans,shift_deltas", [
    (125, 0, 0), (9261, 0, 0), (512, 1, 0), (512, 0, 1), (4096, 1, 1)])
def test_block_rmw_generic(cuda, mode, color, V3, shift_chans, shift_deltas):
    """K5's generic instance (V3 % 8 != 0: vps 5 and 21; or a tensor off a
    16-byte boundary) against its plain version, every channel bit for bit,
    with trash tiles, in all three vote forms."""
    kw = dict(K=32, capacity=64) if V3 == 9261 else {}
    chans, slots, deltas, d_sem = rmw_inputs(mode, color, V3=V3, P=4, **kw)
    P = 4 if mode == "packed" else 0
    before = kernels.launches["block_rmw_add"]
    got = rmw_call(kernels.block_rmw_add, chans, slots, deltas, d_sem, 1.3,
                   P, cuda, shift_chans, shift_deltas)
    assert kernels.launches["block_rmw_add"] == before + 1
    if shift_chans:
        assert got[0].data_ptr() % 16
    ref = rmw_call(kernels.block_rmw_add_plain, chans, slots, deltas, d_sem,
                   1.3, P, cuda)
    assert not torch.equal(ref[3], torch.from_numpy(chans[3]).to(cuda))
    for name, a, b in zip(("wsum", "wsdf", "sem_count", "sem_delta",
                           "wcolor"), got, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("vps", [5, 21])
def test_unfused_odd_vps_matches_plain(cuda, vps):
    """The unfused projective route at an odd vps (vps 5 with
    fused_apply=False; vps 21, V3 9261, past the fused kernel's limit):
    two frames through K4 and K5's generic instance leave the plain
    versions' grid, bit for bit, block by block."""
    cfg = config()
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, voxels_per_side=vps,
                                      block_capacity=512),
        pipeline=dataclasses.replace(cfg.pipeline, fused_apply=vps == 21))
    ds = SyntheticDataset(num_frames=6, intr=INTR,
                          label_map=kt.LabelColorMap.random(), device=cuda)
    frames = [ds.frame(i) for i in range(2)]
    g = blocks.create(cfg, device=cuda)
    kernels.reset_launches()
    for f in frames:
        proj.integrate_frame(g, f, cfg, INTR, device=cuda)
    assert kernels.launches == dict(
        dda_job_stream=2, block_meta=2, projective_apply_fused=0,
        projective_sample_update=2, slot_resolve_stream=0, block_rmw_add=2,
        add_f32=0, hash_lookup=2, hash_insert=2, carve_jobs_compact=0)
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
    assert bool((g.wsum[a] > 0).any())
    for name in ("wsum", "wsdf", "sem_count", "sem_delta", "wcolor",
                 "updated"):
        x, y = getattr(g, name), getattr(ref, name)
        x, y = (x[:, a], y[:, b]) if x.dim() == 3 else (x[a], y[b])
        assert torch.equal(x, y), name


def block_config(vps, **kw):
    """config() on vps^3 blocks (capacity 512)."""
    cfg = config(**kw)
    return dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, voxels_per_side=vps, block_capacity=512))


def apply_both(cfg, fslots, meta, T_C_G, atlas, plan, region, dev):
    """K3 and its plain version on two copies of one nonzero grid."""
    lk = sem_ops.make_likelihood_cached(cfg).delta
    color = cfg.semantic.color_mode == tcfg.ColorMode.COLOR
    grids = []
    for fn in (kernels.projective_apply_fused,
               kernels.projective_apply_fused_plain):
        g = blocks.create(cfg, device=dev)
        g.wsum += 0.5
        g.sem_delta -= 0.25
        fn(g.wsum, g.wsdf, g.sem_count, g.sem_delta, g.wcolor, fslots, meta,
           T_C_G, atlas, cfg, INTR, plan, lk, with_color=color,
           region=region)
        grids.append([getattr(g, c) for c in ("wsum", "wsdf", "sem_count",
                                              "sem_delta", "wcolor")])
    return grids


@pytest.mark.parametrize("vps", [16, 4])
@pytest.mark.parametrize("color", [False, True])
@pytest.mark.parametrize("region", ["all", "carve"])
def test_apply_block_shapes(cuda, vps, color, region):
    """K3 on 16^3 blocks (the instance every configuration takes) and on
    4^3 (the instance for any other vps), colour mode and the carve region
    included: every channel bit for bit."""
    cfg = block_config(vps, color=color)
    f, plan, atlas, fcoords, fslots, freal = frame_list(cfg, cuda)
    T_C_G = transforms.inverse(f.T_G_C)
    meta = kernels.block_meta(fcoords, freal, T_C_G, INTR, plan,
                              cfg.grid.block_size)
    got, ref = apply_both(cfg, fslots, meta, T_C_G, atlas, plan, region,
                          cuda)
    assert not torch.equal(ref[1], blocks.create(cfg, device=cuda).wsdf)
    for name, a, b in zip(("wsum", "wsdf", "sem_count", "sem_delta",
                           "wcolor"), got, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("vps", [8, 16])
@pytest.mark.parametrize("case", ["all_trash", "all_padding", "trash_first"])
def test_apply_skips_trash_and_padding(cuda, vps, case):
    """K3 leaves the grid untouched where every group of the list is the
    trash group (its rows real) or every row is padding, and with the
    trash tiles moved ahead of the live ones equals its plain version on
    the live rows (the plain version also adds real rows of a trash tile
    into the trash rows, which no reader uses)."""
    cfg = block_config(vps)
    f, plan, atlas, fcoords, fslots, freal = frame_list(cfg, cuda)
    cap = cfg.grid.block_capacity
    trash_rows = cap + torch.arange(8, device=cuda, dtype=torch.int32)
    if case == "all_trash":
        fslots = trash_rows.repeat(fslots.shape[0] // 8)
        freal = torch.ones_like(freal)
    elif case == "all_padding":
        freal = torch.zeros_like(freal)
    else:
        tile_live = (fslots[::8] // 8) != cap // 8
        order = torch.cat([torch.nonzero(~tile_live)[:, 0],
                           torch.nonzero(tile_live)[:, 0]])
        assert 0 < int(tile_live.sum()) < len(order)
        rows = (order[:, None] * 8 + torch.arange(8, device=cuda)).reshape(-1)
        fslots, fcoords, freal = fslots[rows], fcoords[rows], freal[rows]
        freal[:8] = True         # a trash tile with real rows
    T_C_G = transforms.inverse(f.T_G_C)
    meta = kernels.block_meta(fcoords, freal, T_C_G, INTR, plan,
                              cfg.grid.block_size)
    got, ref = apply_both(cfg, fslots, meta, T_C_G, atlas, plan, "all", cuda)
    base = blocks.create(cfg, device=cuda)
    init = (base.wsum + 0.5, base.wsdf, base.sem_count,
            base.sem_delta - 0.25, base.wcolor)
    for name, a, b, c in zip(("wsum", "wsdf", "sem_count", "sem_delta",
                              "wcolor"), got, ref, init):
        if case != "trash_first":
            assert torch.equal(a, c), name
        a, b = (a[:, :cap], b[:, :cap]) if a.dim() == 3 else (a[:cap],
                                                            b[:cap])
        assert torch.equal(a, b), name
    if case == "trash_first":
        assert not torch.equal(got[1], base.wsdf)


@pytest.mark.parametrize("model,carve_mode", [
    (fast, "projective"), (fast, "decimated"), (fast, "full"),
    (merged, "projective"), (merged, "decimated")])
def test_ray_paths_match_plain(cuda, model, carve_mode):
    """Three frames through the fast or merged integrate_frame: the kernels'
    grid equals the plain versions' grid block for block; K6 launched once
    per job stream (two in carve_mode "decimated": band and carve jobs),
    K5 once per frame, and in carve_mode "decimated" the carve jobs' three
    kernels once a frame."""
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
    assert kernels.launches["carve_jobs_compact"] == 3 * 3 * (
        carve_mode == "decimated")
    # H2 for the runs' insert and H1 for the camera cube, once more each
    # for the projective carve's frame list
    carve = int(carve_mode == "projective")
    assert kernels.launches["hash_insert"] == 3 * (1 + carve)
    assert kernels.launches["hash_lookup"] == 3 * (1 + carve)
    ref = blocks.create(cfg, device=cuda)
    with plain_kernels():
        for f in frames:
            model.integrate_frame(ref, f, cfg, INTR, device=cuda)
    n = int(g.n_blocks)
    assert n == int(ref.n_blocks) > 0 and int(g.overflow) == 0
    assert int(g.dropped_rays) == int(ref.dropped_rays)
    assert_same_tables(g, ref)
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


def sample_into(outs, meta, slots, T_C_G, atlas, cfg, plan, color, region):
    """K4's C entry into caller-made outputs (d_w, d_wsdf, d_cnt, d_lab,
    d_wc or None), so a test sees which words it writes and can hand it
    planes off a 16-byte boundary."""
    p = kernels._proj_params(cfg, INTR, plan, meta.shape[0],
                             cfg.grid.num_labels, color, region, 0.0)
    fn = _build.bind("proj_sample", "ksd_projective_sample_update",
                     (ctypes.c_void_p,) * 9 + (kernels.ProjParams,
                                               ctypes.c_void_p))
    tcg = T_C_G[:3, :4].contiguous()
    ptr = lambda x: x.data_ptr() if x is not None else None  # noqa: E731
    assert fn(*(ptr(x) for x in outs), ptr(slots), ptr(meta), ptr(tcg),
              ptr(atlas), p, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("vps", [16, 32, 5])
@pytest.mark.parametrize("color", [False, True])
@pytest.mark.parametrize("case", ["list", "trash_between", "all_trash",
                                  "shifted"])
def test_sample_update_instances(cuda, vps, color, case):
    """K4's instances (16^3 and 32^3 with 16-byte stores, the generic one
    at vps 5) against the plain version on the live tiles, bit for bit,
    colour on and off: on the frame list as built; with a trash tile moved
    between live tiles; on a list of trash tiles only; and with meta,
    slots, atlas and the outputs one word off a 16-byte boundary (the
    generic instance then takes 16^3 and 32^3 too). The trash tiles' words
    stay unwritten."""
    cfg = config(color=color)
    cfg = dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, voxels_per_side=vps, voxel_size=0.8 / vps,
        block_capacity=512))
    f, plan, atlas, fcoords, fslots, freal = frame_list(cfg, cuda)
    cap = cfg.grid.block_capacity
    tile_live = (fslots[::8] // 8) != cap // 8
    assert 1 < int(tile_live.sum()) < len(tile_live)
    if case == "trash_between":
        live_t = torch.nonzero(tile_live)[:, 0]
        dead_t = torch.nonzero(~tile_live)[:, 0]
        order = torch.cat([live_t[:1], dead_t[:1], live_t[1:], dead_t[1:]])
        rows = (order[:, None] * 8 + torch.arange(8, device=cuda)).reshape(-1)
        fslots, fcoords, freal = fslots[rows], fcoords[rows], freal[rows]
        freal[8:16] = True       # the trash tile's rows real
    elif case == "all_trash":
        fslots = (cap + torch.arange(8, device=cuda, dtype=torch.int32)
                  ).repeat(fslots.shape[0] // 8)
        freal = torch.ones_like(freal)
    T_C_G = transforms.inverse(f.T_G_C)
    meta = kernels.block_meta(fcoords, freal, T_C_G, INTR, plan,
                              cfg.grid.block_size)
    shift = 1 if case == "shifted" else 0
    meta_c, slots_c, atlas_c = (on_card(x.cpu().numpy(), cuda, shift)
                                for x in (meta, fslots, atlas))
    K, V3 = meta.shape[0], cfg.grid.vps3
    ref = kernels.projective_sample_update_plain(
        meta, fslots, T_C_G, atlas, cfg, INTR, plan, with_color=color)
    fill = lambda a: on_card(a, cuda, shift)  # noqa: E731
    outs = [fill(np.full((K, V3), np.nan, np.float32)) for _ in range(3)]
    outs.append(fill(np.full((K, V3), -7, np.int32)))
    outs.append(fill(np.full((K, 3, V3), np.nan, np.float32)) if color
                else None)
    sample_into(outs, meta_c, slots_c, T_C_G, atlas_c, cfg, plan, color,
                "all")
    live = (torch.div(fslots, 8, rounding_mode="floor") != cap // 8)
    for name, a, b in zip(("d_w", "d_wsdf", "d_cnt", "d_lab", "d_wc"), outs,
                          ref):
        if b is None:
            assert a is None and not color, name
            continue
        assert torch.equal(a[live], b[live]), name
        dead = a[~live]
        untouched = (torch.isnan(dead) if a.dtype == torch.float32
                     else dead == -7)
        assert bool(untouched.all()), name
    if case == "all_trash":
        assert not bool(live.any())
    else:
        assert bool((ref[0][live] != 0).any())
    if case == "list":
        before = kernels.launches["projective_sample_update"]
        got = kernels.projective_sample_update(
            meta, fslots, T_C_G, atlas, cfg, INTR, plan, with_color=color)
        assert kernels.launches["projective_sample_update"] == before + 1
        for a, b in zip(got, outs):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a[live], b[live])


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


# ---------------------------------------------------------------------------
# The sharded and batched routes
# ---------------------------------------------------------------------------

def assert_same_grid(g, ref, cfg):
    """The same blocks and counters; every channel bit for bit, block by
    block."""
    for name in ("n_blocks", "overflow", "dropped_rays", "frame_counter"):
        assert int(getattr(g, name)) == int(getattr(ref, name)), name
    n = int(g.n_blocks)
    assert n > 0 and int(g.overflow) == 0
    assert_same_tables(g, ref)
    coords = g.block_coords[:n]
    a = blocks.lookup_slots(g, coords, cfg.grid).long()
    b = blocks.lookup_slots(ref, coords, cfg.grid).long()
    assert bool((b < cfg.grid.block_capacity).all())
    for name in ("wsum", "wsdf", "sem_count", "sem_delta", "wcolor"):
        x, y = getattr(g, name), getattr(ref, name)
        x, y = (x[:, a], y[:, b]) if x.dim() == 3 else (x[a], y[b])
        assert torch.equal(x, y), name


def band_stream(cfg, dev, n_frames):
    """The band jobs of n_frames fast frames, concatenated."""
    ds = SyntheticDataset(num_frames=8, intr=INTR,
                          label_map=kt.LabelColorMap.random(), device=dev)
    grid = blocks.create(cfg, device=dev)
    jobs = []
    for i in range(n_frames):
        grid, batches, _ = fast._frame_batches(grid, ds.frame(i), cfg, INTR)
        (band, S), = batches
        jobs.append(band)
    return carve.JobBatch(*(torch.cat([getattr(j, f) for j in jobs])
                            for f in carve.JOB_FIELDS)), S


@pytest.mark.parametrize("shard", [0, 3])
def test_integrate_jobs_shard_filter(cuda, shard):
    """integrate_jobs with a shard filter, as the sharded ray steps call
    it (slots by hash, no cube): K1 at voxel granularity and K5 against
    the plain versions; only the shard's own blocks are allocated."""
    cfg = ray_config()
    band, S = band_stream(cfg, cuda, 4)
    g = blocks.create(cfg, device=cuda)
    kernels.reset_launches()
    integrate.integrate_jobs(g, cfg, [(band, S)], shard_id=shard,
                             num_shards=4)
    assert (kernels.launches["dda_job_stream"],
            kernels.launches["block_rmw_add"],
            kernels.launches["slot_resolve_stream"]) == (1, 1, 0)
    ref = blocks.create(cfg, device=cuda)
    with plain_kernels():
        integrate.integrate_jobs(ref, cfg, [(band, S)],
                                 shard_id=torch.tensor(shard, device=cuda),
                                 num_shards=4)
    assert_same_grid(g, ref, cfg)
    keys = bhash.pack_block_coords(g.block_coords[:int(g.n_blocks)],
                                   cfg.grid.world_extent_blocks)
    assert bool(integrate.owned(keys, shard, 4).all())


def test_anti_grazing_frame_bitmask(cuda):
    """Four merged frames' band and carve jobs in one integrate_jobs call
    with ag_frames = 4 (the sharded merged step's bitmask): the kernels'
    grid against the plain versions'."""
    cfg = dataclasses.replace(ray_config(), tsdf=dataclasses.replace(
        ray_config().tsdf, enable_anti_grazing=True))
    ds = SyntheticDataset(num_frames=8, intr=INTR,
                          label_map=kt.LabelColorMap.random(), device=cuda)
    R = cfg.pipeline.max_rays
    parts = []
    for b in range(4):
        _, batches, sem, _, bdest, _ = merged._frame_parts(
            blocks.create(cfg, device=cuda), ds.frame(b), cfg, INTR)
        parts.append((batches, sem, bdest))
    batches = [(carve.JobBatch(*(torch.cat([getattr(p[0][k][0], f)
                                            for p in parts])
                                 for f in carve.JOB_FIELDS)),
                parts[0][0][k][1]) for k in range(len(parts[0][0]))]
    sem = tuple(torch.cat([p[1][i] + b * R if i == 0 else p[1][i]
                           for b, p in enumerate(parts)]) for i in range(4))
    dest = torch.cat([p[2] for p in parts])
    grids = []
    for route in ("kernels", "plain"):
        g = blocks.create(cfg, device=cuda)
        with (plain_kernels() if route == "plain"
              else contextlib.nullcontext()):
            kernels.reset_launches()
            integrate.integrate_jobs(g, cfg, batches, sem_points=sem,
                                     ag_dest_voxels=dest, ag_own_bundle=True,
                                     ag_frames=4)
            if route == "kernels":
                # Band and carve streams through K1; the plain tail, no K5.
                assert (kernels.launches["dda_job_stream"],
                        kernels.launches["block_rmw_add"]) == (2, 0)
        grids.append(g)
    assert_same_grid(*grids, cfg)


@pytest.mark.parametrize("shard", [0, 1, 2, 3])
def test_slot_resolve_sharded_cubes(cuda, shard):
    """K6 over 4 frames' band stream against 4 frame cubes that hold only
    this shard's blocks (frame_cube with shards), against its plain
    version."""
    args = slot_inputs(ray_config(), cuda, 4, shard=(shard, 4))
    got = kernels.slot_resolve_stream(*args, False)
    ref = kernels.slot_resolve_stream_plain(*args, False)
    assert args[1].shape[0] == 4 and bool((ref[6] == -1).any())
    for name, a, b in zip(("k2", "w", "wsdf", "cnt", "key", "valid",
                           "run_slots"), got, ref):
        assert torch.equal(a, b), name


def test_batched_fast_stages_eight_frames(cuda):
    """fast integrate_frames over 8 frames: one K6 with 8 cubes and one K5
    over 8 x block_budget staged rows, the grid against the plain
    versions'."""
    cfg = ray_config(block_budget=256)
    ds = SyntheticDataset(num_frames=8, intr=INTR,
                          label_map=kt.LabelColorMap.random(), device=cuda)
    frames = fast.common.Frame.stack([ds.frame(i) for i in range(8)])
    rows = []
    real_k5 = kernels.block_rmw_add

    def k5(*a, **kw):
        rows.append(a[5].shape[0])
        return real_k5(*a, **kw)
    g = blocks.create(cfg, device=cuda)
    kernels.reset_launches()
    kernels.block_rmw_add = k5
    try:
        fast.integrate_frames(g, frames, cfg, INTR, device=cuda)
    finally:
        kernels.block_rmw_add = real_k5
    assert rows == [8 * 256]
    assert (kernels.launches["slot_resolve_stream"],
            kernels.launches["block_rmw_add"],
            kernels.launches["dda_job_stream"]) == (1, 1, 9)
    ref = blocks.create(cfg, device=cuda)
    with plain_kernels():
        fast.integrate_frames(ref, frames, cfg, INTR, device=cuda)
    assert_same_grid(g, ref, cfg)


@pytest.mark.parametrize("method", ["fast", "merged", "projective"])
def test_sharded_steps_match_plain(cuda, method):
    """One step of 4 shards on the card (merged with anti-grazing) against
    the same step through the plain versions, shard by shard."""
    from kimera_semantics_tpu_torch.parallel import sharding
    cfg = ray_config() if method != "merged" else dataclasses.replace(
        ray_config(), tsdf=dataclasses.replace(ray_config().tsdf,
                                               enable_anti_grazing=True))
    ds = SyntheticDataset(num_frames=8, intr=INTR,
                          label_map=kt.LabelColorMap.random(), device=cuda)
    frames = fast.common.Frame.stack([ds.frame(i) for i in range(4)])
    mesh = sharding.make_mesh(devices=[cuda] * 4)

    def step(sg):
        if method == "projective":
            return sharding.integrate_frames_sharded_projective(
                sg, frames, cfg, INTR, mesh)
        return sharding.integrate_frames_sharded(sg, frames, cfg, INTR, mesh,
                                                 method=method)
    got = step(sharding.create_sharded(cfg, mesh))
    with plain_kernels():
        ref = step(sharding.create_sharded(cfg, mesh))
    for a, b in zip(got, ref):
        assert_same_grid(a, b, cfg)


# ---------------------------------------------------------------------------
# H1 hash_lookup and H2 hash_insert: the block hash table's probe loops
# ---------------------------------------------------------------------------

EXT = 512


def hash_keys(rng, n, spread):
    return bhash.sample_keys(rng, n, spread, EXT)


HASH_CASES = {
    # name: (table_size, capacity, prefill keys, batch keys, share active)
    "512_in_8192": (8192, 4096, lambda r: hash_keys(r, 3000, 12),
                    lambda r, pre: np.concatenate(
                        [pre[:256], hash_keys(r, 256, 40)]), 0.95),
    "900_in_4096": (4096, 2048, None,
                    lambda r, pre: hash_keys(r, 900, 12), 0.95),
    "4096_colliding": (8192, 4096, None,
                       lambda r, pre: bhash.colliding_keys(r, 4096, 8, 8192,
                                                           EXT), 0.95),
    "16376_sparse": (32768, 16376, None,
                     lambda r, pre: hash_keys(r, 16376, 20), 0.1),
    "past_16376": (32768, 16376, None,
                   lambda r, pre: hash_keys(r, 20000, 20), 0.95),
    "through_tombstones": (32768, 16376, lambda r: hash_keys(r, 20000, 20),
                           lambda r, pre: np.concatenate(
                               [pre[16000:18000], hash_keys(r, 2000, 40)]),
                           0.95),
    "state_global": (32768, 16376, None,
                     lambda r, pre: hash_keys(r, 30000, 20), 0.95),
    "global_bid": (65536, 30000, lambda r: hash_keys(r, 10000, 30),
                   lambda r, pre: hash_keys(r, 25000, 30), 0.95),
}
LOOKUP_ROUNDS = (1, 2, 7, 8, 9, 16, 17, 20, bhash.MAX_PROBES)


def assert_lookups_match(tk, ts, q, T):
    """H1 against its plain version at LOOKUP_ROUNDS, the complete flag
    included."""
    for rounds in LOOKUP_ROUNDS:
        want = kernels.hash_lookup_plain(tk, ts, q, T, rounds)
        got = kernels.hash_lookup(tk, ts, q, T, rounds)
        assert torch.equal(got[0], want[0]), rounds
        assert bool(got[1]) == bool(want[1]), rounds


@pytest.mark.parametrize("case", sorted(HASH_CASES))
def test_hash_kernels_match_plain(cuda, case):
    """H2 three times from one state: the same tables each time, equal to
    its plain version's (torch.equal on every array), the inputs
    unmodified and no bid code (<= -3) left; the shared-table instance up
    to 32768 entries, the generic one beyond. Then H1 against its plain
    version at LOOKUP_ROUNDS (windows of 16 cut short, whole, and cut in
    the second), the complete flag
    included, over the batch, absent keys, -1, -2, -3 and the keys homed
    in the table's last 8 positions (their windows wrap). The cases: 512
    keys into a table holding 3000 (512 threads), 900 keys (1024 threads,
    a key each), 4096 keys in groups of 8 sharing a
    home, 16376 keys 10% active (insert_compacted's budget at serving's
    capacity), past the capacity of 16376 (20000 keys: the probe state in
    shared memory after the table; 30000: in global scratch), a second
    batch probing through the tombstones that leaves, and a 65536-entry
    table whose bids go to global scratch."""
    T, cap, pre_fn, batch_fn, share = HASH_CASES[case]
    rng = np.random.RandomState(sorted(HASH_CASES).index(case))
    state = (torch.full((T,), -1, dtype=torch.int32, device=cuda),
             torch.full((T,), -1, dtype=torch.int32, device=cuda),
             torch.zeros((cap, 3), dtype=torch.int32, device=cuda),
             torch.zeros((), dtype=torch.int32, device=cuda))
    pre = pre_fn(rng) if pre_fn else None
    if pre is not None:
        state = kernels.hash_insert_plain(
            *state, torch.from_numpy(pre).to(cuda),
            torch.ones(len(pre), dtype=torch.bool, device=cuda), T, cap,
            512)[:4]
    assert kernels.hash_insert_instance(T, *state[:3]) == (
        "generic" if T > kernels.HASH_SHARED_MAX else "shared")
    keys_np = batch_fn(rng, pre)
    keys = torch.from_numpy(keys_np).to(cuda)
    active = torch.from_numpy(rng.rand(len(keys_np)) < share).to(cuda)
    inputs = [x.clone() for x in state]
    before = kernels.launches["hash_insert"]
    runs = [kernels.hash_insert(*state, keys, active, T, cap, 512)
            for _ in range(3)]
    assert kernels.launches["hash_insert"] == before + 3
    ref = kernels.hash_insert_plain(*state, keys, active, T, cap, 512)
    for r in runs + [ref]:
        for a, b in zip(r, runs[0]):
            assert torch.equal(a, b)
    for a, b in zip(inputs, state):
        assert torch.equal(a, b)
    tk, ts = runs[0][0], runs[0][1]
    assert not bool((tk <= -3).any()) and not bool((ts <= -3).any())
    homes = bhash.mix(keys) & (T - 1)
    q = torch.cat([keys, torch.from_numpy(hash_keys(rng, 2000, 60)).to(cuda),
                   torch.tensor([-1, -2, -3], dtype=torch.int32,
                                device=cuda), keys[homes >= T - 8]])
    assert_lookups_match(tk, ts, q, T)
    if case in ("past_16376", "4096_colliding"):
        assert int(runs[0][4]) > 0


def test_hash_kernels_edges(cuda):
    """No key: H1 launches nothing and returns an empty list, complete;
    H2 with every key inactive changes nothing but still writes n_blocks
    and overflow (0); a lookup through the wrappers of grid/hash.py
    converts int64 keys. A table entering with keys at slot -1 (they take
    slots as new entries), capacity 301 (block_coords not a multiple of 16
    bytes) and n_blocks 5: every H2 instance equals the plain version;
    tensors off a 16-byte boundary take the generic instance; the shared
    instance refuses a table past 32768 entries (raises, runs nothing).
    H1 at every LOOKUP_ROUNDS, over keys homed in the last 8 positions."""
    T, cap = 1024, 512
    tk = torch.full((T,), -1, dtype=torch.int32, device=cuda)
    ts = torch.full((T,), -1, dtype=torch.int32, device=cuda)
    bc = torch.zeros((cap, 3), dtype=torch.int32, device=cuda)
    nb = torch.full((), 7, dtype=torch.int32, device=cuda)
    before = kernels.launches["hash_lookup"]
    slots, complete = kernels.hash_lookup(
        tk, ts, torch.empty((0,), dtype=torch.int32, device=cuda), T, 64)
    assert slots.shape == (0,) and bool(complete)
    assert kernels.launches["hash_lookup"] == before
    keys = torch.from_numpy(hash_keys(np.random.RandomState(0), 100,
                                      5)).to(cuda)
    out = kernels.hash_insert(tk, ts, bc, nb, keys,
                              torch.zeros(100, dtype=torch.bool, device=cuda),
                              T, cap, 512)
    assert torch.equal(out[0], tk) and torch.equal(out[1], ts)
    assert int(out[3]) == 7 and int(out[4]) == 0
    out = bhash.insert(tk, ts, bc, nb, keys.long(),
                       torch.ones(100, dtype=torch.bool, device=cuda), T, cap,
                       512)
    got = bhash.lookup(out[0], out[1], keys.long(), T)
    assert got.dtype == torch.int32 and bool((got >= 7).all())

    rng = np.random.RandomState(1)
    T, cap = 1024, 301
    kk = torch.from_numpy(hash_keys(rng, 300, 8)).to(cuda)
    tk = torch.full((T,), -1, dtype=torch.int32, device=cuda)
    ts = torch.full((T,), -1, dtype=torch.int32, device=cuda)
    tk[7], tk[900], ts[900] = kk[0], kk[1], 3
    state = (tk, ts, torch.from_numpy(rng.randint(-9, 9, (cap, 3)).astype(
        np.int32)).to(cuda), torch.full((), 5, dtype=torch.int32,
                                        device=cuda))
    args = (*state, kk[2:200], torch.ones(198, dtype=torch.bool,
                                          device=cuda), T, cap, 512)
    ref = kernels.hash_insert_plain(*args)
    for inst in kernels.HASH_INSERT_INSTANCES:
        for a, b in zip(kernels.hash_insert(*args, instance=inst), ref):
            assert torch.equal(a, b), inst
    assert int(ref[3]) == 5 + 198 + 1
    buf = torch.full((T + 1,), -1, dtype=torch.int32, device=cuda)
    assert kernels.hash_insert_instance(T, buf[1:], ts, state[2]) == \
        "generic"
    got = kernels.hash_insert(buf[1:], *args[1:])
    for a, b in zip(got, kernels.hash_insert_plain(buf[1:], *args[1:])):
        assert torch.equal(a, b)
    big = 65536
    with pytest.raises(RuntimeError):
        kernels.hash_insert(
            torch.full((big,), -1, dtype=torch.int32, device=cuda),
            torch.full((big,), -1, dtype=torch.int32, device=cuda),
            *args[2:6], big, cap, 512, instance="shared")
    tk2, ts2 = ref[0], ref[1]
    homes = bhash.mix(kk) & (T - 1)
    q = torch.cat([kk, kk[homes >= T - 8], torch.tensor(
        [-1, -2, -3], dtype=torch.int32, device=cuda)])
    assert_lookups_match(tk2, ts2, q, T)


def test_projective_frame_makes_no_host_sync(cuda):
    """Two projective frames under torch.cuda.set_sync_debug_mode("error")
    after two warm ones: no operation of the frame waits on the host. A
    second witness, the profiler's trace of the same frames
    (utils/syncs.py), shows kernel launches and no synchronizing CUDA
    call, while it does show the one an .item() makes."""
    from kimera_semantics_tpu_torch.utils import syncs
    cfg = config()
    ds = SyntheticDataset(num_frames=6, intr=INTR,
                          label_map=kt.LabelColorMap.random(), device=cuda)
    frames = [ds.frame(i) for i in range(4)]
    g = blocks.create(cfg, device=cuda)
    for f in frames[:2]:
        proj.integrate_frame(g, f, cfg, INTR, device=cuda)
    torch.cuda.synchronize()

    def checked():
        torch.cuda.set_sync_debug_mode("error")
        try:
            for f in frames[2:]:
                proj.integrate_frame(g, f, cfg, INTR, device=cuda)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    found, launches = syncs.host_syncs(checked)
    assert found == {} and launches > 0
    control, _ = syncs.host_syncs(
        lambda: torch.ones(4, device=cuda).sum().item())
    assert control
    torch.cuda.synchronize()
    assert int(g.overflow) == 0 and int(g.n_blocks) > 0


# ---------------------------------------------------------------------------
# The remaining deployments: the simple integrator's full walk, the
# uhumans2-shaped no-cube frame, a COLOR frame, the .vxblx reload's table
# ---------------------------------------------------------------------------

def deploy_config(voxel_size=0.05, max_ray=5.0, color=False, capacity=2048,
                  **pipeline):
    """The presets' grid (16^3 storage tiles of 32^3 blocks, 0.1 m
    truncation) at `voxel_size` and `max_ray` m rays: at 0.05 m and 5 m a
    full walk is S = 180 steps."""
    cfg = config(color=color)
    return dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, voxel_size=voxel_size,
                                      voxels_per_side=16,
                                      io_voxels_per_side=32,
                                      block_capacity=capacity),
        tsdf=dataclasses.replace(cfg.tsdf, truncation_distance=0.1,
                                 max_ray_length_m=max_ray),
        pipeline=dataclasses.replace(cfg.pipeline, **pipeline))


def kernel_and_plain_frames(model, cfg, dev, n_frames, world=None):
    """n_frames through `model` with the kernels and with their plain
    versions on the card; returns (grid, plain grid, launch counts)."""
    ds = SyntheticDataset(num_frames=6, intr=INTR, world=world,
                          label_map=kt.LabelColorMap.random(), device=dev)
    frames = [ds.frame(i) for i in range(n_frames)]
    g = blocks.create(cfg, device=dev)
    kernels.reset_launches()
    for f in frames:
        model.integrate_frame(g, f, cfg, INTR, device=dev)
    counts = dict(kernels.launches)
    ref = blocks.create(cfg, device=dev)
    with plain_kernels():
        for f in frames:
            model.integrate_frame(ref, f, cfg, INTR, device=dev)
    return g, ref, counts


@pytest.mark.parametrize("R", [32768, 4801])
def test_dda_full_instance_at_simple_steps(cuda, R):
    """K1's full instance at the simple integrator's step budget: S 180 at
    0.05 m voxels and 5 m rays, R 32768 (the CLI's max_rays) and an odd R."""
    cfg = deploy_config()
    S = cfg.resolved_max_steps()
    assert S == 180
    jobs = dda_jobs(cfg, cuda, R=R, seed=5)
    got = kernels.dda_job_stream(cfg, S, *jobs)
    ref = kernels.dda_job_stream_plain(cfg, S, *jobs)
    assert int(ref[5].sum()) > 10 * R
    for name, a, b in zip(("key", "local", "w", "wsdf", "wc", "valid",
                           "run_key", "run_idx"), got, ref):
        assert torch.equal(a, b), name


def test_simple_frame_matches_plain(cuda):
    """Two simple frames (S 180, slots by hash lookups): K1, H2, H1 and K5
    once a frame, K6 never; the grid equals the plain run's."""
    from kimera_semantics_tpu_torch.models import simple
    cfg = deploy_config(segment_budget=1 << 20, block_budget=2048)
    g, ref, counts = kernel_and_plain_frames(simple, cfg, cuda, 2)
    assert counts == dict(
        dda_job_stream=2, block_meta=0, projective_apply_fused=0,
        projective_sample_update=0, slot_resolve_stream=0, block_rmw_add=2,
        add_f32=0, hash_lookup=2, hash_insert=2, carve_jobs_compact=0)
    assert_same_grid(g, ref, cfg)


def test_uhumans2_shaped_frame_takes_no_cube(cuda):
    """10 m rays at 0.05 m voxels: the camera cube (side 29, 24448 cells)
    is past cube_lut_supported's limit, so the runs' slots resolve by H1
    and K6 never launches; the grid equals the plain run's."""
    from kimera_semantics_tpu_torch.sim.world import WorldBuilder
    cfg = deploy_config(max_ray=10.0, capacity=8192,
                        segment_budget=1 << 21, block_budget=4096)
    cfg = dataclasses.replace(cfg, tsdf=dataclasses.replace(
        cfg.tsdf, carve_mode="decimated"))
    assert not kernels.cube_lut_supported(cfg)
    b = WorldBuilder()
    b.add_sphere((0.0, 0.0, 1.5), 1.5)
    for c, nrm in (((-7.0, 0.0, 2.0), (1.0, 0.0, 0.0)),
                   ((7.0, 0.0, 2.0), (-1.0, 0.0, 0.0)),
                   ((0.0, -7.0, 2.0), (0.0, 1.0, 0.0)),
                   ((0.0, 7.0, 2.0), (0.0, -1.0, 0.0))):
        b.add_plane(c, nrm)
    b.add_plane((0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    g, ref, counts = kernel_and_plain_frames(fast, cfg, cuda, 2,
                                             world=b.build(cuda))
    assert counts["slot_resolve_stream"] == 0
    assert counts["hash_lookup"] == counts["hash_insert"] == 2
    assert counts["dda_job_stream"] == 4 and counts["block_rmw_add"] == 2
    assert counts["carve_jobs_compact"] == 2 * 3
    assert_same_grid(g, ref, cfg)


@pytest.mark.parametrize("carve_mode", ["decimated", "projective"])
def test_color_frames_match_plain(cuda, carve_mode):
    """euroc-shaped frames: COLOR mode at 0.1 m voxels, the colour
    channels through K5 (and K3 under the projective carve), equal to the
    plain run's."""
    cfg = deploy_config(voxel_size=0.1, color=True)
    cfg = dataclasses.replace(cfg, tsdf=dataclasses.replace(
        cfg.tsdf, carve_mode=carve_mode), semantic=dataclasses.replace(
            cfg.semantic, dynamic_labels=()))
    g, ref, counts = kernel_and_plain_frames(fast, cfg, cuda, 2)
    assert counts["block_rmw_add"] == 2
    assert counts["projective_apply_fused"] == (
        2 if carve_mode == "projective" else 0)
    assert bool(g.wcolor.any())
    assert_same_grid(g, ref, cfg)


def test_vxblx_reload_rebuilds_the_table(cuda, tmp_path):
    """A .vxblx load_map rebuilds the table through H2: every saved
    storage tile with an observed voxel is found by H1 in the new table
    (equal to the plain lookup) and holds the saved TSDF weights; nothing
    else is allocated (the reload keeps observed tiles only)."""
    from kimera_semantics_tpu_torch.io import vxblx
    from kimera_semantics_tpu_torch.server.pipeline import SemanticTsdfServer
    cfg = deploy_config()
    g, _, _ = kernel_and_plain_frames(fast, cfg, cuda, 2)
    srv = SemanticTsdfServer(cfg, INTR, device=cuda)
    srv.grid = g
    path = str(tmp_path / "m.vxblx")
    srv.save_map(path)
    kernels.reset_launches()
    srv.load_map(path)
    assert kernels.launches["hash_insert"] == 1
    h = srv.grid
    n = int(g.n_blocks)
    observed = (g.wsum[:n] > 0).any(dim=1)
    coords = g.block_coords[:n][observed]
    assert int(h.n_blocks) == coords.shape[0] > 0
    keys = bhash.pack_block_coords(coords, cfg.grid.world_extent_blocks)
    T = cfg.grid.table_size
    got = kernels.hash_lookup(h.table_keys, h.table_slots, keys, T,
                              bhash.MAX_PROBES)
    want = kernels.hash_lookup_plain(h.table_keys, h.table_slots, keys, T,
                                     bhash.MAX_PROBES)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    slots = got[0].long()
    assert bool((slots >= 0).all()) and bool(
        (slots < cfg.grid.block_capacity).all())
    assert torch.equal(h.block_coords[slots], coords)
    old = blocks.lookup_slots(g, coords, cfg.grid).long()
    assert torch.equal(h.wsum[slots], g.wsum[old].clamp(
        max=cfg.tsdf.max_weight))
    assert len(vxblx.read_sections(path)) == 1


def test_fast_frame_host_syncs_are_declared(cuda):
    """Every host sync of a fast frame served at the uhumans2 deployment's
    budgets (10 m rays, TESSE's 720x480 camera, a 14 m room; the
    benchmark's configuration), its upload included, lies in a sync/ span
    (utils/timing.py), by the profiler's witness (utils/syncs.py)."""
    from kimera_semantics_tpu_torch.models.common import (FRAME_FIELDS,
                                                          frame_from_images)
    from kimera_semantics_tpu_torch.server import node
    from kimera_semantics_tpu_torch.server.pipeline import SemanticTsdfServer
    from kimera_semantics_tpu_torch.sim.world import WorldBuilder
    from kimera_semantics_tpu_torch.utils import syncs
    cfg, lmap = node._build(node.parse_args(
        ["batch", "unused", "--preset", "uhumans2"]))
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, max_rays=140800, carve_budget=240640,
        segment_budget=1282048, block_budget=2048))
    intr = kt.PinholeIntrinsics(fx=415.69219381653056, fy=415.69219381653056,
                                cx=360.0, cy=240.0, width=720, height=480)
    b = WorldBuilder()
    b.add_sphere((0.0, 0.0, 1.5), 1.5)
    for c, nrm in (((-7.0, 0.0, 2.0), (1.0, 0.0, 0.0)),
                   ((7.0, 0.0, 2.0), (-1.0, 0.0, 0.0)),
                   ((0.0, -7.0, 2.0), (0.0, 1.0, 0.0)),
                   ((0.0, 7.0, 2.0), (0.0, -1.0, 0.0))):
        b.add_plane(c, nrm)
    b.add_cube((-3.0, -3.0, 1.0), (1.0, 1.0, 2.0))
    b.add_plane((0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    ds = SyntheticDataset(num_frames=8, intr=intr, world=b.build(cuda),
                          label_map=lmap, device=cuda)
    host = [{k: getattr(ds.frame(i), k).cpu().numpy() for k in FRAME_FIELDS}
            for i in range(5)]
    srv = SemanticTsdfServer(cfg, intr, lmap, device=cuda)

    def serve(frames):
        for h in frames:
            srv.insert_frame(frame_from_images(device=cuda, **h))
    serve(host[:2])
    torch.cuda.synchronize()
    declared, undeclared, launches = syncs.sync_sites(lambda: serve(
        host[2:]))
    assert launches > 0
    assert undeclared == {}, (undeclared, declared)
    # Four arrays copied from pageable memory a frame.
    assert declared["sync/upload"] >= 4 * 3, declared
    assert declared["sync/runs.rank_max"] >= 3, declared
    assert int(srv.grid.overflow) == 0 and int(srv.grid.dropped_rays) == 0


# ---------------------------------------------------------------------------
# The decimated carve jobs (csrc/carve.cu) against carve_jobs + compact_jobs
# ---------------------------------------------------------------------------

UHUMANS2_INTR = kt.PinholeIntrinsics(fx=415.69219381653056,
                                     fy=415.69219381653056, cx=360.0,
                                     cy=240.0, width=720, height=480)


def room14(dev):
    """The eval world's sphere, cube and ground in a 14 m room (walls at
    +-7 m), as the benchmark's uhumans2 cell renders it."""
    from kimera_semantics_tpu_torch.sim.world import WorldBuilder
    b = WorldBuilder()
    b.add_sphere((0.0, 0.0, 1.5), 1.5)
    for c, nrm in (((-7.0, 0.0, 2.0), (1.0, 0.0, 0.0)),
                   ((7.0, 0.0, 2.0), (-1.0, 0.0, 0.0)),
                   ((0.0, -7.0, 2.0), (0.0, 1.0, 0.0)),
                   ((0.0, 7.0, 2.0), (0.0, -1.0, 0.0))):
        b.add_plane(c, nrm)
    b.add_cube((-3.0, -3.0, 1.0), (1.0, 1.0, 2.0))
    b.add_plane((0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    return b.build(dev)


def uhumans2_cell_config(**pipeline):
    """The uhumans2 preset at the benchmark cell's budgets."""
    from kimera_semantics_tpu_torch.server import node
    cfg, lmap = node._build(node.parse_args(
        ["batch", "unused", "--preset", "uhumans2"]))
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, **{**dict(max_rays=140800, carve_budget=240640,
                                segment_budget=1282048, block_budget=2048),
                         **pipeline})), lmap


def corrupt(frame, cfg, seed):
    """The frame with NaN, zero, negative, infinite, too-near and too-far
    depths at 12% of its pixels, and each dynamic label at 5% more."""
    g = torch.Generator(device=frame.depth.device).manual_seed(seed)
    r = torch.rand(frame.depth.shape, generator=g,
                   device=frame.depth.device)
    d, lab = frame.depth.clone(), frame.labels.clone()
    far = 3.0 * cfg.tsdf.max_ray_length_m
    for lo, val in ((0.0, float("nan")), (0.02, 0.0), (0.04, -1.0),
                    (0.06, float("inf")), (0.08, 0.05), (0.10, far)):
        d[(r >= lo) & (r < lo + 0.02)] = val
    for i, dyn in enumerate(cfg.semantic.dynamic_labels):
        lab[(r >= 0.2 + 0.05 * i) & (r < 0.25 + 0.05 * i)] = dyn
    return dataclasses.replace(frame, depth=d, labels=lab)


def carve_both(frame, intr, cfg, plan, budget):
    """(kernel's, plain version's) (jobs, dropped) of one frame; the
    kernel's call launched three kernels."""
    args = (frame.depth, frame.labels, frame.T_G_C, intr, cfg, plan, budget)
    before = kernels.launches["carve_jobs_compact"]
    got = kernels.carve_jobs_compact(*args)
    assert kernels.launches["carve_jobs_compact"] == before + 3
    return got, kernels.carve_jobs_compact_plain(*args)


def assert_jobs_bits_equal(got, want):
    for f in carve.JOB_FIELDS:
        a, b = getattr(got[0], f), getattr(want[0], f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f
    assert got[1].dtype == want[1].dtype == torch.int32
    assert got[1].shape == () and torch.equal(got[1], want[1])


@pytest.mark.parametrize("budget", [240640, 4096])
def test_carve_jobs_compact_at_the_uhumans2_cell(cuda, budget):
    """At the uhumans2 cell's camera, plan (5 levels, 14 chunks, 631005
    slots) and carve_budget, and at a budget that drops: every field of
    every job, the invalid ones past the valid included, and `dropped`
    bit for bit the plain version's, on a rendered frame and on one with
    corrupt depths and dynamic labels."""
    cfg, lmap = uhumans2_cell_config()
    plan = carve.plan_carve(cfg, UHUMANS2_INTR)
    assert [len(c) for c in plan.chunks] == [6, 4, 2, 1, 1]
    assert carve.carve_table(plan, 480, 720).total == 631005
    ds = SyntheticDataset(num_frames=2, intr=UHUMANS2_INTR,
                          world=room14(cuda), label_map=lmap, device=cuda)
    for f in (ds.frame(0), corrupt(ds.frame(1), cfg, 1)):
        got, want = carve_both(f, UHUMANS2_INTR, cfg, plan, budget)
        assert_jobs_bits_equal(got, want)
        assert got[0].valid.shape == (budget,)
        n = int(want[0].valid.sum())
        assert 0 < n <= budget and (int(want[1]) > 0) == (budget == 4096)


@pytest.mark.parametrize("case", ["default", "const_weight", "no_clear",
                                  "one_level", "k_max_64", "dropping",
                                  "all_slots"])
def test_carve_jobs_compact_cases(cuda, case):
    """The small camera's frames, corrupt depths and dynamic labels
    included, bit for bit: use_const_weight both ways, allow_clear False,
    a one-level plan, a k_max past 32 (levels read the 32 x 32 minima), a
    budget that drops, and one past every slot."""
    cfg = ray_config("decimated", carve_budget=20000)
    t, p = cfg.tsdf, cfg.pipeline
    if case == "const_weight":
        t = dataclasses.replace(t, use_const_weight=True)
    elif case == "no_clear":
        t = dataclasses.replace(t, allow_clear=False)
    elif case == "one_level":
        p = dataclasses.replace(p, carve_k_max=1)
    elif case == "k_max_64":
        p = dataclasses.replace(p, carve_k_max=64)
    elif case == "dropping":
        p = dataclasses.replace(p, carve_budget=512)
    elif case == "all_slots":
        p = dataclasses.replace(p, carve_budget=1 << 20)
    cfg = dataclasses.replace(cfg, tsdf=t, pipeline=p,
                              semantic=dataclasses.replace(
                                  cfg.semantic, dynamic_labels=(20, 3)))
    plan = carve.plan_carve(cfg, INTR)
    if case == "one_level":
        assert len(plan.levels) == 1
    if case == "k_max_64":
        assert plan.k_max == 64
    total = carve.carve_table(plan, INTR.height, INTR.width).total
    ds = SyntheticDataset(num_frames=3, intr=INTR,
                          label_map=kt.LabelColorMap.random(), device=cuda)
    for i in range(3):
        f = corrupt(ds.frame(i), cfg, i) if i else ds.frame(i)
        got, want = carve_both(f, INTR, cfg, plan, p.carve_budget)
        assert_jobs_bits_equal(got, want)
        assert got[0].valid.shape == (min(total, p.carve_budget),)


def test_fast_frame_builds_its_carve_jobs_in_one_call(cuda):
    """A decimated fast frame builds its carve jobs with one
    carve_jobs_compact call: inside the band/carve_jobs span the profiler
    sees its three kernel launches and no other launch or host sync, and
    on the device the three carve kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from kimera_semantics_tpu_torch.utils import syncs
    cfg = ray_config("decimated")
    ds = SyntheticDataset(num_frames=4, intr=INTR,
                          label_map=kt.LabelColorMap.random(), device=cuda)
    frames = [ds.frame(i) for i in range(3)]
    g = blocks.create(cfg, device=cuda)
    for f in frames[:2]:
        fast.integrate_frame(g, f, cfg, INTR, device=cuda)
    torch.cuda.synchronize()
    real, calls = kernels.carve_jobs_compact, []

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    kernels.carve_jobs_compact = counted
    kernels.reset_launches()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fast.integrate_frame(g, frames[2], cfg, INTR, device=cuda)
            torch.cuda.synchronize()
    finally:
        kernels.carve_jobs_compact = real
    assert len(calls) == 1 and kernels.launches["carve_jobs_compact"] == 3
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    span = [e for e in host if e.name == "integrate_frame/band/carve_jobs"]
    assert len(span) == 1
    a, b = span[0].time_range.start, span[0].time_range.end
    inside = [e.name for e in host if a <= e.time_range.start <= b]
    assert sum(n in syncs.LAUNCH_CALLS for n in inside) == 3, inside
    assert not any(syncs.is_host_sync(n) for n in inside), inside
    names = [e.name for e in events if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)
             and "carve_" in e.name]
    assert sorted(n.split("(")[0].split()[-1] for n in names) == [
        "carve_count_kernel", "carve_reach_kernel", "carve_write_kernel"]
