"""The port's kernels (kimera_semantics_tpu_torch/ops/kernels.py) against the
JAX package: each plain version vs the Pallas kernel it replaces, run
interpreted on the CPU, and vs the JAX package's XLA path. The CUDA kernels
themselves are held against their plain versions in test_torch_cuda.py."""

import dataclasses
import enum
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kimera_semantics_tpu import config as jcfg
from kimera_semantics_tpu.core import transforms as jtr
from kimera_semantics_tpu.core.camera import PinholeIntrinsics
from kimera_semantics_tpu.core.color import LabelColorMap
from kimera_semantics_tpu.grid import blocks as jblocks
from kimera_semantics_tpu.io.dataset import SyntheticDataset
from kimera_semantics_tpu.models import projective as jproj_model
from kimera_semantics_tpu.ops import mip as jmip
from kimera_semantics_tpu.ops import pallas_kernels as pk
from kimera_semantics_tpu.ops import projective as jproj
from kimera_semantics_tpu.ops import raycast as jray
from kimera_semantics_tpu.ops.integrate import make_likelihood_cached

from kimera_semantics_tpu_torch import config as tcfg
from kimera_semantics_tpu_torch.core import camera as tcam
from kimera_semantics_tpu_torch.grid import blocks as tblocks
from kimera_semantics_tpu_torch.ops import kernels
from kimera_semantics_tpu_torch.ops import mip as tmip
from kimera_semantics_tpu_torch.ops import projective as tproj

INTR = PinholeIntrinsics(fx=60.0, fy=60.0, cx=39.5, cy=29.5, width=80,
                         height=60)
TINTR = tcam.PinholeIntrinsics(**INTR.__dict__)


def configs(carving=True, color=False, **grid):
    """The same small configuration in both packages."""
    out = []
    for m in (jcfg, tcfg):
        out.append(m.FusionConfig(
            grid=m.GridConfig(**{**dict(voxel_size=0.25, voxels_per_side=8,
                                        block_capacity=768), **grid}),
            tsdf=m.TsdfConfig(truncation_distance=0.5, max_ray_length_m=8.0,
                              voxel_carving_enabled=carving),
            semantic=m.SemanticConfig(
                semantic_measurement_probability=0.8,
                color_mode=(m.ColorMode.COLOR if color
                            else m.ColorMode.SEMANTIC)),
            pipeline=m.PipelineConfig(block_budget=256, alloc_stride=4)))
    return out


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def dda_inputs(cfg_j, R=512, seed=0):
    """K1 inputs: rays from one origin to random surface points, a third
    of them beyond max_ray (clearing rays), world-unit extents."""
    rng = np.random.RandomState(seed)
    origin = rng.uniform(-1, 1, 3).astype(np.float32)
    dirs = rng.randn(R, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dist = rng.uniform(0.3, 11.0, R)
    pts = (origin + dirs * dist[:, None]).astype(np.float32)
    clearing = dist > cfg_j.tsdf.max_ray_length_m
    t = cfg_j.tsdf
    start, end = jax.jit(functools.partial(
        jray.setup_rays, voxel_size=1.0,
        truncation_distance=t.truncation_distance,
        max_ray_length_m=t.max_ray_length_m,
        voxel_carving_enabled=t.voxel_carving_enabled))(origin, pts, clearing)
    weights = rng.uniform(0.1, 2.0, R).astype(np.float32)
    valid = rng.rand(R) > 0.1
    o3 = np.repeat(origin[:, None], R, axis=1)
    return (o3, pts.T.copy(), N(start).T.copy(), N(end).T.copy(), weights,
            valid)


@pytest.mark.parametrize("carving", [True, False])
@pytest.mark.parametrize("granularity", ["voxel", "block"])
def test_dda_plain_matches_pallas(carving, granularity):
    cj, ct = configs(carving=carving)
    if granularity == "block":   # the main path's view: one voxel per block
        cj, ct = (dataclasses.replace(c, grid=dataclasses.replace(
            c.grid, voxel_size=c.grid.block_size, voxels_per_side=1))
            for c in (cj, ct))
    S = 24 if granularity == "block" else 64
    args = dda_inputs(cj)
    ref = pk.dda_job_stream(cj, S, *(jnp.asarray(a) for a in args),
                            interpret=True)
    got = kernels.dda_job_stream(ct, S, *(T(a) for a in args))
    names = ("key", "local", "w", "wsdf", "wc", "valid", "run_key", "run_idx")
    assert bool(np.asarray(ref[5]).any())
    for name, a, b in zip(names, ref, got):
        a, b = N(a), N(b)
        assert a.shape == b.shape, name
        if name in ("w", "wsdf", "wc"):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("carving", [True, False])
def test_dda_keys_only_matches_pallas(carving):
    """The allocation walk's keys-only form: the plain version's block keys
    and validity against the Pallas kernel's at block granularity; the
    other six outputs are None."""
    cj, ct = (dataclasses.replace(c, grid=dataclasses.replace(
        c.grid, voxel_size=c.grid.block_size, voxels_per_side=1))
        for c in configs(carving=carving))
    S = 24
    args = dda_inputs(cj, seed=3)
    ref = pk.dda_job_stream(cj, S, *(jnp.asarray(a) for a in args),
                            interpret=True)
    got = kernels.dda_job_stream(ct, S, *(T(a) for a in args),
                                 keys_only=True)
    assert [x is None for x in got] == [False] + [True] * 4 + [False] \
        + [True] * 2
    assert got[5].dtype == torch.bool and bool(got[5].any())
    np.testing.assert_array_equal(N(got[0]), N(ref[0]))
    np.testing.assert_array_equal(N(got[5]), N(ref[5]).astype(bool))


def block_meta_inputs(seed=2, K=128):
    rng = np.random.RandomState(seed)
    fcoords = rng.randint(-6, 6, (K, 3)).astype(np.int32)
    freal = rng.rand(K) > 0.3
    ang = rng.uniform(0, 2 * np.pi)
    T_G_C = np.array([[np.cos(ang), 0, np.sin(ang), 0.3],
                      [np.sin(ang), 0, -np.cos(ang), 0.1],
                      [0, 1, 0, -0.4], [0, 0, 0, 1]], np.float32)
    return fcoords, freal, T_G_C


@pytest.mark.parametrize("seed", [2, 5])
def test_block_meta_plain_matches_pallas(seed):
    """Exact, at a 320x240 camera whose plan has three mip levels."""
    intr = PinholeIntrinsics(fx=160.0, fy=160.0, cx=159.5, cy=119.5,
                             width=320, height=240)
    cj, ct = configs()
    plan = jmip.make_plan(intr.height, intr.width)
    tplan = tmip.MipPlan(**plan.__dict__)
    fcoords, freal, T_G_C = block_meta_inputs(seed)
    T_C_G = jax.jit(jtr.inverse)(T_G_C)
    tflat = jnp.zeros((1, 128), jnp.float32).at[0, :12].set(
        T_C_G[:3, :4].reshape(-1))
    ref = pk.block_meta(jnp.asarray(fcoords), jnp.asarray(freal), tflat,
                        intr, plan, cj.grid.block_size, interpret=True)
    got = kernels.block_meta(T(fcoords), T(freal), T(N(T_C_G)),
                             tcam.PinholeIntrinsics(**intr.__dict__), tplan,
                             ct.grid.block_size)
    assert len(set(N(got)[:, 3].tolist())) > 1   # several levels in play
    np.testing.assert_array_equal(N(got), N(ref))


def frame_atlas(cj, frame_index=2):
    ds = SyntheticDataset(num_frames=6, intr=INTR,
                          label_map=LabelColorMap.random())
    fr = ds.frame(frame_index)
    plan = jmip.make_plan(INTR.height, INTR.width, cj.pipeline.patch_rows,
                          cj.pipeline.patch_cols)
    atlas = jax.jit(functools.partial(jmip.build_atlas, plan=plan))(
        fr.depth, fr.labels, fr.colors)
    return fr, plan, atlas


@pytest.mark.parametrize("region", ["all", "carve"])
@pytest.mark.parametrize("color", [False, True])
def test_apply_plain_matches_voxel_deltas(region, color):
    """K3's plain version (sample terms + index_add_ apply) vs the JAX
    package's XLA voxel_deltas in gather mode, scattered the same way."""
    cj, ct = configs(color=color)
    fr, plan, atlas = frame_atlas(cj)
    tplan = tmip.MipPlan(**plan.__dict__)
    # The frame's allocated blocks, then random ones around the scene.
    _, fc, _, freal = jax.jit(functools.partial(
        jproj_model.allocate_from_atlas, cfg=cj, intr=INTR, plan=plan))(
        jblocks.create(cj), atlas, fr.T_G_C)
    rng = np.random.RandomState(7)
    K = 48
    touched = np.asarray(fc)[np.asarray(freal)]
    bc = np.concatenate([touched, rng.randint(
        -3, 3, (K - len(touched), 3))]).astype(np.int32)
    real = np.ones(K, bool)
    real[-3:] = False
    d = jax.jit(functools.partial(
        jproj.voxel_deltas, intr=INTR, plan=plan, cfg=cj,
        sample_mode="gather", region=region))(bc, real, atlas, fr.T_G_C)
    dt = tproj.voxel_deltas(T(bc), T(real), T(atlas), T(fr.T_G_C), TINTR,
                            tplan, ct, region=region)
    for name, tol in (("w", 1e-5), ("wsdf", 1e-5), ("cnt", 0.0),
                      ("label", 0.0), ("sem", 1e-6), ("wcolor", 2e-3)):
        a, b = N(d[name]), N(dt[name])
        bad = np.abs(b - a) > tol + 1e-4 * np.abs(a)
        assert not bad.any(), (name, int(bad.sum()))
    assert N(d["w"]).any()

    # The same deltas applied by K3's plain version into a zero grid.
    grid = tblocks.create(ct, device="cpu")
    slots = np.arange(K, dtype=np.int32)
    T_C_G = T(N(jax.jit(jtr.inverse)(fr.T_G_C)))
    meta = kernels.block_meta(T(bc), T(real), T_C_G, TINTR, tplan,
                              ct.grid.block_size)
    kernels.projective_apply_fused(
        grid.wsum, grid.wsdf, grid.sem_count, grid.sem_delta, grid.wcolor,
        T(slots), meta, T_C_G, T(atlas), ct, TINTR, tplan,
        make_likelihood_cached(cj).delta, with_color=color, region=region)
    for name, key in (("wsum", "w"), ("wsdf", "wsdf"), ("sem_count", "cnt")):
        np.testing.assert_array_equal(N(getattr(grid, name))[:K],
                                      N(d[key]), err_msg=name)
    np.testing.assert_array_equal(N(grid.sem_delta)[:, :K],
                                  N(d["sem"]).transpose(1, 0, 2))
    np.testing.assert_allclose(N(grid.wcolor)[:, :K],
                               N(d["wcolor"]).transpose(1, 0, 2),
                               rtol=1e-6, atol=1e-6)
    assert not N(grid.wsum)[K:].any()


def test_apply_plain_matches_fused_pallas():
    """K3's plain version vs the Pallas fused kernel run interpreted, on one
    frame's group-aligned block list. The Pallas kernel samples depth
    through a bf16 hi/lo split (|err| < depth * 2^-18), so band-edge voxels
    may flip: |diff| > 1e-3 + 1e-3 |ref| on fewer than 0.5% of voxels."""
    cj, ct = configs()
    fr, plan, atlas = frame_atlas(cj, frame_index=1)
    tplan = tmip.MipPlan(**plan.__dict__)
    g = jblocks.create(cj)
    g, fcoords, fslots, freal = jax.jit(functools.partial(
        jproj_model.allocate_from_atlas, cfg=cj, intr=INTR, plan=plan))(
        g, atlas, fr.T_G_C)
    T_C_G = jax.jit(jtr.inverse)(fr.T_G_C)
    tflat = jnp.zeros((1, 128), jnp.float32).at[0, :12].set(
        T_C_G[:3, :4].reshape(-1))
    meta = pk.block_meta(fcoords, freal, tflat, INTR, plan,
                         cj.grid.block_size, interpret=True)
    lk = make_likelihood_cached(cj).delta
    ref = pk.projective_apply_fused(
        g.wsum, g.wsdf, g.sem_count, g.sem_delta, g.wcolor, fslots, meta,
        tflat, atlas, cj, INTR, plan, lk_delta=lk, interpret=True)
    grid = tblocks.create(ct, device="cpu")
    got = kernels.projective_apply_fused(
        grid.wsum, grid.wsdf, grid.sem_count, grid.sem_delta, grid.wcolor,
        T(fslots), T(meta), T(N(T_C_G)), T(atlas), ct, TINTR, tplan, lk)
    nb = int(g.n_blocks)
    assert nb > 0
    for name, a, b in zip(("wsum", "wsdf", "sem_count", "sem_delta",
                           "wcolor"), ref, got):
        a, b = N(a), N(b)
        sl = (slice(None), slice(0, nb)) if a.ndim == 3 else slice(0, nb)
        bad = np.abs(b[sl] - a[sl]) > 1e-3 + 1e-3 * np.abs(a[sl])
        assert bad.mean() < 5e-3, (name, bad.mean())


@pytest.mark.parametrize("color", [False, True])
def test_sample_update_plain_matches_pallas(color):
    """K4's plain version vs the Pallas projective_sample_update run
    interpreted (vps 8, K = 16: one frame's first two tiles of the
    group-aligned list), compared on the tiles K5 reads (slot group not
    the trash group); the Pallas kernel leaves the other tiles' outputs
    unset. The Pallas sampler reads depth through a bf16 hi/lo split, so
    band-edge voxels may flip: floats differ by more than 1e-3 + 1e-3 |ref|
    on fewer than 0.5% of voxels, and labels and counts on as few."""
    cj, ct = configs(color=color)
    fr, plan, atlas = frame_atlas(cj, frame_index=1)
    tplan = tmip.MipPlan(**plan.__dict__)
    _, fcoords, fslots, freal = jax.jit(functools.partial(
        jproj_model.allocate_from_atlas, cfg=cj, intr=INTR, plan=plan))(
        jblocks.create(cj), atlas, fr.T_G_C)
    K = 16
    fcoords, fslots, freal = (np.array(a)[:K] for a in (fcoords, fslots,
                                                           freal))
    fslots[8:] = cj.grid.block_capacity + np.arange(8)   # a trash tile
    T_C_G = jax.jit(jtr.inverse)(fr.T_G_C)
    tflat = jnp.zeros((1, 128), jnp.float32).at[0, :12].set(
        T_C_G[:3, :4].reshape(-1))
    # K2's plain version (exact against the Pallas block_meta, whose
    # lanes need K % 128 == 0).
    meta = N(kernels.block_meta(T(fcoords), T(freal), T(N(T_C_G)), TINTR,
                                tplan, ct.grid.block_size))
    ref = pk.projective_sample_update(jnp.asarray(meta), tflat, atlas, cj,
                                      INTR, plan, with_color=color,
                                      interpret=True)
    got = kernels.projective_sample_update(
        T(meta), T(fslots), T(N(T_C_G)), T(atlas), ct, TINTR, tplan,
        with_color=color)
    assert (got[4] is not None) == color
    live = slice(0, 8)
    assert N(got[0])[live].any()
    for name, a, b in zip(("d_w", "d_wsdf", "d_cnt", "d_lab", "d_wc"), ref,
                          got):
        if b is None:
            assert not N(a)[live].any(), name
            continue
        a, b = N(a)[live], N(b)[live]
        bad = np.abs(b.astype(np.float64) - a) > 1e-3 + 1e-3 * np.abs(a)
        assert bad.mean() < 5e-3, (name, bad.mean())


def test_patch_sampling_matches():
    """extract_patches + gather-mode sample_patches, including samples
    outside the window (they read 0)."""
    cj, _ = configs(color=True)
    _, plan, atlas = frame_atlas(cj)
    tplan = tmip.MipPlan(**plan.__dict__)
    rng = np.random.RandomState(4)
    K, V3 = 6, 300
    v0 = (rng.randint(0, 1, K) * 8).astype(np.int32)
    u0 = np.zeros(K, np.int32)
    row = rng.randint(-4, plan.row_window + 4, (K, V3)).astype(np.int32)
    col = rng.randint(-4, plan.col_window + 4, (K, V3)).astype(np.int32)
    pj = jproj.extract_patches(atlas, jnp.asarray(u0), jnp.asarray(v0), plan)
    pt = tproj.extract_patches(T(atlas), T(u0), T(v0), tplan)
    np.testing.assert_array_equal(N(pt), N(pj))
    sj = jproj.sample_patches(pj, jnp.asarray(row), jnp.asarray(col),
                              "gather")
    st = tproj.sample_patches(pt, T(row), T(col))
    np.testing.assert_array_equal(N(st), N(sj))
    assert (N(st)[(row < 0) | (col >= plan.col_window)] == 0).all()


# ---------------------------------------------------------------------------
# K6 slot_resolve_stream and K5 block_rmw_add
# ---------------------------------------------------------------------------

def to_jax_config(cfg):
    """The JAX package's FusionConfig with the same fields as the port's."""
    def conv(obj):
        if dataclasses.is_dataclass(obj):
            return getattr(jcfg, type(obj).__name__)(**{
                f.name: conv(getattr(obj, f.name))
                for f in dataclasses.fields(obj)})
        if isinstance(obj, enum.Enum):
            return getattr(jcfg, type(obj).__name__)(obj.value)
        return obj
    return conv(cfg)


@pytest.mark.parametrize("n_frames,gate_near", [(1, False), (1, True),
                                                (2, False)])
def test_slot_resolve_plain_matches_pallas(n_frames, gate_near):
    """K6's plain version vs the Pallas kernel run interpreted, on the band
    stream K1 makes of one frame or of two frames side by side (one cube
    each), with every 5th cube cell missing: all seven outputs exact."""
    from test_torch_cuda import ray_config, slot_inputs
    args = slot_inputs(ray_config(near_surface=gate_near),
                       torch.device("cpu"), n_frames)
    cfg, cube, cam = args[:3]
    assert cube.shape[0] == n_frames
    ref = pk.slot_resolve_stream(
        to_jax_config(cfg), *(jnp.asarray(N(a)) for a in args[1:12]),
        args[12], gate_near, interpret=True)
    got = kernels.slot_resolve_stream(*args, gate_near)
    assert bool(N(got[5]).any()) and bool((N(got[6]) == -1).any())
    assert bool((N(got[4]) < 0).any())      # raw keys of unresolved steps
    for name, a, b in zip(("k2", "w", "wsdf", "cnt", "key", "valid",
                           "run_slots"), ref, got):
        np.testing.assert_array_equal(N(b), N(a), err_msg=name)


@pytest.mark.parametrize("mode,color,wide", [
    ("onehot", False, False), ("onehot", True, False), ("dense", False, False),
    ("packed", False, False), ("packed", True, False), ("onehot", True, True)])
def test_block_rmw_plain_matches_pallas(mode, color, wide):
    """K5's plain version vs the Pallas kernel run interpreted: onehot,
    dense and packed semantic votes, trash tiles, and (wide) the V3 = 32768
    case of tests/test_pallas.py, whose lanes the Pallas kernel splits. The
    trash group's rows are garbage by the kernel's contract and are not
    compared."""
    from test_torch_cuda import rmw_call, rmw_inputs
    kw = dict(V3=32768, L=4, K=32, capacity=32) if wide else {}
    chans, slots, deltas, d_sem = rmw_inputs(mode, color, **kw)
    lk = float(np.float32(1.3862943649291992))
    d_w, d_wsdf, d_cnt, d_lab, d_wc = deltas
    K, V3 = d_w.shape
    P = 4 if mode == "packed" else 0
    ref = pk.block_rmw_add(
        *(jnp.asarray(a) for a in chans), jnp.asarray(slots),
        jnp.asarray(d_w), jnp.asarray(d_wsdf), jnp.asarray(d_cnt),
        None if d_lab is None else jnp.asarray(d_lab),
        jnp.asarray(d_wc if color else np.zeros((K, 3, V3), np.float32)),
        lk_delta=lk, interpret=True,
        d_sem=None if d_sem is None else jnp.asarray(d_sem),
        sem_packed_ranks=P)
    got = rmw_call(kernels.block_rmw_add, chans, slots, deltas, d_sem, lk, P,
                   torch.device("cpu"))
    live = chans[0].shape[0] - 8
    for name, a, b in zip(("wsum", "wsdf", "sem_count", "sem_delta",
                           "wcolor"), ref, got):
        a, b = N(a), N(b)
        a, b = (a[:, :live], b[:, :live]) if a.ndim == 3 else (a[:live],
                                                              b[:live])
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert not np.array_equal(N(got[3])[:, :live], chans[3][:, :live])


@pytest.mark.parametrize("trash,color", [((0, 3, 5), False), ((1, 6), True)])
def test_block_rmw_plain_matches_pallas_interleaved(trash, color):
    """The contract K5's redesign is held to: its plain version against the
    Pallas kernel run interpreted with trash tiles between live ones (not
    only at the tail), 8 packed ranks of which any may be empty below a
    full one: the live rows exact."""
    from test_torch_cuda import rmw_call, rmw_inputs
    chans, slots, deltas, d_sem = rmw_inputs("packed", color, P=8,
                                             trash=trash, seed=3)
    assert ((d_sem[0] == 0) & (d_sem[7] > 0)).any()
    groups = slots[::8] // 8
    assert (groups[list(trash)] == chans[0].shape[0] // 8 - 1).all()
    lk = float(np.float32(1.3862943649291992))
    d_w, d_wsdf, d_cnt, _, d_wc = deltas
    K, V3 = d_w.shape
    ref = pk.block_rmw_add(
        *(jnp.asarray(a) for a in chans), jnp.asarray(slots),
        jnp.asarray(d_w), jnp.asarray(d_wsdf), jnp.asarray(d_cnt), None,
        jnp.asarray(d_wc if color else np.zeros((K, 3, V3), np.float32)),
        lk_delta=lk, interpret=True, d_sem=jnp.asarray(d_sem),
        sem_packed_ranks=8)
    got = rmw_call(kernels.block_rmw_add, chans, slots, deltas, d_sem, lk, 8,
                   torch.device("cpu"))
    live = chans[0].shape[0] - 8
    for name, a, b in zip(("wsum", "wsdf", "sem_count", "sem_delta",
                           "wcolor"), ref, got):
        a, b = N(a), N(b)
        a, b = (a[:, :live], b[:, :live]) if a.ndim == 3 else (a[:live],
                                                              b[:live])
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert not np.array_equal(N(got[3])[:, :live], chans[3][:, :live])


def test_apply_plain_matches_fused_pallas_trash_between():
    """The contract K3's redesign is held to: its plain version against the
    Pallas fused kernel run interpreted (vps 8) on one frame's list with a
    trash tile, its rows real, moved between live tiles. The trash group
    takes no update from the Pallas kernel (the plain version adds its real
    rows into the trash rows, which no reader uses), so the live rows are
    compared, with test_apply_plain_matches_fused_pallas's tolerance for the
    Pallas sampler's bf16 depth split."""
    cj, ct = configs()
    fr, plan, atlas = frame_atlas(cj, frame_index=1)
    tplan = tmip.MipPlan(**plan.__dict__)
    g = jblocks.create(cj)
    g, fcoords, fslots, freal = jax.jit(functools.partial(
        jproj_model.allocate_from_atlas, cfg=cj, intr=INTR, plan=plan))(
        g, atlas, fr.T_G_C)
    cap = cj.grid.block_capacity
    fcoords, fslots, freal = (np.array(a) for a in (fcoords, fslots, freal))
    tiles = fslots[::8] // 8
    live = np.nonzero(tiles != cap // 8)[0]
    dead = np.nonzero(tiles == cap // 8)[0]
    assert len(live) >= 2 and len(dead) >= 1
    order = np.concatenate([live[:1], dead[:1], live[1:], dead[1:]])
    rows = (order[:, None] * 8 + np.arange(8)).reshape(-1)
    fcoords, fslots, freal = fcoords[rows], fslots[rows], freal[rows]
    fcoords[8:16] = fcoords[:8]          # the trash tile's rows: real blocks
    freal[8:16] = freal[:8]
    assert freal[8:16].any() and (fslots[8:16] // 8 == cap // 8).all()
    T_C_G = jax.jit(jtr.inverse)(fr.T_G_C)
    tflat = jnp.zeros((1, 128), jnp.float32).at[0, :12].set(
        T_C_G[:3, :4].reshape(-1))
    meta = pk.block_meta(jnp.asarray(fcoords), jnp.asarray(freal), tflat,
                         INTR, plan, cj.grid.block_size, interpret=True)
    lk = make_likelihood_cached(cj).delta
    ref = pk.projective_apply_fused(
        g.wsum, g.wsdf, g.sem_count, g.sem_delta, g.wcolor,
        jnp.asarray(fslots), meta, tflat, atlas, cj, INTR, plan, lk_delta=lk,
        interpret=True)
    grid = tblocks.create(ct, device="cpu")
    got = kernels.projective_apply_fused(
        grid.wsum, grid.wsdf, grid.sem_count, grid.sem_delta, grid.wcolor,
        T(fslots), T(meta), T(N(T_C_G)), T(atlas), ct, TINTR, tplan, lk)
    assert N(got[0])[fslots[:8]].any()
    assert N(got[0])[cap:].any()         # the plain version's trash rows
    for name, a, b in zip(("wsum", "wsdf", "sem_count", "sem_delta",
                           "wcolor"), ref, got):
        a, b = N(a), N(b)
        sl = (slice(None), slice(0, cap)) if a.ndim == 3 else slice(0, cap)
        bad = np.abs(b[sl] - a[sl]) > 1e-3 + 1e-3 * np.abs(a[sl])
        assert bad.mean() < 5e-3, (name, bad.mean())
