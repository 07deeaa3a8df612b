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
from kimera_semantics_tpu_torch.io.dataset import SyntheticDataset
from kimera_semantics_tpu_torch.models import projective as proj
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
    names = ("dda_job_stream", "block_meta", "projective_apply_fused")
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
    assert all(v == 3 for v in kernels.launches.values())
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
