"""The port's sharded grid (parallel/) against the JAX package's, on the
CPU: the sharded fast, merged (anti-grazing off and on) and projective
(float32 and u16 wire) steps shard by shard; the ownership filter, the
multi-frame anti-grazing bitmask, the sharded frame cube and candidate
insert and the mixed-frame projective helpers as units; the pipeline, the
mirror and the merge against the direct steps; the gather through a
process group, in one process and across two (gloo); the CLI's --devices.

The JAX steps run on the 4-device virtual CPU mesh (tests/conftest.py),
the port's on devices=[cpu] * 4: the same frames, from numpy, go to both.
Shards are compared block by block (slot ids differ between the
packages): the block coordinates of each shard and its counters exactly,
channels within RTOL/ATOL, the tolerance of tests/test_torch_fast.py
between the JAX package's own routes.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kimera_semantics_tpu import config as jcfg
from kimera_semantics_tpu.core.camera import PinholeIntrinsics
from kimera_semantics_tpu.core.color import LabelColorMap
from kimera_semantics_tpu.grid import blocks as jblocks
from kimera_semantics_tpu.io.dataset import SyntheticDataset
from kimera_semantics_tpu.models import common as jcommon
from kimera_semantics_tpu.models import projective as jproj_model
from kimera_semantics_tpu.ops import carve as jcarve
from kimera_semantics_tpu.ops import integrate as jinteg
from kimera_semantics_tpu.ops import mip as jmip
from kimera_semantics_tpu.ops import projective as jproj_ops
from kimera_semantics_tpu.parallel import sharding as jsh
from kimera_semantics_tpu.server import node as jnode

import kimera_semantics_tpu_torch as kt
from kimera_semantics_tpu_torch import config as tcfg
from kimera_semantics_tpu_torch import interop
from kimera_semantics_tpu_torch.grid import blocks as tblocks
from kimera_semantics_tpu_torch.io import dataset as tdataset
from kimera_semantics_tpu_torch.models import common as tcommon
from kimera_semantics_tpu_torch.models import fast as tfast
from kimera_semantics_tpu_torch.models import merged as tmerged
from kimera_semantics_tpu_torch.models import projective as tproj_model
from kimera_semantics_tpu_torch.ops import carve as tcarve
from kimera_semantics_tpu_torch.ops import integrate as tinteg
from kimera_semantics_tpu_torch.ops import mip as tmip
from kimera_semantics_tpu_torch.ops import projective as tproj_ops
from kimera_semantics_tpu_torch.parallel import multihost as tmh
from kimera_semantics_tpu_torch.parallel import sharding as tsh
from kimera_semantics_tpu_torch.server import node as tnode

# tests/test_sharding.py's sizes.
INTR = PinholeIntrinsics(fx=40.0, fy=40.0, cx=19.5, cy=14.5, width=40,
                         height=30)
TINTR = kt.PinholeIntrinsics(**INTR.__dict__)
D = 4
RTOL = ATOL = 1e-5
# The JAX package's kernel branch of the projective apply samples the
# atlas through bf16 hi/lo one-hot products (pallas_kernels.py), about
# 2e-5 relative from its plain branch at these sizes; the port follows
# the plain branch's arithmetic (tests/test_torch_projective.py).
KERNEL_BRANCH_TOL = 1e-4
COUNTERS = ("n_blocks", "overflow", "dropped_rays", "frame_counter")
CHANNELS = ("wsum", "wsdf", "sem_delta", "wcolor")


def configs(carve_mode="decimated", anti_grazing=False, **pipeline):
    return [m.FusionConfig(
        grid=m.GridConfig(voxel_size=0.25, voxels_per_side=8,
                          block_capacity=256),
        tsdf=m.TsdfConfig(truncation_distance=0.5, max_ray_length_m=8.0,
                          carve_mode=carve_mode,
                          enable_anti_grazing=anti_grazing),
        pipeline=m.PipelineConfig(max_rays=1280, dedup_table_size=1 << 12,
                                  **pipeline)) for m in (jcfg, tcfg)]



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This file's torch ops on one thread: its many small ops slow down
    tens of times when the test workers' thread pools share the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def N(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def frames():
    """Two steps of D frames: JAX frames and the port's, from numpy."""
    ds = SyntheticDataset(num_frames=2 * D, intr=INTR,
                          label_map=LabelColorMap.random())
    fs = [ds.frame(i) for i in range(2 * D)]
    tfs = [tcommon.Frame(*(torch.tensor(np.asarray(getattr(f, n)))
                           for n in tcommon.FRAME_FIELDS)) for f in fs]
    return fs, tfs


def jstack(fs):
    return jcommon.Frame(*(jnp.stack([getattr(f, n) for f in fs])
                           for n in tcommon.FRAME_FIELDS))


def cpu_mesh(**kw):
    return tsh.make_mesh(devices=[torch.device("cpu")] * D, **kw)


# (method, configs kwargs, JAX on its kernel branch)
CASES = {
    "fast": ("fast", {}, False),
    "fast-projective-carve": ("fast", dict(carve_mode="projective"), False),
    "merged": ("merged", {}, False),
    "merged-anti-grazing": ("merged", dict(anti_grazing=True), False),
    "projective-f32": ("projective", dict(wire_atlas="f32"), False),
    "projective-u16": ("projective", dict(wire_atlas="u16"), False),
    "projective-u16-kernel-branch": ("projective", dict(wire_atlas="u16"),
                                     True),
}


def jax_step(method, cj, fs, kernel_branch=False):
    """One JAX sharded step of D frames on the virtual mesh; its kernel
    branch runs the Pallas kernels interpreted (both FORCE_PALLAS_INTERPRET
    flags), with the jit caches cleared around it."""
    mesh = jsh.make_mesh(D)
    fns = (jsh.integrate_frames_sharded,
           jsh.integrate_frames_sharded_projective)
    jinteg.FORCE_PALLAS_INTERPRET = kernel_branch
    jproj_model.FORCE_PALLAS_INTERPRET = kernel_branch
    try:
        for fn in fns:
            fn.clear_cache()
        sg = jsh.create_sharded(cj, mesh)
        if method == "projective":
            sg = jsh.integrate_frames_sharded_projective(sg, jstack(fs), cj,
                                                         INTR, mesh)
        else:
            sg = jsh.integrate_frames_sharded(sg, jstack(fs), cj, INTR, mesh,
                                              method=method)
        return {n: np.asarray(getattr(sg, n)) for n in tblocks.FIELDS}
    finally:
        jinteg.FORCE_PALLAS_INTERPRET = False
        jproj_model.FORCE_PALLAS_INTERPRET = False
        for fn in fns:
            fn.clear_cache()


def port_step(method, ct, tfs, mesh=None):
    mesh = mesh or cpu_mesh()
    sg = tsh.create_sharded(ct, mesh)
    batch = tcommon.Frame.stack(tfs)
    if method == "projective":
        return tsh.integrate_frames_sharded_projective(sg, batch, ct, TINTR,
                                                       mesh)
    return tsh.integrate_frames_sharded(sg, batch, ct, TINTR, mesh,
                                        method=method)


@pytest.fixture(scope="module")
def jax_runs(frames):
    """Each JAX sharded result computed once."""
    fs, _ = frames
    memo = {}

    def run(case):
        if case not in memo:
            method, kw, kernel = CASES[case]
            memo[case] = jax_step(method, configs(**kw)[0], fs[:D], kernel)
        return memo[case]
    return run


def assert_shard_matches(ja, s, tg, cfg, tol=RTOL):
    """Shard s of a JAX stack (numpy fields) against a port grid: block
    set and counters exact, channels by coordinate within tol, counts
    exact."""
    for n in COUNTERS:
        assert int(getattr(tg, n)) == int(ja[n][s]), (s, n)
    nb = int(ja["n_blocks"][s])
    coords = ja["block_coords"][s][:nb]
    assert set(map(tuple, N(tg.block_coords)[:nb])) == set(map(tuple,
                                                                coords))
    st = N(tblocks.lookup_slots(tg, torch.tensor(coords), cfg.grid))
    for n in CHANNELS + ("sem_count",):
        a, b = ja[n][s], N(getattr(tg, n))
        a, b = (a[:, :nb], b[:, st]) if a.ndim == 3 else (a[:nb], b[st])
        if n == "sem_count":
            np.testing.assert_array_equal(b, a, err_msg=f"shard {s}")
        else:
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol,
                                       err_msg=f"shard {s} {n}")
    np.testing.assert_array_equal(N(tg.updated)[st], ja["updated"][s][:nb])
    return nb


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_jax(frames, jax_runs, case):
    _, tfs = frames
    method, kw, kernel = CASES[case]
    ct = configs(**kw)[1]
    ja = jax_runs(case)
    sg = port_step(method, ct, tfs[:D])
    tol = KERNEL_BRANCH_TOL if kernel else RTOL
    total = sum(assert_shard_matches(ja, s, sg[s], ct, tol) for s in range(D))
    assert total > 0 and sg.total("overflow") == 0
    seen = set()
    for g in sg:
        for c in map(tuple, N(g.block_coords)[:int(g.n_blocks)]):
            assert c not in seen, f"block {c} allocated on two shards"
            seen.add(c)


def test_sharded_interop_round_trip(frames, jax_runs):
    """A JAX sharded stack carried into the port shard by shard and back,
    field for field; one more port step then equals the JAX stack's next
    step."""
    fs, tfs = frames
    cj, ct = configs()
    ja = jax_runs("fast")
    mesh = cpu_mesh()
    sg = interop.sharded_from_numpy(ja, ct, mesh)
    back = interop.sharded_to_numpy(sg)
    for n in tblocks.FIELDS:
        np.testing.assert_array_equal(back[n], ja[n], err_msg=n)
    jmesh = jsh.make_mesh(D)
    jnext = jsh.integrate_frames_sharded(
        jblocks.VoxelGrid(**{n: jnp.asarray(ja[n]) for n in tblocks.FIELDS}),
        jstack(fs[D:]), cj, INTR, jmesh)
    jnext = {n: np.asarray(getattr(jnext, n)) for n in tblocks.FIELDS}
    tsh.integrate_frames_sharded(sg, tcommon.Frame.stack(tfs[D:]), ct,
                                 TINTR, mesh)
    for s in range(D):
        assert_shard_matches(jnext, s, sg[s], ct)


# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------

def to_jax_jobs(jobs):
    return jcarve.JobBatch(*(jnp.asarray(N(getattr(jobs, f)))
                             for f in tcarve.JOB_FIELDS))


def carried(cj, ct, jgrid):
    arrays = {n: np.asarray(getattr(jgrid, n)) for n in tblocks.FIELDS}
    return interop.grid_from_numpy(arrays, ct, device="cpu")


def assert_grid_equal_by_coords(jg, tg, cfg, tol=RTOL):
    ja = {n: np.asarray(getattr(jg, n))[None] for n in tblocks.FIELDS}
    return assert_shard_matches(ja, 0, tg, cfg, tol)


@pytest.fixture(scope="module")
def owned_jobs(frames):
    """One fast frame's band and carve job batches (port-made) and the JAX
    integrate_jobs with a traced shard id, compiled once."""
    _, tfs = frames
    cj, ct = configs()
    _, batches, _ = tfast._frame_batches(tblocks.create(ct, device="cpu"),
                                         tfs[0], ct, TINTR)
    S = [s for _, s in batches]
    jfn = jax.jit(lambda g, jobs, sid: jinteg.integrate_jobs(
        g, cj, list(zip(jobs, S)), shard_id=sid, num_shards=D))
    return batches, jfn


@pytest.mark.parametrize("shard", range(D))
def test_integrate_jobs_keeps_owned_blocks(owned_jobs, shard):
    cj, ct = configs()
    batches, jfn = owned_jobs
    jg = jfn(jblocks.create(cj), [to_jax_jobs(j) for j, _ in batches],
             jnp.int32(shard))
    sid = shard if shard % 2 else torch.tensor(shard, dtype=torch.int32)
    tg = tinteg.integrate_jobs(tblocks.create(ct, device="cpu"), ct, batches,
                               shard_id=sid, num_shards=D)
    assert assert_grid_equal_by_coords(jg, tg, ct) > 0
    keys = tblocks.bhash.pack_block_coords(
        tg.block_coords[:int(tg.n_blocks)], ct.grid.world_extent_blocks)
    assert bool(tinteg.owned(keys, shard, D).all())


@pytest.mark.parametrize("ag_frames", [2, 4])
def test_integrate_jobs_anti_grazing_frames(frames, ag_frames):
    """ag_frames frames' merged parts concatenated into one call, each
    frame's steps masked by its own bundle destinations only."""
    _, tfs = frames
    cj, ct = configs(anti_grazing=True)
    R = ct.pipeline.max_rays
    parts = []
    for b in range(ag_frames):
        g = tblocks.create(ct, device="cpu")
        _, batches, sem, _, bdest, _ = tmerged._frame_parts(
            g, tfs[b], ct, TINTR)
        parts.append((batches, sem, bdest))
    batches = [tfast._cat_jobs([p[0][k] for p in parts])
               for k in range(len(parts[0][0]))]
    sem = tuple(torch.cat([p[1][i] + b * R if i == 0 else p[1][i]
                           for b, p in enumerate(parts)]) for i in range(4))
    dest = torch.cat([p[2] for p in parts])
    S = [s for _, s in batches]
    jg = jax.jit(lambda g, jobs, sem, dest: jinteg.integrate_jobs(
        g, cj, list(zip(jobs, S)), sem_points=sem, ag_dest_voxels=dest,
        ag_own_bundle=True, ag_frames=ag_frames))(
            jblocks.create(cj), [to_jax_jobs(j) for j, _ in batches],
            tuple(jnp.asarray(N(x)) for x in sem), jnp.asarray(N(dest)))
    tg = tinteg.integrate_jobs(tblocks.create(ct, device="cpu"), ct, batches,
                               sem_points=sem, ag_dest_voxels=dest,
                               ag_own_bundle=True, ag_frames=ag_frames)
    assert assert_grid_equal_by_coords(jg, tg, ct) > 0


def test_frame_cube_with_shards(frames):
    """The cubes of 4 frames' origins around a grid carried from the JAX
    package: each shard's cells hold the slots of its own blocks and -1
    elsewhere."""
    from kimera_semantics_tpu.models import fast as jfast
    fs, _ = frames
    cj, ct = configs()
    jg = jblocks.create(cj)
    for f in fs[:2]:
        jg = jfast.integrate_frame(jg, f, cj, INTR)
    tg = carried(cj, ct, jg)
    origins = np.stack([np.asarray(f.T_G_C)[:3, 3] for f in fs[:D]])
    union = None
    for s in range(D):
        jv, jb = jinteg.frame_cube(jg, cj, jnp.asarray(origins), s, D)
        tv, tb = tinteg.frame_cube(tg, ct, torch.tensor(origins), s, D)
        np.testing.assert_array_equal(N(tv), np.asarray(jv))
        np.testing.assert_array_equal(N(tb), np.asarray(jb))
        own = N(tv) >= 0
        union = own if union is None else union + own
    all_v, _ = tinteg.frame_cube(tg, ct, torch.tensor(origins))
    np.testing.assert_array_equal(union, N(all_v) >= 0)
    assert union.max() == 1 and union.sum() > 0


def test_insert_candidates_with_shard(frames):
    _, tfs = frames
    cj, ct = configs()
    tplan = tproj_model.make_plan(ct, TINTR)
    atlas = tmip.build_atlas(tfs[0].depth, tfs[0].labels, tfs[0].colors,
                             tplan)
    keys, valid = tproj_model.candidates_from_atlas(atlas, tfs[0].T_G_C, ct,
                                                    TINTR, tplan)
    seen = set()
    for s in range(D):
        jg, jc, _, jr = jproj_model.insert_candidates(
            jblocks.create(cj), jnp.asarray(N(keys)), jnp.asarray(N(valid)),
            cj, shard=(s, D))
        tg, tc, _, tr = tproj_model.insert_candidates(
            tblocks.create(ct, device="cpu"), keys, valid, ct, shard=(s, D))
        assert int(tg.n_blocks) == int(jg.n_blocks) > 0
        assert int(tg.overflow) == int(jg.overflow) == 0
        got = set(map(tuple, N(tc)[N(tr)]))
        assert got == set(map(tuple, np.asarray(jc)[np.asarray(jr)]))
        assert not got & seen
        seen |= got


@pytest.fixture(scope="module")
def mixed_rows(frames):
    """Two frames' atlases and a mixed-frame row list of their touched
    blocks, on a grid carried from the JAX package."""
    fs, tfs = frames
    cj, ct = configs(wire_atlas="f32")
    plan = jmip.make_plan(INTR.height, INTR.width, cj.pipeline.patch_rows,
                          cj.pipeline.patch_cols)
    tplan = tproj_model.make_plan(ct, TINTR)
    atlases = jnp.stack([jmip.build_atlas(f.depth, f.labels, f.colors, plan)
                         for f in fs[:2]])
    jg = jblocks.create(cj)
    rows = []
    for b in range(2):
        jg, c, s, r = jproj_model.allocate_from_atlas(
            jg, atlases[b], fs[b].T_G_C, cj, INTR, plan)
        rows.append((np.full(c.shape[0], b, np.int32), np.asarray(c),
                     np.asarray(s), np.asarray(r)))
    fidx, coords, slots, real = (np.concatenate(x) for x in zip(*rows))
    poses = np.stack([np.asarray(f.T_G_C) for f in fs[:2]])
    return (cj, ct, plan, tplan, jg, np.asarray(atlases), poses, fidx,
            coords, slots, real)


def test_mixed_frame_helpers_match_jax(mixed_rows):
    (cj, ct, plan, tplan, _, atlases, poses, fidx, coords, _,
     real) = mixed_rows
    T_C_G = np.stack([np.linalg.inv(p) for p in poses]).astype(np.float32)
    Rk, tk = T_C_G[fidx, :3, :3], T_C_G[fidx, :3, 3]
    jm = jax.jit(lambda c, R, t: jproj_ops.block_patch_meta_rows(
        c, R, t, INTR, plan, cj.grid.block_size))(coords, Rk, tk)
    tm = tproj_ops.block_patch_meta_rows(
        torch.tensor(coords), torch.tensor(Rk)[:, None],
        torch.tensor(tk)[:, None], TINTR, tplan, ct.grid.block_size)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    lvl, u0l, v0, u0a = (np.asarray(x) for x in jm)
    jp = jax.jit(lambda a, f, u, v: jproj_ops.extract_patches_multi(
        a, f, u, v, plan))(atlases, fidx, u0a, v0)
    tp = tproj_ops.extract_patches_multi(torch.tensor(atlases),
                                         torch.tensor(fidx),
                                         torch.tensor(u0a), torch.tensor(v0),
                                         tplan)
    np.testing.assert_array_equal(N(tp), np.asarray(jp))
    jd = jax.jit(lambda f, c, r, a, p: jproj_ops.voxel_deltas_multi(
        f, c, r, a, p, INTR, plan, cj, "gather"))(fidx, coords, real,
                                                   atlases, poses)
    td = tproj_ops.voxel_deltas_multi(
        torch.tensor(fidx), torch.tensor(coords), torch.tensor(real),
        torch.tensor(atlases), torch.tensor(poses), TINTR, tplan, ct)
    assert float(np.asarray(jd["w"]).sum()) > 0
    for k in ("w", "wsdf", "sem", "wcolor"):
        np.testing.assert_allclose(N(td[k]), np.asarray(jd[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for k in ("cnt", "label"):
        np.testing.assert_array_equal(N(td[k]), np.asarray(jd[k]),
                                      err_msg=k)


def test_apply_rows_multi_matches_jax(mixed_rows):
    (cj, ct, plan, tplan, jg, atlases, poses, fidx, coords, slots,
     real) = mixed_rows
    tg = carried(cj, ct, jg)
    jg = jax.jit(lambda g, a, p, f, c, s, r: jproj_model.apply_rows_multi(
        g, a, p, f, c, s, r, cj, INTR, plan))(
            jg, atlases, poses, fidx, coords, slots, real)
    tproj_model.apply_rows_multi(
        tg, torch.tensor(atlases), torch.tensor(poses), torch.tensor(fidx),
        torch.tensor(coords), torch.tensor(slots), torch.tensor(real), ct,
        TINTR, tplan)
    nb = int(jg.n_blocks)
    for n in CHANNELS + ("sem_count",):
        a, b = np.asarray(getattr(jg, n)), N(getattr(tg, n))
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=n)
    np.testing.assert_array_equal(N(tg.updated), np.asarray(jg.updated))
    assert np.asarray(jg.wsum)[:nb].sum() > 0


# ---------------------------------------------------------------------------
# The pipeline, the mirror and the merge
# ---------------------------------------------------------------------------

def by_coords(grid, cfg):
    nb = int(grid.n_blocks)
    coords = grid.block_coords[:nb]
    order = np.lexsort(N(coords).T[::-1])
    s = tblocks.lookup_slots(grid, coords[order], cfg.grid).long()
    return N(coords[order]), {n: N(getattr(grid, n)[:, s] if
                                   getattr(grid, n).dim() == 3
                                   else getattr(grid, n)[s])
                              for n in CHANNELS + ("sem_count",)}


def test_pipeline_equals_direct_sharded(frames):
    """MultiHostPipeline.run over two steps against the direct sharded
    steps; merge_shards of either holds every shard's blocks once."""
    _, tfs = frames
    _, ct = configs()
    mesh = cpu_mesh()
    pipe = tmh.MultiHostPipeline(ct, TINTR, mesh)
    assert pipe.frames_per_step == D
    out = pipe.run(iter(tfs), max_steps=2)
    assert pipe.steps == 2
    sg = tsh.create_sharded(ct, mesh)
    for s in range(2):
        batch = tcommon.Frame.stack(tfs[s * D:(s + 1) * D])
        per_shard = tmh.local_batch_to_global(batch, mesh)
        assert len(per_shard) == D and torch.equal(per_shard[1].depth,
                                                   batch.depth[1])
        tsh.integrate_frames_sharded(sg, batch, ct, TINTR, mesh)
    for a, b in zip(out, sg):
        for n in tblocks.FIELDS:
            assert torch.equal(getattr(a, n), getattr(b, n)), n
    merged, mcfg = tsh.merge_shards(out, ct)
    assert mcfg.grid.block_capacity == D * ct.grid.block_capacity
    assert int(merged.n_blocks) == out.total("n_blocks") > 0
    cm, chm = by_coords(merged, mcfg)
    for g in out:
        c, ch = by_coords(g, ct)
        idx = [np.flatnonzero((cm == row).all(axis=1))[0] for row in c]
        for n in ch:
            a = chm[n][:, idx] if chm[n].ndim == 3 else chm[n][idx]
            np.testing.assert_array_equal(a, ch[n])


def test_mirror_sync_matches_merge(frames):
    """Two steps with an incremental mesh cycle after each: the mirror
    equals merge_shards, the incremental mesh a full extraction of the
    mirror, and an all-rows sync changes nothing."""
    from kimera_semantics_tpu_torch.ops import mesh as tmesh
    _, tfs = frames
    _, ct = configs()
    lm = kt.LabelColorMap.random(ct.grid.num_labels)
    pipe = tmh.MultiHostPipeline(ct, TINTR, cpu_mesh(), label_map=lm)
    pipe.step(tcommon.Frame.stack(tfs[:D]))
    m1 = pipe.update_mesh()
    assert not any(bool(g.updated.any()) for g in pipe.sgrid)
    pipe.step(tcommon.Frame.stack(tfs[D:]))
    m2 = pipe.update_mesh()
    assert m2.num_triangles >= m1.num_triangles > 0
    merged, mcfg = tsh.merge_shards(pipe.sgrid, ct)
    mirror = pipe.mirror.grid
    cm, chm = by_coords(merged, mcfg)
    ci, chi = by_coords(mirror, pipe.mirror.cfg)
    np.testing.assert_array_equal(ci, cm)
    for n in chm:
        np.testing.assert_array_equal(chi[n], chm[n], err_msg=n)
    full = tmesh.extract_mesh(mirror, pipe.mirror.cfg, label_map=lm)
    assert m2.num_triangles == full.num_triangles
    np.testing.assert_allclose(np.sort(m2.vertices.reshape(-1, 9), axis=0),
                               np.sort(full.vertices.reshape(-1, 9), axis=0),
                               atol=1e-5)
    grid, gcfg = pipe.full_grid()
    cf, chf = by_coords(grid, gcfg)
    np.testing.assert_array_equal(cf, cm)
    for n in chm:
        np.testing.assert_array_equal(chf[n], chm[n], err_msg=n)


def test_pipeline_rejects_an_unknown_method():
    _, ct = configs()
    with pytest.raises(ValueError):
        tmh.MultiHostPipeline(ct, TINTR, cpu_mesh(), method="bogus")
    with pytest.raises(ValueError):
        tsh.integrate_frames_sharded(None, None, configs("full")[1], TINTR,
                                     cpu_mesh(), method="merged")


def test_make_mesh_places_shards():
    mesh = cpu_mesh()
    assert mesh.size == D and mesh.n_local == D and mesh.world == 1
    assert [mesh.shard_index(i) for i in range(D)] == list(range(D))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA cards"):
            tsh.make_mesh(2)


# ---------------------------------------------------------------------------
# The gather through a process group
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("case", ["merged-anti-grazing", "projective-u16"])
def test_gather_through_a_process_group(frames, case, monkeypatch):
    """The step with its gathers through a one-process gloo group (bool
    flags and uint16 wire planes as bytes) equals the in-process step bit
    for bit."""
    import torch.distributed as dist
    _, tfs = frames
    method, kw, _ = CASES[case]
    ct = configs(**kw)[1]
    ref = port_step(method, ct, tfs[:D])
    dtypes = set()
    across = tsh._gather_across

    def spy(x, mesh):
        dtypes.add(x.dtype)
        return across(x, mesh)
    monkeypatch.setattr(tsh, "_gather_across", spy)
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = cpu_mesh()
        assert mesh.group is not None
        got = port_step(method, ct, tfs[:D], mesh)
    finally:
        dist.destroy_process_group()
    assert (torch.bool if method == "merged" else torch.uint16) in dtypes
    for a, b in zip(got, ref):
        for n in tblocks.FIELDS:
            assert torch.equal(getattr(a, n), getattr(b, n)), n


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    sys.path.insert(0, {repo!r})
    from kimera_semantics_tpu_torch import config as tcfg
    import kimera_semantics_tpu_torch as kt
    from kimera_semantics_tpu_torch.io.dataset import SyntheticDataset
    from kimera_semantics_tpu_torch.models.common import Frame
    from kimera_semantics_tpu_torch.parallel import multihost, sharding
    rank, port = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    multihost.initialize("gloo", "tcp://127.0.0.1:" + port, 2, rank)
    cfg = tcfg.FusionConfig(
        grid=tcfg.GridConfig(voxel_size=0.25, voxels_per_side=8,
                             block_capacity=256),
        tsdf=tcfg.TsdfConfig(truncation_distance=0.5, max_ray_length_m=8.0),
        pipeline=tcfg.PipelineConfig(max_rays=1280,
                                     dedup_table_size=1 << 12))
    intr = kt.PinholeIntrinsics(fx=40.0, fy=40.0, cx=19.5, cy=14.5,
                                width=40, height=30)
    ds = SyntheticDataset(num_frames=4, intr=intr,
                          label_map=kt.LabelColorMap.random(), device="cpu")
    mesh = sharding.make_mesh(devices=["cpu", "cpu"])
    pipe = multihost.MultiHostPipeline(cfg, intr, mesh, method={method!r})
    pipe.step(Frame.stack([ds.frame(rank * 2 + i) for i in range(2)]))
    # Every shard's totals, gathered across the processes.
    w = sharding.all_gather(mesh, [g.wsum.sum() for g in pipe.sgrid])[0]
    nb = sharding.all_gather(mesh, [g.n_blocks for g in pipe.sgrid])[0]
    print("RESULT", rank, " ".join(repr(float(x)) for x in w),
          " ".join(str(int(x)) for x in nb), flush=True)
    torch.distributed.destroy_process_group()
""")


@pytest.mark.parametrize("method", ["fast", "projective"])
def test_gloo_two_process_step(tmp_path, method):
    """Two processes of 2 CPU shards each: one step, its gathers across
    the processes; both ranks print the same global sums, which equal the
    one-process 4-shard step's. A hang fails the test."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=repo, method=method))
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    res = [line.split()[2:] for out, _ in outs
           for line in out.splitlines() if line.startswith("RESULT")]
    assert len(res) == 2 and res[0] == res[1]
    ds = tdataset.SyntheticDataset(num_frames=4, intr=TINTR,
                                   label_map=kt.LabelColorMap.random(),
                                   device="cpu")
    ref = port_step(method, configs()[1], [ds.frame(i) for i in range(D)])
    assert res[0] == ([repr(float(g.wsum.sum())) for g in ref]
                      + [str(int(g.n_blocks)) for g in ref])
    assert ref.total("n_blocks") > 0


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

SIM = ["sim-eval", "--num-viewpoints", "4", "--voxel-size", "0.25",
       "--voxels-per-side", "8", "--block-capacity", "256", "--truncation",
       "0.5", "--max-ray-length", "8.0", "--max-rays", "1280",
       "--devices", "4", "--mesh-out", ""]


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def assert_outputs_match(got, ref, exact, close):
    for k in exact:
        assert got[k] == ref[k], k
    for k in close:
        assert got[k] == pytest.approx(ref[k], rel=1e-5), k


def test_cli_sim_eval_devices_matches_jax(capsys):
    argv = SIM + ["--method", "fast"]
    jnode.main(argv)
    ref = last_json(capsys)
    got = tnode.main(argv + ["--device", "cpu"])
    assert last_json(capsys) == json.loads(json.dumps(got))
    assert_outputs_match(
        got, ref, ("devices", "frames", "blocks", "overflow", "dropped_rays",
                   "compared", "incremental_mesh_triangles"),
        ("rmse_tsdf", "mae_tsdf", "label_accuracy"))
    assert got["mesh_error"]["num"] == ref["mesh_error"]["num"] > 0
    assert got["mesh_error"]["mean"] == pytest.approx(
        ref["mesh_error"]["mean"], rel=1e-5)


def test_cli_batch_devices_matches_jax(tmp_path, capsys):
    ds = SyntheticDataset(num_frames=5, intr=INTR,
                          label_map=LabelColorMap.random())
    tdataset.save_directory_dataset(str(tmp_path / "d"), ds)
    argv = (["batch", str(tmp_path / "d")] + SIM[3:-2]
            + ["--method", "projective", "--mesh-out"])
    jnode.main(argv + [str(tmp_path / "j.ply")])
    ref = last_json(capsys)
    got = tnode.main(argv + [str(tmp_path / "t.ply"), "--device", "cpu"])
    assert_outputs_match(got, ref, ("frames", "devices", "triangles",
                                    "blocks", "overflow", "dropped_rays"),
                         ())
    assert got["frames"] == 4 and got["triangles"] > 0
    from kimera_semantics_tpu_torch.io import ply
    assert len(ply.read_ply(str(tmp_path / "t.ply"))[2]) == got["triangles"]


def test_cli_devices_on_cuda_needs_cards(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnode.main(SIM[:-4] + ["--devices", "2", "--device", "cuda",
                               "--mesh-out", ""])
