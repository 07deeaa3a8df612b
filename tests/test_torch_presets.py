"""The port's remaining deployments against the JAX package (CPU): the
euroc, uhumans2 and realsense presets, each package's configuration built
by its own node._build from the same `--preset` arguments, over two fast
frames of seeded numpy images; the simple integrator at the CLI's full
step budget (S 180) on a narrow frame; and the batch CLI's --map-in
continuation from a KSDV file and from a .vxblx, against the uninterrupted
run, in both packages.

Tolerances: integers exact (n_blocks, overflow, dropped_rays,
frame_counter, the block sets, sem_count, the observed voxels' MLE labels,
the updated flags); the hash tables slot for slot, since both packages
insert the same key streams and let the largest batch index win a
contested position; float channels within RTOL relative plus ATOL, as
tests/test_torch_fast.py holds them. A .vxblx holds dist and weight per
voxel and 8-bit colours, so a continuation from one holds the TSDF voxels
of the uninterrupted run within VXBLX_DIST_TOL m, weights exact.

The job batches a frame makes are held more loosely, within JOB_RTOL:
XLA:CPU decides per fusion, and by array size, whether `origin + unit *
t` and the pose products round once (a fused multiply-add) or twice, and
the port mirrors one form (core/fp.py). At these images and 0.05-0.1 m
voxels some ray ends then differ by an ulp, enough to move a DDA step into
the neighbouring voxel; so the grids are compared after both packages
integrate the JAX package's jobs."""

import contextlib
import dataclasses
import io
import json

import jax
import numpy as np
import pytest
import torch

from kimera_semantics_tpu.core.camera import PinholeIntrinsics as JIntr
from kimera_semantics_tpu.grid import blocks as jblocks
from kimera_semantics_tpu.models import common as jcommon
from kimera_semantics_tpu.models import fast as jfast
from kimera_semantics_tpu.ops import carve as jcarve
from kimera_semantics_tpu.ops import integrate as jinteg
from kimera_semantics_tpu.ops import pallas_kernels as jpallas
from kimera_semantics_tpu.server import node as jnode

from kimera_semantics_tpu_torch.core.camera import PinholeIntrinsics as TIntr
from kimera_semantics_tpu_torch.grid import blocks as tblocks
from kimera_semantics_tpu_torch.io import serial
from kimera_semantics_tpu_torch.models import common as tcommon
from kimera_semantics_tpu_torch.models import factory as tfactory
from kimera_semantics_tpu_torch.models import fast as tfast
from kimera_semantics_tpu_torch.models import simple as tsimple
from kimera_semantics_tpu_torch.ops import carve as tcarve
from kimera_semantics_tpu_torch.ops import integrate as tinteg
from kimera_semantics_tpu_torch.ops import kernels as tkernels
from kimera_semantics_tpu_torch.server import node as tnode

RTOL = ATOL = 1e-5
JOB_RTOL = 1e-5
VXBLX_DIST_TOL = 1e-6
W, H = 64, 48


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This file's torch ops on one thread: the test workers' thread pools
    share the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def N(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def intrinsics(width=W, height=H, f=64.0):
    kw = dict(fx=f, fy=f, cx=width / 2 - 0.5, cy=height / 2 - 0.5,
              width=width, height=height)
    return JIntr(**kw), TIntr(**kw)


def pose(i):
    """A camera at 1.5 m looking along +x, turning 4 degrees and moving
    5 cm a frame (camera axes x right, y down, z forward)."""
    a = np.deg2rad(4.0 * i)
    fwd = np.array([np.cos(a), np.sin(a), 0.0])
    right = np.array([np.sin(a), -np.cos(a), 0.0])
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2] = right, [0.0, 0.0, -1.0], fwd
    T[:3, 3] = [0.05 * i, 0.0, 1.5]
    return T


def images(seed, n, near, far, width=W, height=H, labelled=True):
    """n frames of seeded arrays: a tilted wall between `near` and `far`
    m with a bump, 2% invalid pixels, labels in 8x8 tiles (all 0 unless
    `labelled`) drawn from 6 of 1-21 a frame, among them the dynamic
    label 20 (6 labels at most reach a voxel in a frame, inside the packed
    staging's 8 ranks), colours smooth in the pixel plus noise."""
    rng = np.random.RandomState(seed)
    v, u = np.mgrid[0:height, 0:width].astype(np.float32)
    out = []
    for i in range(n):
        depth = (near + (far - near) * (u / width) ** 1.5
                 + 0.3 * np.sin(v / 5.0 + i) + rng.uniform(0, 0.02, u.shape))
        depth[rng.rand(*u.shape) < 0.02] = 0.0
        palette = np.append(rng.choice(np.arange(1, 20), 5, replace=False),
                            20)
        tiles = palette[rng.randint(0, 6, (height // 8 + 1, width // 8 + 1))]
        labels = np.kron(tiles, np.ones((8, 8), np.int32))[:height, :width]
        if not labelled:
            labels = np.zeros_like(labels)
        colors = np.stack([u * 255 / width, v * 255 / height,
                           rng.uniform(0, 255, u.shape)], -1)
        out.append((depth.astype(np.float32), labels.astype(np.int32),
                    np.round(colors).astype(np.float32), pose(i)))
    return out


def both_frames(arrays):
    jf = [jcommon.Frame(depth=d, labels=lab, colors=c, T_G_C=T)
          for d, lab, c, T in arrays]
    tf = [tcommon.frame_from_images(d, labels=lab, colors=c, T_G_C=T,
                                    device="cpu") for d, lab, c, T in arrays]
    return jf, tf


def jax_args(argv):
    """The JAX CLI's arguments for `argv`, parsed as its main() parses them
    (a preset's values as defaults that explicit flags override)."""
    import argparse
    from kimera_semantics_tpu.server import presets
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("batch")
    p.add_argument("dataset")
    jnode._add_common(p)
    args, _ = ap.parse_known_args(argv)
    if args.preset:
        presets.apply_preset(p, args.preset)
    return ap.parse_args(argv)


def both_configs(argv, **pipeline):
    """Each package's configuration from the same CLI arguments, each by
    its own node._build; the PipelineConfig fields in `pipeline` replaced
    in both."""
    out = []
    for node, parse in ((jnode, jax_args), (tnode, tnode.parse_args)):
        cfg, _ = node._build(parse(argv))
        if pipeline:
            cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
                cfg.pipeline, **pipeline))
        out.append(cfg)
    return out


def assert_grids_match(jg, tg, cfg, min_seen=500):
    """Counters, block sets and tables equal; channels by block coordinate:
    counts exact, floats within RTOL/ATOL, the observed voxels' MLE labels
    and the updated flags exact."""
    for name in ("n_blocks", "overflow", "dropped_rays", "frame_counter"):
        assert int(getattr(tg, name)) == int(getattr(jg, name)), name
    nb = int(jg.n_blocks)
    assert nb > 0 and int(jg.overflow) == 0
    for name in ("table_keys", "table_slots", "block_coords"):
        np.testing.assert_array_equal(N(getattr(tg, name)),
                                      N(getattr(jg, name)), err_msg=name)
    coords = N(jg.block_coords)[:nb]
    sj = np.arange(nb)
    st = N(tblocks.lookup_slots(tg, torch.tensor(coords), cfg.grid))
    np.testing.assert_array_equal(st, sj)

    def rows(grid, name, s):
        a = N(getattr(grid, name))
        return a[:, s] if a.ndim == 3 else a[s]
    for name in ("wsum", "wsdf", "sem_delta", "wcolor"):
        np.testing.assert_allclose(rows(tg, name, st), rows(jg, name, sj),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(rows(tg, "sem_count", st),
                                  rows(jg, "sem_count", sj))
    seen = rows(jg, "wsum", sj) > 0
    assert seen.sum() > min_seen
    # `jg` is a JAX grid, or a port grid read back from a JAX KSDV file
    mle = tblocks.mle_labels if torch.is_tensor(jg.wsum) else \
        jblocks.mle_labels
    np.testing.assert_array_equal(N(tblocks.mle_labels(tg))[st][seen],
                                  N(mle(jg))[sj][seen])
    np.testing.assert_array_equal(N(tg.updated)[st], N(jg.updated)[sj])


def jax_jobs_to_port(batches):
    return [(tcarve.JobBatch(**{f: torch.tensor(np.asarray(getattr(j, f)))
                                for f in tcarve.JOB_FIELDS}), int(S))
            for j, S in batches]


# Each preset at a small image, with its depth range and --block-capacity
# (x8 storage tiles; the frames take 13, 249 and 21): euroc (COLOR, no
# labels: the frames' labels are all unknown, as a metric-only bag's),
# uhumans2 (10 m rays: depths to 9 m, past its camera cube's limit, so
# both packages resolve the runs' slots by hash lookups) and realsense
# (2.5 m rays: most depths past them, so those rays only clear).
PRESETS = {"euroc": (0.6, 4.5, False, 8), "uhumans2": (2.0, 9.0, True, 48),
           "realsense": (0.4, 3.5, True, 8)}


# The ray, carve-job and segment budgets cut to the 64x48 frames (the
# streams' shapes follow the budgets, not the image).
SMALL_BUDGETS = dict(max_rays=4096, carve_budget=4096, segment_budget=1 << 16)


def preset_setup(name):
    near, far, labelled, capacity = PRESETS[name]
    jintr, tintr = intrinsics()
    cj, ct = both_configs(["batch", "unused", "--preset", name,
                           "--block-capacity", str(capacity)],
                          **SMALL_BUDGETS)
    assert ct.integrator.value == "fast"
    assert ct.grid.io_vps == 32 and ct.grid.voxels_per_side == 16
    return cj, ct, jintr, tintr, both_frames(
        images(7, 2, near, far, labelled=labelled))


def test_dda_matches_the_jax_kernel_at_preset_voxels():
    """K1's plain version against the JAX package's Pallas DDA kernel
    (interpreted, inside jit) on the band and carve jobs of a euroc frame:
    every integer plane exact, floats within RTOL/ATOL. XLA:CPU fuses the
    ray extent end * inv - start * inv into one multiply-add, and at
    0.05-0.1 m voxels the unfused form stepped into other voxels
    (ops/raycast.py dda_init)."""
    cj, ct, jintr, _, (jf, _) = preset_setup("euroc")
    _, batches, _ = jax.jit(lambda g, f: jfast._frame_batches(
        g, f, cj, jintr))(jblocks.create(cj), jf[0])
    for jobs, S in batches:
        S = int(S)
        args = [jax.numpy.asarray(getattr(jobs, f)).T
                for f in ("origin", "point", "start", "end")]
        args += [jobs.weight, jobs.valid]
        want = jax.jit(lambda *a: jpallas.dda_job_stream(
            cj, S, *a, interpret=True))(*args)
        got = tkernels.dda_job_stream_plain(
            ct, S, *(torch.tensor(np.asarray(a)) for a in args))
        for n, a, b in zip(("key", "local", "w", "wsdf", "wc", "valid",
                            "run_key", "run_idx"), got, want):
            if n in ("w", "wsdf", "wc"):
                np.testing.assert_allclose(N(a), np.asarray(b), rtol=RTOL,
                                           atol=ATOL, err_msg=n)
            else:
                np.testing.assert_array_equal(N(a), np.asarray(b).astype(
                    N(a).dtype), err_msg=n)


def assert_jobs_close(tjobs, jjobs):
    """The port's job batch against the JAX package's: labels and validity
    exact, float fields within JOB_RTOL (module docstring)."""
    for f in tcarve.JOB_FIELDS:
        a, b = N(getattr(tjobs, f)), np.asarray(getattr(jjobs, f))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=JOB_RTOL, atol=JOB_RTOL,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_frames_match_jax(name):
    """Two fast frames at the preset's configuration. Each package builds
    the frame's job batches (band and carve jobs; the port's held to the
    JAX package's within JOB_RTOL, its counters exact); then the JAX
    package's jobs go through both packages' integrate_jobs, and the grids
    must agree exactly as assert_grids_match holds them."""
    cj, ct, jintr, tintr, (jf, tf) = preset_setup(name)

    @jax.jit
    def jax_frame(g, f):
        g, batches, origin = jfast._frame_batches(g, f, cj, jintr)
        return (jinteg.integrate_jobs(g, cj, batches, cube_origin=origin),
                [j for j, _ in batches])
    jg, tg = jblocks.create(cj), tblocks.create(ct, device="cpu")
    for a, b in zip(jf, tf):
        jg, jjobs = jax_frame(jg, a)
        tg, tbatches, origin = tfast._frame_batches(tg, b, ct, tintr)
        for (tjobs, _), jjob in zip(tbatches, jjobs):
            assert_jobs_close(tjobs, jjob)
        tg = tinteg.integrate_jobs(tg, ct, jax_jobs_to_port(
            [(j, S) for j, (_, S) in zip(jjobs, tbatches)]),
            cube_origin=origin)
    assert_grids_match(jg, tg, ct)
    # uhumans2 has no camera cube (slots by hash lookups); euroc is metric
    # only: no vote moved a label, the colour channels moved.
    assert tkernels.cube_lut_supported(ct) == (name != "uhumans2")
    if name == "euroc":
        assert not N(tg.sem_delta).any() and N(tg.wcolor).any()


def test_simple_full_step_budget_matches_jax():
    """`--method simple` at the CLI's defaults: 0.05 m voxels and 5 m rays,
    so every ray walks up to S = 180 steps; two narrow 24x6 frames. Each
    package builds the frame's full jobs (the port's held to the JAX
    package's within JOB_RTOL); the JAX package's jobs then go through both
    packages' integrate_jobs with no camera cube (slots by hash lookups),
    as models/simple.py does, and the grids agree exactly."""
    jintr, tintr = intrinsics(24, 6, f=20.0)
    cj, ct = both_configs(["batch", "unused", "--method", "simple",
                           "--block-capacity", "256"])
    S = ct.resolved_max_steps()
    assert S == 180
    assert isinstance(tfactory.create("simple", ct, tintr, device="cpu"),
                      tsimple.SimpleSemanticTsdfIntegrator)
    jf, tf = both_frames(images(3, 2, 1.0, 6.0, 24, 6))

    def full_jobs(pkg, f, cfg, intr):
        common, carve = pkg
        (_, pts, origin, colors, labels, weights, valid,
         clearing) = common.prepare_points(f, intr, cfg)
        kept, pts, colors, labels, weights, clearing = common.compact(
            valid, cfg.pipeline.max_rays, pts, colors, labels, weights,
            clearing)
        return carve.full_jobs(origin[None, :] + 0 * pts, pts, weights,
                               labels, colors, clearing, kept, cfg)

    @jax.jit
    def jax_frame(g, f):
        jobs = full_jobs((jcommon, jcarve), f, cj, jintr)
        return jinteg.integrate_jobs(g, cj, [(jobs, S)]), jobs
    jg, tg = jblocks.create(cj), tblocks.create(ct, device="cpu")
    for a, b in zip(jf, tf):
        jg, jjobs = jax_frame(jg, a)
        assert_jobs_close(full_jobs((tcommon, tcarve), b, ct, tintr), jjobs)
        tg = tinteg.integrate_jobs(tg, ct, jax_jobs_to_port([(jjobs, S)]))
    assert_grids_match(jg, tg, ct, min_seen=2000)


MAP_ARGS = ["--voxel-size", "0.2", "--voxels-per-side", "8",
            "--block-capacity", "512", "--truncation", "0.4",
            "--mesh-out", ""]


def write_dir(path, arrays, first):
    path.mkdir()
    _, tintr = intrinsics()
    np.savez(path / "intrinsics.npz", fx=tintr.fx, fy=tintr.fy,
             cx=tintr.cx, cy=tintr.cy, width=tintr.width,
             height=tintr.height)
    for i, (d, lab, _, T) in enumerate(arrays):
        np.savez(path / f"frame_{first + i:05d}.npz", depth=d, labels=lab,
                 T_G_C=T)
    return str(path)


@pytest.fixture(scope="module")
def continuation(tmp_path_factory):
    """In each package: the uninterrupted batch over 4 frames, and batch
    --map-in over the last 2 from a KSDV file and from a .vxblx saved
    after the first 2. Returns {(package, run): grid} read back through
    the port's KSDV loader (both packages write the same bytes) and the
    port's configuration."""
    tmp = tmp_path_factory.mktemp("mapin")
    arrays = images(11, 4, 1.0, 5.0)
    d_all = write_dir(tmp / "all", arrays, 0)
    d_first = write_dir(tmp / "first", arrays[:2], 0)
    d_last = write_dir(tmp / "last", arrays[2:], 2)
    grids, cfg = {}, None
    for pkg, node, extra in (("jax", jnode, []),
                             ("port", tnode, ["--device", "cpu"])):
        def run(dataset, *flags):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                node.main(["batch", dataset, *MAP_ARGS, *extra, *flags])
            return json.loads(out.getvalue().strip().splitlines()[-1])
        p = lambda name: str(tmp / f"{pkg}_{name}")  # noqa: E731
        run(d_all, "--map-out", p("full.ksdv"))
        run(d_first, "--map-out", p("a.ksdv"))
        run(d_first, "--map-out", p("a.vxblx"))
        for src in ("ksdv", "vxblx"):
            out = run(d_last, "--map-in", p(f"a.{src}"), "--map-out",
                      p(f"b_{src}.ksdv"))
            assert out["frames"] == 2 and out["overflow"] == 0
        cfg, _ = tnode._build(tnode.parse_args(["batch", "u", *MAP_ARGS]))
        for run_name in ("full", "a", "b_ksdv", "b_vxblx"):
            grids[pkg, run_name] = serial.load_grid(p(f"{run_name}.ksdv"),
                                                    cfg, device="cpu")
    return grids, cfg


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_map_in_ksdv_equals_uninterrupted(continuation, pkg):
    """A KSDV file restores the grid and its table verbatim: the
    continuation equals the uninterrupted run in every field."""
    grids, _ = continuation
    a, b = grids[pkg, "b_ksdv"], grids[pkg, "full"]
    for name in tblocks.FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("run", ["full", "b_ksdv", "b_vxblx"])
def test_map_in_runs_match_jax(continuation, run):
    grids, cfg = continuation
    assert_grids_match(grids["jax", run], grids["port", run], cfg)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_map_in_vxblx_holds_the_tsdf_and_the_last_votes(continuation, pkg):
    """A .vxblx carries the TSDF layer only: the continuation from one
    holds the uninterrupted run's TSDF voxels by block coordinate (its
    rounding: dist within VXBLX_DIST_TOL m, weights exact), and only the
    last 2 frames' semantic counts."""
    grids, cfg = continuation
    c, u, a = grids[pkg, "b_vxblx"], grids[pkg, "full"], grids[pkg, "a"]
    g = cfg.grid
    nb = int(u.n_blocks)
    coords = u.block_coords[:nb]
    su = torch.arange(nb)
    sc = tblocks.lookup_slots(c, coords, g).long()
    sa = tblocks.lookup_slots(a, coords, g).long()
    have = sc < g.block_capacity
    # The reload keeps the blocks with an observed voxel; the others are
    # unobserved in the uninterrupted run too.
    assert not bool((u.wsum[su[~have]] > 0).any())
    su, sc, sa = su[have], sc[have], sa[have]
    assert int(c.n_blocks) == int(have.sum())
    assert torch.equal(c.wsum[sc], u.wsum[su])
    trunc = cfg.tsdf.truncation_distance
    du = tblocks.tsdf_distance(u, trunc)[su]
    dc = tblocks.tsdf_distance(c, trunc)[sc]
    seen = u.wsum[su] > 0
    assert float((du - dc).abs()[seen].max()) <= VXBLX_DIST_TOL
    zero = torch.zeros_like(a.sem_count[:1])
    a_cnt = torch.cat([a.sem_count, zero])[
        torch.where(sa < g.block_capacity, sa, a.sem_count.shape[0])]
    assert torch.equal(c.sem_count[sc], u.sem_count[su] - a_cnt)
    assert bool((c.sem_count[sc] > 0).any())
    assert int(c.frame_counter) == 2   # the .vxblx carries no counter
