"""The port's fast integrator as a whole against the JAX package: three
frames in each carve mode (projective with matched band density, decimated,
full), compared block by block with the JAX package's kernel route (its
Pallas kernels run interpreted, FORCE_PALLAS_INTERPRET) and with its default
XLA route; integrate_frames, the factory, the device rule and the grid
carried across packages (CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

from kimera_semantics_tpu import config as jcfg
from kimera_semantics_tpu.core.camera import PinholeIntrinsics
from kimera_semantics_tpu.core.color import LabelColorMap
from kimera_semantics_tpu.grid import blocks as jblocks
from kimera_semantics_tpu.io.dataset import SyntheticDataset
from kimera_semantics_tpu.models import fast as jfast
from kimera_semantics_tpu.ops import integrate as jinteg

import kimera_semantics_tpu_torch as kt
from kimera_semantics_tpu_torch import config as tcfg
from kimera_semantics_tpu_torch import interop
from kimera_semantics_tpu_torch.grid import blocks as tblocks
from kimera_semantics_tpu_torch.models import common as tcommon
from kimera_semantics_tpu_torch.models import factory as tfactory
from kimera_semantics_tpu_torch.models import fast as tfast

INTR = PinholeIntrinsics(fx=40.0, fy=40.0, cx=39.5, cy=29.5, width=80,
                         height=60)
TINTR = kt.PinholeIntrinsics(**INTR.__dict__)
# Float channels: relative, with an absolute floor for wsdf values that
# cancel to near zero (the tolerance of tests/test_carve.py between the
# JAX package's own routes).
RTOL = ATOL = 1e-5


def configs(carve_mode="projective", band_density="matched",
            anti_grazing=False, **pipeline):
    """tests/test_carve.py's configuration in both packages."""
    kw = dict(max_rays=2048, dedup_table_size=1 << 14, segment_budget=1 << 16,
              carve_budget=2048, carve_steps=16)
    kw.update(pipeline)
    return [m.FusionConfig(
        grid=m.GridConfig(voxel_size=0.2, voxels_per_side=8,
                          block_capacity=512),
        tsdf=m.TsdfConfig(truncation_distance=0.4, max_ray_length_m=4.0,
                          carve_mode=carve_mode, band_density=band_density,
                          enable_anti_grazing=anti_grazing),
        pipeline=m.PipelineConfig(**kw)) for m in (jcfg, tcfg)]


def N(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def to_port(f):
    return tcommon.frame_from_images(
        np.asarray(f.depth), labels=np.asarray(f.labels),
        colors=np.asarray(f.colors), T_G_C=np.asarray(f.T_G_C), device="cpu")


@pytest.fixture(scope="module")
def frames():
    ds = SyntheticDataset(num_frames=3, intr=INTR,
                          label_map=LabelColorMap.random(21))
    fs = [ds.frame(i) for i in range(3)]
    return fs, [to_port(f) for f in fs]


def run_jax(model, cfg, fs, kernel_route):
    """Three frames through the JAX integrator, on its kernel route
    (Pallas interpreted) or its default XLA route."""
    jinteg.FORCE_PALLAS_INTERPRET = kernel_route
    try:
        model.integrate_frame.clear_cache()
        g = jblocks.create(cfg)
        for f in fs:
            g = model.integrate_frame(g, f, cfg, INTR)
        return g
    finally:
        jinteg.FORCE_PALLAS_INTERPRET = False
        model.integrate_frame.clear_cache()


def run_port(model, cfg, fs):
    g = tblocks.create(cfg, device="cpu")
    for f in fs:
        g = model.integrate_frame(g, f, cfg, TINTR, device="cpu")
    return g


def assert_grids_match(g, tg, cfg):
    """Counters and block sets equal; channels compared by block
    coordinate: counts exact, floats within RTOL/ATOL, MLE labels exact
    where observed."""
    for name in ("n_blocks", "overflow", "dropped_rays", "frame_counter"):
        assert int(getattr(tg, name)) == int(getattr(g, name)), name
    nb = int(g.n_blocks)
    assert nb > 0 and int(g.overflow) == 0
    coords = N(g.block_coords)[:nb]
    assert (set(map(tuple, N(tg.block_coords)[:nb]))
            == set(map(tuple, coords)))
    sj = np.arange(nb)
    st = N(tblocks.lookup_slots(tg, torch.tensor(coords), cfg.grid))

    def rows(grid, name, s):
        a = N(getattr(grid, name))
        return a[:, s] if a.ndim == 3 else a[s]
    for name in ("wsum", "wsdf", "sem_delta", "wcolor"):
        np.testing.assert_allclose(rows(tg, name, st), rows(g, name, sj),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(rows(tg, "sem_count", st),
                                  rows(g, "sem_count", sj))
    seen = rows(g, "wsum", sj) > 0
    assert seen.sum() > 1000
    np.testing.assert_array_equal(N(tblocks.mle_labels(tg))[st][seen],
                                  N(jblocks.mle_labels(g))[sj][seen])
    np.testing.assert_array_equal(N(tg.updated)[st], N(g.updated)[sj])


@pytest.mark.parametrize("carve_mode", ["projective", "decimated", "full"])
@pytest.mark.parametrize("route", ["kernels", "xla"])
def test_three_frames_match_jax(frames, carve_mode, route):
    fs, tfs = frames
    cj, ct = configs(carve_mode)
    g = run_jax(jfast, cj, fs, kernel_route=route == "kernels")
    tg = run_port(tfast, ct, tfs)
    assert_grids_match(g, tg, ct)


def test_unstaged_apply_matches_jax(frames):
    """PipelineConfig.staged_apply False: the reduced segments go straight
    into the grid (the reference's plain scatter tail), not through K5."""
    fs, tfs = frames
    cj, ct = configs("decimated", staged_apply=False)
    assert_grids_match(run_jax(jfast, cj, fs, kernel_route=False),
                       run_port(tfast, ct, tfs), ct)


def assert_same_blocks(a, b, cfg):
    """Two port grids hold the same blocks and counters; channels agree by
    block coordinate (counts exact, floats within RTOL/ATOL)."""
    for name in ("n_blocks", "overflow", "dropped_rays", "frame_counter"):
        assert int(getattr(a, name)) == int(getattr(b, name)), name
    nb = int(a.n_blocks)
    coords = a.block_coords[:nb]
    sa = tblocks.lookup_slots(a, coords, cfg.grid).long()
    sb = tblocks.lookup_slots(b, coords, cfg.grid).long()
    assert bool((sb < cfg.grid.block_capacity).all()) and nb > 0
    for name in ("wsum", "wsdf", "sem_count", "sem_delta"):
        x, y = getattr(a, name), getattr(b, name)
        x, y = (x[:, sa], y[:, sb]) if x.dim() == 3 else (x[sa], y[sb])
        if name == "sem_count":
            assert torch.equal(x, y), name
        else:
            np.testing.assert_allclose(N(y), N(x), rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def test_integrate_frames_and_factory_are_sequential(frames):
    """The factory's integrator runs integrate_frame frame by frame;
    integrate_frames puts the frames' jobs in one update stream, whose
    grid holds the same blocks and values (floats summed in another
    order)."""
    _, tfs = frames
    _, ct = configs("decimated")
    a = run_port(tfast, ct, tfs)
    batched = tcommon.Frame(*(torch.stack([getattr(f, n) for f in tfs])
                              for n in ("depth", "labels", "colors", "T_G_C")))
    b = tfast.integrate_frames(tblocks.create(ct, device="cpu"), batched, ct,
                               TINTR, device="cpu")
    integ = tfactory.create("fast", ct, TINTR, device="cpu")
    assert isinstance(integ, tfast.FastSemanticTsdfIntegrator)
    c = tblocks.create(ct, device="cpu")
    for f in tfs:
        c = integ.integrate(c, f)
    for name in ("wsum", "wsdf", "sem_count", "sem_delta", "table_keys",
                 "n_blocks", "frame_counter", "dropped_rays"):
        assert torch.equal(getattr(a, name), getattr(c, name)), name
    assert_same_blocks(a, b, ct)


@pytest.mark.parametrize("kind", ["fast", "merged", "simple", "projective"])
def test_factory_creates_each_kind(kind):
    _, ct = configs()
    integ = tfactory.create(kind, ct, TINTR, device="cpu")
    assert type(integ).__module__.endswith("models." + kind)
    assert integ.cfg is ct and integ.device == torch.device("cpu")
    with pytest.raises(ValueError):
        tfactory.create("voxblox", ct, TINTR, device="cpu")


def test_carried_grid_keeps_the_ray_state(frames):
    """A JAX fast grid after two frames in carve_mode "full" crosses into
    the port with its start-voxel set, frame counter and dropped-ray count;
    one more frame in both packages then agrees slot for slot."""
    fs, tfs = frames
    cj, ct = (dataclasses.replace(c, tsdf=dataclasses.replace(
        c.tsdf, clear_checks_every_n_frames=4))
        for c in configs("full", max_rays=1024))
    g = run_jax(jfast, cj, fs[:2], kernel_route=True)
    arrays = {n: np.asarray(getattr(g, n)) for n in tblocks.FIELDS}
    assert (arrays["start_set"] != -1).any() and int(g.frame_counter) == 2
    assert int(g.dropped_rays) > 0
    tg = interop.grid_from_numpy(arrays, ct, device="cpu")
    out = interop.grid_to_numpy(tg)
    for name in ("start_set", "frame_counter", "dropped_rays"):
        np.testing.assert_array_equal(out[name], arrays[name], err_msg=name)
    g = run_jax_continue(jfast, cj, g, fs[2:])
    tg = tfast.integrate_frame(tg, tfs[2], ct, TINTR, device="cpu")
    out = interop.grid_to_numpy(tg)
    for name in ("start_set", "frame_counter", "dropped_rays", "table_keys",
                 "block_coords", "n_blocks", "overflow", "sem_count",
                 "updated"):
        np.testing.assert_array_equal(out[name], np.asarray(getattr(g, name)),
                                      err_msg=name)
    for name in ("wsum", "wsdf", "sem_delta"):
        np.testing.assert_allclose(out[name], np.asarray(getattr(g, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def run_jax_continue(model, cfg, g, fs):
    jinteg.FORCE_PALLAS_INTERPRET = True
    try:
        model.integrate_frame.clear_cache()
        for f in fs:
            g = model.integrate_frame(g, f, cfg, INTR)
        return g
    finally:
        jinteg.FORCE_PALLAS_INTERPRET = False
        model.integrate_frame.clear_cache()


def test_default_device_is_the_card(frames):
    """Without `device`, fast integrate_frame and the integrator objects
    ask for CUDA: they raise on a machine without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tfs = frames
    _, ct = configs()
    grid = tblocks.create(ct, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfast.integrate_frame(grid, tfs[0], ct, TINTR)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfactory.create("fast", ct, TINTR)
