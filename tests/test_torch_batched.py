"""The port's one-stream batched integrate_frames against the JAX
package's (CPU): fast in carve_mode "projective" (on the JAX package's
kernel route, Pallas interpreted, and its XLA route), "decimated" and
"full", and merged in the two banded modes; B frames' jobs in one
integrate_jobs call, compared block by block with tests/test_torch_fast.py's
tolerance, counters exact.

Merged is held to the JAX package's sequential frames with that tolerance
and to its batched form within BATCHED_TOL, the JAX package's own
tolerance between its batched and sequential merged results
(tests/test_models.py): at one voxel of these frames its batched form
is 7e-5 relative from its sequential form, which the port's batched form
matches within 1e-7."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kimera_semantics_tpu.grid import blocks as jblocks
from kimera_semantics_tpu.models import common as jcommon
from kimera_semantics_tpu.models import fast as jfast
from kimera_semantics_tpu.models import merged as jmerged
from kimera_semantics_tpu.ops import integrate as jinteg

from kimera_semantics_tpu_torch.grid import blocks as tblocks
from kimera_semantics_tpu_torch.models import common as tcommon
from kimera_semantics_tpu_torch.models import fast as tfast
from kimera_semantics_tpu_torch.models import merged as tmerged
from kimera_semantics_tpu_torch.ops import kernels

from test_torch_fast import (INTR, N, TINTR, assert_grids_match,  # noqa: F401
                             configs, frames, run_jax)

BATCHED_TOL = 1e-4



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This file's torch ops on one thread: its many small ops slow down
    tens of times when the test workers' thread pools share the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def run_jax_batched(model, cfg, fs, kernel_route):
    jinteg.FORCE_PALLAS_INTERPRET = kernel_route
    try:
        model.integrate_frames.clear_cache()
        stacked = jcommon.Frame(*(jnp.stack([getattr(f, n) for f in fs])
                                  for n in tcommon.FRAME_FIELDS))
        return model.integrate_frames(jblocks.create(cfg), stacked, cfg,
                                      INTR)
    finally:
        jinteg.FORCE_PALLAS_INTERPRET = False
        model.integrate_frames.clear_cache()


@pytest.mark.parametrize("model_name,carve_mode,route", [
    ("fast", "projective", "kernels"),
    ("fast", "projective", "xla"),
    ("fast", "decimated", "xla"),
    ("fast", "full", "xla"),
    ("merged", "projective", "xla"),
    ("merged", "decimated", "xla"),
])
def test_batched_matches_jax(frames, model_name, carve_mode, route):
    fs, tfs = frames
    jmodel, tmodel = {"fast": (jfast, tfast),
                      "merged": (jmerged, tmerged)}[model_name]
    cj, ct = configs(carve_mode)
    g = run_jax_batched(jmodel, cj, fs, kernel_route=route == "kernels")
    kernels.reset_launches()
    tg = tmodel.integrate_frames(tblocks.create(ct, device="cpu"),
                                 tcommon.Frame.stack(tfs), ct, TINTR,
                                 device="cpu")
    assert not any(kernels.launches.values())    # plain versions on the CPU
    if model_name == "fast":
        assert_grids_match(g, tg, ct)
        return
    assert_grids_match(run_jax(jmodel, cj, fs, kernel_route=False), tg, ct)
    for name in ("n_blocks", "overflow", "dropped_rays", "frame_counter"):
        assert int(getattr(tg, name)) == int(getattr(g, name)), name
    nb = int(g.n_blocks)
    coords = N(g.block_coords)[:nb]
    st = N(tblocks.lookup_slots(tg, torch.tensor(coords), ct.grid))
    for name in ("wsum", "wsdf", "sem_count", "sem_delta"):
        a, b = N(getattr(g, name)), N(getattr(tg, name))
        a, b = (a[:, :nb], b[:, st]) if a.ndim == 3 else (a[:nb], b[st])
        np.testing.assert_allclose(b, a, rtol=BATCHED_TOL, atol=BATCHED_TOL,
                                   err_msg=name)


def test_batched_rows_scale_with_the_frames(frames, monkeypatch):
    """A batched fast dispatch stages block_budget x B rows for K5 (one
    cube per frame), where one frame stages block_budget."""
    _, tfs = frames
    _, ct = configs("projective")
    seen = []
    real = kernels.block_rmw_add

    def spy(*a, **kw):
        seen.append(a[5].shape[0])
        return real(*a, **kw)
    monkeypatch.setattr(kernels, "block_rmw_add", spy)
    cubes = []
    real_cube = kernels.slot_resolve_stream

    def cube_spy(cfg, cube_vals, *a, **kw):
        cubes.append(cube_vals.shape[0])
        return real_cube(cfg, cube_vals, *a, **kw)
    monkeypatch.setattr(kernels, "slot_resolve_stream", cube_spy)
    tfast.integrate_frames(tblocks.create(ct, device="cpu"),
                           tcommon.Frame.stack(tfs), ct, TINTR, device="cpu")
    bb = ct.pipeline.block_budget
    # The dense carves' K3 is fused (no K5); the band stream's K5 stages
    # 3 frames' rows and its K6 resolves against 3 cubes.
    assert seen == [min(3 * bb, ct.grid.block_capacity)] and cubes == [3]


def test_merged_batched_needs_a_banded_mode(frames):
    _, tfs = frames
    for kw in (dict(carve_mode="full"), dict(anti_grazing=True)):
        _, ct = configs(**kw)
        assert not tmerged.batchable(ct)
        with pytest.raises(ValueError, match="banded carve mode"):
            tmerged.integrate_frames(tblocks.create(ct, device="cpu"),
                                     tcommon.Frame.stack(tfs), ct, TINTR,
                                     device="cpu")
    assert tmerged.batchable(configs("decimated")[1])
    np.testing.assert_array_equal(
        tcommon.Frame.stack(tfs).at(1).depth.numpy(), tfs[1].depth.numpy())
    assert torch.equal(tcommon.Frame.stack(tfs).depth[2], tfs[2].depth)
