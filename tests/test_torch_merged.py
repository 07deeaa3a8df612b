"""The port's merged and simple integrators as a whole against the JAX
package: three frames, compared block by block with the JAX package's
kernel route (Pallas interpreted) and its default XLA route (CPU)."""

import numpy as np
import pytest
import torch

from kimera_semantics_tpu.models import merged as jmerged
from kimera_semantics_tpu.models import simple as jsimple

from kimera_semantics_tpu_torch.grid import blocks as tblocks
from kimera_semantics_tpu_torch.models import factory as tfactory
from kimera_semantics_tpu_torch.models import merged as tmerged
from kimera_semantics_tpu_torch.models import simple as tsimple

from test_torch_fast import (TINTR, assert_grids_match, assert_same_blocks,  # noqa: F401
                             configs, frames, run_jax, run_port)


@pytest.mark.parametrize("carve_mode,anti_grazing,stage_mode,route", [
    ("projective", False, "packed", "kernels"),
    ("projective", False, "packed", "xla"),
    # With informative carve jobs beside the bundles' votes, the JAX
    # package's packed staging gives the votes and the jobs' counts the same
    # ranks and adds two codes into one plane slot; the port ranks the votes
    # after the jobs' pairs (ROADMAP, faults of the reference). Its packed
    # result is held to the XLA route, and the kernel route is held in
    # dense staging, where the reference has no such collision.
    ("decimated", False, "dense", "kernels"),
    ("decimated", False, "packed", "xla"),
    ("projective", True, "dense", "kernels"),
    ("projective", True, "packed", "xla"),
    ("full", False, "packed", "kernels"),
])
def test_merged_matches_jax(frames, carve_mode, anti_grazing, stage_mode,
                            route):
    fs, tfs = frames
    cj, ct = configs(carve_mode, anti_grazing=anti_grazing,
                     sem_stage_mode=stage_mode)
    g = run_jax(jmerged, cj, fs, kernel_route=route == "kernels")
    tg = run_port(tmerged, ct, tfs)
    assert_grids_match(g, tg, ct)


def test_packed_staging_keeps_every_vote(frames):
    """Merged in carve_mode "decimated": the port's packed and dense staging
    give the same label counts and MLE labels."""
    _, tfs = frames
    grids = [run_port(tmerged, configs("decimated", sem_stage_mode=m)[1], tfs)
             for m in ("packed", "dense")]
    assert torch.equal(grids[0].sem_count, grids[1].sem_count)
    np.testing.assert_allclose(grids[0].sem_delta.numpy(),
                               grids[1].sem_delta.numpy(), rtol=1e-6,
                               atol=1e-5)
    seen = grids[0].wsum > 0
    assert torch.equal(tblocks.mle_labels(grids[0])[seen],
                       tblocks.mle_labels(grids[1])[seen])


@pytest.mark.parametrize("route", ["kernels", "xla"])
def test_simple_matches_jax(frames, route):
    fs, tfs = frames
    cj, ct = configs("full")
    g = run_jax(jsimple, cj, fs, kernel_route=route == "kernels")
    tg = run_port(tsimple, ct, tfs)
    assert_grids_match(g, tg, ct)


@pytest.mark.parametrize("kind,model", [("merged", tmerged),
                                        ("simple", tsimple)])
def test_objects_and_loops_are_sequential(frames, kind, model):
    _, tfs = frames
    _, ct = configs("projective")
    a = run_port(model, ct, tfs)
    integ = tfactory.create(kind, ct, TINTR, device="cpu")
    b = tblocks.create(ct, device="cpu")
    for f in tfs:
        b = integ.integrate(b, f)
    for name in ("wsum", "wsdf", "sem_count", "sem_delta", "n_blocks",
                 "dropped_rays"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    if kind == "merged":
        stacked = type(tfs[0])(*(torch.stack([getattr(f, n) for f in tfs])
                                 for n in ("depth", "labels", "colors",
                                           "T_G_C")))
        # One update stream for the three frames: the same blocks and
        # values, floats summed in another order.
        c = tmerged.integrate_frames(tblocks.create(ct, device="cpu"),
                                     stacked, ct, TINTR, device="cpu")
        assert_same_blocks(a, c, ct)


def test_default_device_is_the_card(frames):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tfs = frames
    _, ct = configs()
    grid = tblocks.create(ct, device="cpu")
    for model in (tmerged, tsimple):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.integrate_frame(grid, tfs[0], ct, TINTR)
