"""The port's scan-to-map ICP (kimera_semantics_tpu_torch/ops/icp.py)
against the JAX package (CPU), on the JAX package's analytic semantic-SDF
grid of the eval world carried across with interop.py: sample_tsdf at
seeded points, the residuals and their Jacobian (the reference's
jax.jacfwd against the port's analytic trilinear gradient), align_to_map on
a perturbed view, the roll/pitch constraint and the min_match_ratio
rejection.

Tolerances: weights and masks exact; samples within 1e-6 m; Jacobian
entries within 1e-4 (gradients of order 1 times points within a few metres,
the two evaluations rounding in different orders); the refined pose within
1e-4 (rotation entries and metres) of the reference's, rms within 1e-5 m
and the match ratio within one point in a thousand.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kimera_semantics_tpu.config import (FusionConfig, GridConfig,
                                         PipelineConfig, TsdfConfig)
from kimera_semantics_tpu.core import transforms as jtransforms
from kimera_semantics_tpu.core.camera import PinholeIntrinsics, backproject
from kimera_semantics_tpu.ops import icp as jicp
from kimera_semantics_tpu.sim import render as sim_render
from kimera_semantics_tpu.sim import world as sim_world

from kimera_semantics_tpu_torch import config as tcfg
from kimera_semantics_tpu_torch import interop
from kimera_semantics_tpu_torch.grid import blocks as tblocks
from kimera_semantics_tpu_torch.ops import icp as ticp

INTR = PinholeIntrinsics(fx=50, fy=50, cx=31.5, cy=23.5, width=64, height=48)


def cfgs():
    """tests/test_icp.py's configuration in both packages."""
    cj = FusionConfig(
        grid=GridConfig(voxel_size=0.1, voxels_per_side=8,
                        block_capacity=2048),
        tsdf=TsdfConfig(truncation_distance=0.3),
        pipeline=PipelineConfig(max_rays=64, dedup_table_size=1 << 10))
    ct = tcfg.FusionConfig(
        grid=tcfg.GridConfig(voxel_size=0.1, voxels_per_side=8,
                             block_capacity=2048),
        tsdf=tcfg.TsdfConfig(truncation_distance=0.3),
        pipeline=tcfg.PipelineConfig(max_rays=64, dedup_table_size=1 << 10))
    return cj, ct


@pytest.fixture(scope="module")
def world_grids():
    cj, ct = cfgs()
    world = sim_world.default_eval_world()
    g = sim_world.generate_semantic_sdf(world, cj, (-4.2, -4.2, -0.4),
                                        (4.2, 4.2, 3.8))
    arr = {f: np.asarray(getattr(g, f)) for f in tblocks.FIELDS}
    return world, g, interop.grid_from_numpy(arr, ct, device="cpu"), cj, ct


def view(world, angle, dq, dt):
    """A rendered view's points and the pose perturbed by (dq, dt)."""
    T_true = sim_render.orbit_pose(angle)
    depth, _ = sim_render.render_depth_labels(world, T_true, INTR)
    pts_C, valid = backproject(depth, INTR)
    T_pert = jtransforms.compose(T_true, jtransforms.from_quat_trans(
        jnp.asarray(dq, jnp.float32), jnp.asarray(dt, jnp.float32)))
    return T_true, pts_C, valid, T_pert


def t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def test_sample_tsdf_matches_jax(world_grids):
    _, g, tg, cj, ct = world_grids
    rng = np.random.RandomState(0)
    pts = rng.uniform(-3.0, 3.0, (2048, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-0.2, 2.5, 2048)
    jd, jw = jicp.sample_tsdf(g, cj, jnp.asarray(pts))
    td, tw = ticp.sample_tsdf(tg, ct, torch.tensor(pts))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    assert (np.asarray(jw) > 0).sum() > 500


def test_jacobian_matches_jacfwd(world_grids):
    world, g, tg, cj, ct = world_grids
    _, pts_C, valid, T = view(world, 0.7, [0.0, 0.017, 0.0, 1.0],
                              [0.04, -0.03, 0.02])

    def residuals(xi):
        T_adj = jicp._exp_se3(xi) @ T
        pts = pts_C @ T_adj[:3, :3].T + T_adj[:3, 3]
        d, w = jicp.sample_tsdf(g, cj, pts)
        trunc = cj.tsdf.truncation_distance
        m = valid & (w > 1e-3) & (jnp.abs(d) < 0.9 * trunc)
        return jnp.where(m, d, 0.0), m
    xi0 = jnp.zeros(6, jnp.float32)
    jr, jm = residuals(xi0)
    jj = jax.jacfwd(lambda x: residuals(x)[0])(xi0)
    r, m, jac, _ = ticp.residual_jacobian(tg, ct, t(pts_C), t(valid),
                                          t(T))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert m.sum() > 300
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=1e-6)
    np.testing.assert_allclose(jac.numpy(), np.asarray(jj), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(ticp._exp_se3(torch.tensor(
        [0.01, -0.02, 0.03, 0.1, 0.2, 0.3])).numpy(),
        np.asarray(jicp._exp_se3(jnp.asarray(
            [0.01, -0.02, 0.03, 0.1, 0.2, 0.3], jnp.float32))), atol=1e-7)


@pytest.mark.parametrize("rounds", [ticp.LOOKUP_ROUNDS, 1])
def test_align_matches_jax(world_grids, rounds, monkeypatch):
    """align_to_map from a perturbed view lands where the reference's does
    (with one probe round, every lookup is incomplete and the alignment is
    redone with complete lookups: the same result)."""
    world, g, tg, cj, ct = world_grids
    T_true, pts_C, valid, T_pert = view(world, 0.7, [0.0, 0.017, 0.0, 1.0],
                                        [0.04, -0.03, 0.02])
    jT, jrms, jratio = jicp.align_to_map(g, cj, pts_C, valid, T_pert,
                                         iters=10)
    monkeypatch.setattr(ticp, "LOOKUP_ROUNDS", rounds)
    T, rms, ratio = ticp.align_to_map(tg, ct, t(pts_C), t(valid), t(T_pert),
                                      iters=10)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-4)
    assert float(rms) == pytest.approx(float(jrms), abs=1e-5)
    assert float(ratio) == pytest.approx(float(jratio), abs=1e-3)
    # and it did what the reference's test asks of it
    _, rms_init, _ = ticp.align_to_map(tg, ct, t(pts_C), t(valid),
                                       t(T_pert), iters=1)
    assert float(rms) < 0.5 * float(rms_init)
    pre = np.linalg.norm(np.asarray(T_pert)[:3, 3] - np.asarray(T_true)[:3, 3])
    post = np.linalg.norm(T.numpy()[:3, 3] - np.asarray(T_true)[:3, 3])
    assert post < pre * 1.2


def test_refine_roll_pitch_false_keeps_gravity(world_grids):
    world, g, tg, cj, ct = world_grids
    _, pts_C, valid, T_pert = view(world, 1.1, [0.0, 0.0, 0.02, 1.0],
                                   [0.03, -0.02, 0.01])
    T, _, _ = ticp.align_to_map(tg, ct, t(pts_C), t(valid), t(T_pert),
                                iters=8, refine_roll_pitch=False)
    jT, _, _ = jicp.align_to_map(g, cj, pts_C, valid, T_pert, iters=8,
                                 refine_roll_pitch=False)
    gz_in = np.asarray(T_pert)[2, :3]
    gz_out = T.numpy()[2, :3]
    np.testing.assert_allclose(gz_out[2], gz_in[2], atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(gz_out), 1.0, atol=1e-5)
    assert np.linalg.norm(T.numpy()[:3, 3] - np.asarray(T_pert)[:3, 3]) > 1e-4
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-4)


def test_min_match_ratio_rejects_degenerate(world_grids):
    _, g, tg, cj, ct = world_grids
    rng = np.random.RandomState(1)
    pts = rng.uniform(40.0, 50.0, (512, 3)).astype(np.float32)
    valid = np.ones(512, bool)
    T, _, ratio = ticp.align_to_map(tg, ct, torch.tensor(pts),
                                    torch.tensor(valid), torch.eye(4),
                                    iters=6, min_match_ratio=0.1)
    _, _, jratio = jicp.align_to_map(g, cj, jnp.asarray(pts),
                                     jnp.asarray(valid),
                                     jnp.eye(4, dtype=jnp.float32), iters=6,
                                     min_match_ratio=0.1)
    assert float(ratio) == float(jratio) < 0.1
    np.testing.assert_array_equal(T.numpy(), np.eye(4, dtype=np.float32))
