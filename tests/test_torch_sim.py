"""The port's synthetic world, renderer and dataset against the JAX
package's (CPU)."""

import numpy as np
import jax
import pytest
import jax.numpy as jnp
import torch

from kimera_semantics_tpu.core.camera import PinholeIntrinsics
from kimera_semantics_tpu.core.color import LabelColorMap
from kimera_semantics_tpu.io.dataset import SyntheticDataset
from kimera_semantics_tpu.sim import render as jrender
from kimera_semantics_tpu.sim import world as jworld

import kimera_semantics_tpu_torch as kt
from kimera_semantics_tpu_torch.io.dataset import SyntheticDataset as TDataset
from kimera_semantics_tpu_torch.sim import render as trender
from kimera_semantics_tpu_torch.sim import world as tworld

INTR = PinholeIntrinsics(fx=60.0, fy=60.0, cx=39.5, cy=29.5, width=80,
                         height=60)
TINTR = kt.PinholeIntrinsics(**INTR.__dict__)


def N(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def test_world_sdf_matches():
    jw, tw = jworld.default_eval_world(), tworld.default_eval_world()
    for f in ("kind", "center", "params", "label"):
        np.testing.assert_array_equal(N(getattr(tw, f)), N(getattr(jw, f)))
    b = jworld.WorldBuilder().add_cylinder((1.0, 1.0, 0.5), 0.5, 1.0)
    b.add_cube((0.0, 0.0, 0.0), (1.0, 2.0, 0.5), label=7)
    b2 = tworld.WorldBuilder().add_cylinder((1.0, 1.0, 0.5), 0.5, 1.0)
    b2.add_cube((0.0, 0.0, 0.0), (1.0, 2.0, 0.5), label=7)
    pts = np.random.RandomState(0).uniform(-5, 5, (4000, 3)).astype(
        np.float32)
    for jw, tw in ((jw, tw), (b.build(), b2.build())):
        dj, lj = jax.jit(jworld.world_sdf)(jw, pts)
        dt, lt = tworld.world_sdf(tw, torch.from_numpy(pts))
        # float32 sums in another order: 1e-5
        np.testing.assert_allclose(N(dt), N(dj), rtol=1e-5, atol=1e-5)
        assert (N(lt) == N(lj)).mean() > 0.999


def test_render_matches():
    """Depth within 1e-4 m on pixels both hit; labels equal on >= 99.9% of
    pixels (a silhouette pixel may step differently)."""
    jw, tw = jworld.default_eval_world(), tworld.default_eval_world()
    for angle in (0.3, 2.0):
        T = trender.orbit_pose(angle)
        np.testing.assert_array_equal(T, N(jrender.orbit_pose(angle)))
        dj, lj = jrender.render_depth_labels(jw, jnp.asarray(T), INTR)
        dt, lt = trender.render_depth_labels(tw, torch.from_numpy(T), TINTR)
        dj, dt = N(dj), N(dt)
        hit = (dj > 0) & (dt > 0)
        assert hit.mean() > 0.9
        assert ((dj > 0) == (dt > 0)).mean() > 0.999
        np.testing.assert_allclose(dt[hit], dj[hit], atol=1e-4)
        assert (N(lt) == N(lj)).mean() >= 0.999


def test_synthetic_dataset_matches():
    lm = LabelColorMap.random()
    a = SyntheticDataset(num_frames=8, intr=INTR, label_map=lm)
    b = TDataset(num_frames=8, intr=TINTR,
                 label_map=kt.LabelColorMap.random(), device="cpu")
    assert len(b) == 8
    fa, fb = a.frame(3), b.frame(3)
    np.testing.assert_array_equal(N(fb.T_G_C), N(fa.T_G_C))
    same = N(fb.labels) == N(fa.labels)
    assert same.mean() >= 0.999
    np.testing.assert_array_equal(N(fb.colors)[same], N(fa.colors)[same])
    assert fb.depth.dtype == torch.float32 and fb.labels.dtype == torch.int32


def test_generate_semantic_sdf_matches():
    """The ground-truth grid over an AABB: the same tables (the blocks are
    inserted in the same order), weights, and distances within the world
    SDF's 1e-5; labels and their votes where both packages pick the same
    nearest object (world_sdf's ties aside); num_objects."""
    from kimera_semantics_tpu import config as jcfg
    from kimera_semantics_tpu_torch import config as tcfg
    cj, ct = (m.FusionConfig(
        grid=m.GridConfig(voxel_size=0.25, voxels_per_side=8,
                          block_capacity=256),
        tsdf=m.TsdfConfig(truncation_distance=0.5))
        for m in (jcfg, tcfg))
    jw, tw = jworld.default_eval_world(), tworld.default_eval_world()
    assert tw.num_objects == jw.num_objects > 0
    lo, hi = (-2.0, -2.0, -0.5), (2.0, 2.0, 1.5)
    g = jworld.generate_semantic_sdf(jw, cj, lo, hi, gt_weight=2.0)
    tg = tworld.generate_semantic_sdf(tw, ct, lo, hi, gt_weight=2.0,
                                      device="cpu")
    for name in ("table_keys", "table_slots", "block_coords", "n_blocks",
                 "overflow", "wsum", "sem_count", "updated"):
        np.testing.assert_array_equal(N(getattr(tg, name)),
                                      N(getattr(g, name)), err_msg=name)
    np.testing.assert_allclose(N(tg.wsdf), N(g.wsdf), rtol=1e-5, atol=2e-5)
    same = (N(tg.sem_delta) == N(g.sem_delta)).all(axis=0)
    assert same.mean() > 0.999
    with pytest.raises(ValueError):
        tworld.generate_semantic_sdf(tw, ct, (-9.0,) * 3, (9.0,) * 3,
                                     device="cpu")

