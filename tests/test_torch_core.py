"""PyTorch port vs the JAX package: config, core geometry, per-voxel math,
the DDA and the mip atlas, on the same numpy inputs (CPU).

Integer results must agree exactly; float results are held to the
tolerance stated at each assertion (0 where the port reproduces the
reference's float32 rounding operation for operation)."""

import dataclasses
import enum
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kimera_semantics_tpu import config as jcfg
from kimera_semantics_tpu.core import camera as jcam
from kimera_semantics_tpu.core import color as jcolor
from kimera_semantics_tpu.core import transforms as jtr
from kimera_semantics_tpu.ops import mip as jmip
from kimera_semantics_tpu.ops import raycast as jray
from kimera_semantics_tpu.ops import tsdf as jtsdf

from kimera_semantics_tpu_torch import config as tcfg
from kimera_semantics_tpu_torch.core import camera as tcam
from kimera_semantics_tpu_torch.core import color as tcolor
from kimera_semantics_tpu_torch.core import transforms as ttr
from kimera_semantics_tpu_torch.ops import mip as tmip
from kimera_semantics_tpu_torch.ops import raycast as tray
from kimera_semantics_tpu_torch.ops import tsdf as ttsdf


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def jit(fn, *args, **static):
    """Run a JAX reference function compiled, as the JAX integrators run it
    (XLA then fuses and contracts the float32 arithmetic the way the port
    reproduces)."""
    return jax.jit(functools.partial(fn, **static))(*args)


def random_pose(rng):
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    x, y, z, w = q
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                   2 * (x * z + y * w)],
                  [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                   2 * (y * z - x * w)],
                  [2 * (x * z - y * w), 2 * (y * z + x * w),
                   1 - 2 * (x * x + y * y)]])
    Tm = np.eye(4, dtype=np.float32)
    Tm[:3, :3] = R
    Tm[:3, 3] = rng.uniform(-3, 3, 3)
    return Tm


def test_config_fields_and_defaults_equal():
    for name in ("GridConfig", "TsdfConfig", "SemanticConfig",
                 "PipelineConfig", "FusionConfig"):
        a, b = getattr(jcfg, name), getattr(tcfg, name)
        fa = [(f.name, f.default, f.default_factory is dataclasses.MISSING)
              for f in dataclasses.fields(a)]
        fb = [(f.name, f.default, f.default_factory is dataclasses.MISSING)
              for f in dataclasses.fields(b)]
        assert [f[0] for f in fa] == [f[0] for f in fb], name
        for (n, da, _), (_, db, _) in zip(fa, fb):
            if isinstance(da, enum.Enum):
                assert da.name == db.name, (name, n)
            else:
                assert da == db, (name, n)
    for enum_name in ("ColorMode", "IntegratorType"):
        assert ([(m.name, m.value) for m in getattr(jcfg, enum_name)]
                == [(m.name, m.value) for m in getattr(tcfg, enum_name)])
    assert jcfg.UNKNOWN_LABEL == tcfg.UNKNOWN_LABEL
    assert jcfg.DEFAULT_UNIFORM_LOG_PRIOR == tcfg.DEFAULT_UNIFORM_LOG_PRIOR
    g = tcfg.GridConfig(voxel_size=0.05, voxels_per_side=16,
                        block_capacity=4096)
    gj = jcfg.GridConfig(voxel_size=0.05, voxels_per_side=16,
                         block_capacity=4096)
    for prop in ("padded_rows", "vps3", "block_size", "table_size"):
        assert getattr(g, prop) == getattr(gj, prop), prop


def test_transforms_match_exactly():
    rng = np.random.RandomState(0)
    a, b = random_pose(rng), random_pose(rng)
    pts = rng.uniform(-5, 5, (4096, 3)).astype(np.float32)
    # float32 rounding reproduced operation for operation: exact
    np.testing.assert_array_equal(N(ttr.inverse(T(a))), N(jit(jtr.inverse, a)))
    np.testing.assert_array_equal(N(ttr.apply(T(a), T(pts))),
                                  N(jit(jtr.apply, a, pts)))
    np.testing.assert_array_equal(N(ttr.compose(T(a), T(b))),
                                  N(jit(jtr.compose, a, b)))
    np.testing.assert_array_equal(N(ttr.translation(T(a))), a[:3, 3])
    q = rng.randn(4).astype(np.float32)
    t = rng.randn(3).astype(np.float32)
    # the quaternion path is not on the main path: 1e-6
    np.testing.assert_allclose(N(ttr.from_quat_trans(T(q), T(t))),
                               N(jit(jtr.from_quat_trans, q, t)), atol=1e-6)


def test_backproject_and_validity_match():
    rng = np.random.RandomState(1)
    intr_j = jcam.PinholeIntrinsics(fx=61.0, fy=59.0, cx=39.5, cy=29.5,
                                    width=80, height=60)
    intr_t = tcam.PinholeIntrinsics(**intr_j.__dict__)
    depth = rng.uniform(0.0, 12.0, (60, 80)).astype(np.float32)
    depth[rng.rand(60, 80) < 0.1] = 0.0
    depth[0, :4] = [np.nan, np.inf, -1.0, 0.05]
    pj, vj = jit(jcam.backproject, depth, intr=intr_j)
    pt, vt = tcam.backproject(T(depth), intr_t)
    np.testing.assert_array_equal(N(pt), N(pj))
    np.testing.assert_array_equal(N(vt), N(vj))
    cfg = jcfg.TsdfConfig(max_ray_length_m=8.0)
    for allow_clear in (True, False):
        cj = dataclasses.replace(cfg, allow_clear=allow_clear)
        ct = tcfg.TsdfConfig(max_ray_length_m=8.0, allow_clear=allow_clear)
        a, b = jit(jtsdf.point_validity, pj, cfg=cj)
        c, d = ttsdf.point_validity(pt, ct)
        np.testing.assert_array_equal(N(c), N(a))
        np.testing.assert_array_equal(N(d), N(b))


@pytest.mark.parametrize("dropoff", [True, False])
def test_update_terms_match(dropoff):
    rng = np.random.RandomState(2)
    sdf = rng.uniform(-0.7, 0.7, 20000).astype(np.float32)
    w = rng.uniform(0.0, 3.0, 20000).astype(np.float32)
    cj = jcfg.TsdfConfig(truncation_distance=0.3, use_weight_dropoff=dropoff)
    ct = tcfg.TsdfConfig(truncation_distance=0.3, use_weight_dropoff=dropoff)
    a = jit(jtsdf.update_terms, sdf, w, cfg=cj, voxel_size=0.07)
    b = ttsdf.update_terms(T(sdf), T(w), ct, 0.07)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(N(y), N(x))


@pytest.mark.parametrize("carving", [True, False])
def test_setup_rays_and_traverse_match(carving):
    rng = np.random.RandomState(3)
    R = 1024
    origin = rng.uniform(-1, 1, 3).astype(np.float32)
    pts = (origin + rng.uniform(-9, 9, (R, 3))).astype(np.float32)
    clearing = rng.rand(R) < 0.3
    kw = dict(voxel_size=0.3, truncation_distance=0.5, max_ray_length_m=6.0,
              voxel_carving_enabled=carving)
    sj, ej = jit(jray.setup_rays, origin, pts, clearing, **kw)
    st, et = tray.setup_rays(T(origin)[None], T(pts), T(clearing), **kw)
    # Rare elements differ by one float32 ulp: XLA picks its fused
    # multiply-adds per fusion, and a few rays here round differently.
    np.testing.assert_allclose(N(st), N(sj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(N(et), N(ej), rtol=1e-6, atol=1e-6)
    S = 48
    s3, e3 = jnp.asarray(N(sj)).T, jnp.asarray(N(ej)).T
    vj, okj = jray.traverse_soa(s3, e3, S)
    vt, okt = tray.traverse_soa(T(s3), T(e3), S)
    np.testing.assert_array_equal(N(vt), N(vj))
    np.testing.assert_array_equal(N(okt), N(okj))


def test_label_color_map_matches():
    for seed in (0, 3):
        a = jcolor.LabelColorMap.random(21, seed=seed)
        b = tcolor.LabelColorMap.random(21, seed=seed)
        np.testing.assert_array_equal(b.label_colors, a.label_colors)
        np.testing.assert_array_equal(b.sorted_keys, a.sorted_keys)
        np.testing.assert_array_equal(b.sorted_labels, a.sorted_labels)
    labels = np.arange(-3, 260, dtype=np.int32).reshape(1, -1)
    np.testing.assert_array_equal(N(b.colors_from_labels(T(labels))),
                                  a.colors_from_labels(labels))
    rgb = a.colors_from_labels(np.arange(0, 30, dtype=np.int32))
    rgb[5] = (1, 2, 3)
    np.testing.assert_array_equal(b.labels_from_colors(rgb),
                                  a.labels_from_colors(rgb))


def test_build_atlas_exact():
    """Min-pool with payload, ties keeping the even pixel, and the
    invalid-depth sentinel, across every level of a 3-level pyramid."""
    rng = np.random.RandomState(4)
    H, W = 240, 320
    # Quantized depths make exact ties common.
    depth = (rng.randint(1, 6, (H, W)) * 0.5).astype(np.float32)
    depth[rng.rand(H, W) < 0.05] = 0.0
    depth[rng.rand(H, W) < 0.01] = np.nan
    labels = rng.randint(0, 21, (H, W)).astype(np.int32)
    colors = rng.randint(0, 256, (H, W, 3)).astype(np.float32)
    pj = jmip.make_plan(H, W)
    pt = tmip.make_plan(H, W)
    assert pt == tmip.MipPlan(**pj.__dict__) and pt.num_levels == 3
    aj = jit(jmip.build_atlas, depth, labels, colors, plan=pj)
    at = tmip.build_atlas(T(depth), T(labels), T(colors), pt)
    np.testing.assert_array_equal(N(at), N(aj))
    rg, b = N(at)[2, :8, :8], N(at)[3, :8, :8]
    np.testing.assert_array_equal(
        N(tmip.unpack_color(T(rg), T(b))),
        N(jmip.unpack_color(jnp.asarray(rg), jnp.asarray(b))))
    for x, y in zip(tmip.level_tables(pt), jmip.level_tables(pj)):
        np.testing.assert_array_equal(N(x), N(y))
