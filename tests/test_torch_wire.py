"""The port's u16 wire atlas codec and `wire_sim` against the JAX package
(CPU): the encoded planes in dtype and value, the decoded atlas bit for bit,
the codec's bounds, and three projective frames integrated through the
wire by both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_semantics_tpu import config as jcfg
from kimera_semantics_tpu.core.camera import PinholeIntrinsics
from kimera_semantics_tpu.core.color import LabelColorMap
from kimera_semantics_tpu.grid import blocks as jblocks
from kimera_semantics_tpu.io.dataset import SyntheticDataset
from kimera_semantics_tpu.models import projective as jproj_model
from kimera_semantics_tpu.ops import mip as jmip

import kimera_semantics_tpu_torch as kt
from kimera_semantics_tpu_torch import config as tcfg
from kimera_semantics_tpu_torch.grid import blocks as tblocks
from kimera_semantics_tpu_torch.models import common as tcommon
from kimera_semantics_tpu_torch.models import projective as tproj_model
from kimera_semantics_tpu_torch.ops import mip as tmip

INTR = PinholeIntrinsics(fx=60.0, fy=60.0, cx=39.5, cy=29.5, width=80,
                         height=60)
CHANNELS = ("wsum", "wsdf", "sem_count", "sem_delta", "wcolor")


def configs(color=False, num_labels=21):
    """The JAX and the port's FusionConfig: tests/test_projective.py's
    cfg_small, in the given colour mode and label count."""
    return [m.FusionConfig(
        grid=m.GridConfig(voxel_size=0.25, voxels_per_side=8,
                          block_capacity=768, num_labels=num_labels),
        tsdf=m.TsdfConfig(truncation_distance=0.5, max_ray_length_m=8.0),
        semantic=m.SemanticConfig(
            semantic_measurement_probability=0.8,
            color_mode=m.ColorMode.COLOR if color else m.ColorMode.SEMANTIC),
        pipeline=m.PipelineConfig(block_budget=256, alloc_stride=4))
        for m in (jcfg, tcfg)]


def seeded_atlas(cfg, seed=0, shape=(16, 40)):
    """A (4, H, W) float32 atlas from a seed, with the codec's edge cases:
    a NaN depth, 0, a negative depth, dmax itself, a depth past dmax, one
    past the far bound, the invalid sentinel; labels 300, 255 and 256
    (past uint8); colour words at their ends."""
    rng = np.random.RandomState(seed)
    dmax = jmip.wire_depth_max(cfg)
    far_hi = max(jmip._WIRE_FAR_MAX, 2.0 * dmax)
    a = np.zeros((4,) + shape, np.float32)
    a[0] = rng.uniform(0.0, dmax, shape)
    a[0, 1] = rng.uniform(dmax, far_hi, shape[1])
    a[0, 0, :8] = [np.nan, 0.0, -3.0, dmax, dmax + 0.01, far_hi + 7.0,
                   jmip.DEPTH_SENTINEL, 1e-7]
    a[1] = rng.randint(0, cfg.grid.num_labels, shape)
    a[1, 0, :5] = [300.0, 255.0, 256.0, 0.0, 70000.0]
    a[2] = rng.randint(0, 65536, shape)
    a[2, 0, :2] = [0.0, 65535.0]
    a[3] = rng.randint(0, 256, shape)
    a[3, 0, :2] = [0.0, 255.0]
    return a


CASES = [(False, 21), (True, 21), (False, 300), (True, 300)]


@pytest.mark.parametrize("color,num_labels", CASES)
def test_encode_matches_jax(color, num_labels):
    """Every plane equals JAX wire_encode's in dtype and value, jitted or
    not; a label of 300 saturates to 255 in uint8 as in the JAX package."""
    cj, ct = configs(color, num_labels)
    a = seeded_atlas(cj)
    want = jmip.wire_encode(jnp.asarray(a), cj)
    jitted = jax.jit(lambda x: jmip.wire_encode(x, cj))(jnp.asarray(a))
    got = tmip.wire_encode(torch.from_numpy(a), ct)
    assert len(got) == len(want) == (4 if color else 2)
    for g, w, j in zip(got, want, jitted):
        assert str(g.dtype) == f"torch.{w.dtype}"
        np.testing.assert_array_equal(g.to(torch.int32).numpy(),
                                      np.asarray(w))
        np.testing.assert_array_equal(np.asarray(j), np.asarray(w))
    if num_labels <= 256:
        assert got[1][0, :3].tolist() == [255, 255, 255]


@pytest.mark.parametrize("color,num_labels", CASES)
def test_decode_matches_jax(color, num_labels):
    """atlas_from_wire equals the JAX package's jitted decode bit for bit
    (the JAX integrator runs it under jit, where XLA:CPU fuses the far
    range's multiply-add). The eager JAX decode rounds that product and
    sum twice, so against it the far range is held to 1 ulp and the rest
    bit for bit."""
    cj, ct = configs(color, num_labels)
    planes = jmip.wire_encode(jnp.asarray(seeded_atlas(cj, seed=1)), cj)
    tplanes = tuple(torch.from_numpy(np.asarray(p).astype(np.int32)).to(
        getattr(torch, str(p.dtype))) for p in planes)
    got = tmip.atlas_from_wire(tplanes, ct).numpy()
    jitted = np.asarray(jax.jit(lambda p: jmip.atlas_from_wire(p, cj))(
        planes))
    np.testing.assert_array_equal(got, jitted)
    eager = np.asarray(jmip.atlas_from_wire(planes, cj))
    far = np.asarray(planes[0]).astype(np.int64) >= jmip._WIRE_FINE_CODES
    far &= np.asarray(planes[0]) != 65535
    assert far.sum() > 20
    np.testing.assert_array_equal(got[1:], eager[1:])
    np.testing.assert_array_equal(got[0][~far], eager[0][~far])
    ulp = np.spacing(np.abs(eager[0][far]))
    assert np.all(np.abs(got[0][far] - eager[0][far]) <= ulp)


def test_codec_bounds():
    """tests/test_projective.py's codec bounds on the port: the sentinel
    kept, fine depths within half a step, far depths within half a far
    step, labels and colours lossless, and decode(encode(x)) == x for a
    decoded atlas."""
    cj, ct = configs(color=True)
    a = torch.from_numpy(seeded_atlas(cj, seed=2))
    a[0, 0, :3] = tmip.DEPTH_SENTINEL   # what build_atlas leaves there
    planes = tmip.wire_encode(a, ct)
    assert [p.dtype for p in planes] == [torch.uint16, torch.uint8,
                                         torch.uint16, torch.uint8]
    back = tmip.atlas_from_wire(planes, ct)
    dmax = tmip.wire_depth_max(ct)
    far_hi = max(tmip._WIRE_FAR_MAX, 2.0 * dmax)
    sen = a[0] >= tmip.DEPTH_SENTINEL
    assert bool((back[0][sen] == tmip.DEPTH_SENTINEL).all())
    step = dmax / (tmip._WIRE_FINE_CODES - 1.0)
    fine = ~sen & (a[0] >= 0) & (a[0] <= dmax)
    assert float((back[0][fine] - a[0][fine]).abs().max()) <= step / 2 + 1e-7
    far_step = (far_hi - dmax) / (65534.0 - tmip._WIRE_FINE_CODES)
    far = ~sen & (a[0] > dmax) & (a[0] <= far_hi)
    assert float((back[0][far] - a[0][far]).abs().max()) \
        <= far_step / 2 + 1e-6
    assert float(back[0][0, 5]) == pytest.approx(far_hi, abs=far_step)
    inr = (a[1] >= 0) & (a[1] <= 255)
    assert torch.equal(back[1][inr], a[1][inr])
    assert torch.equal(back[2], a[2]) and torch.equal(back[3], a[3])
    again = tmip.wire_roundtrip_atlas(back, ct)
    assert torch.equal(again, back)


def test_semantic_drops_color():
    """Outside ColorMode.COLOR the wire ships depth and labels only, and
    the decoded colour planes are zero."""
    _, ct = configs()
    plan = tmip.make_plan(4, 4)
    atlas = tmip.build_atlas(torch.ones((4, 4)),
                             torch.zeros((4, 4), dtype=torch.int32),
                             torch.full((4, 4, 3), 99.0), plan)
    planes = tmip.wire_encode(atlas, ct)
    assert len(planes) == 2
    back = tmip.atlas_from_wire(planes, ct)
    assert bool((back[2:] == 0.0).all())
    assert torch.equal(back[1], atlas[1])


def to_port(f):
    return tcommon.frame_from_images(
        np.asarray(f.depth), labels=np.asarray(f.labels),
        colors=np.asarray(f.colors), T_G_C=np.asarray(f.T_G_C), device="cpu")


def N(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def rows(grid, name, slots):
    a = N(getattr(grid, name))
    return a[:, slots] if a.ndim == 3 else a[slots]


@pytest.mark.parametrize("color", [False, True])
def test_wire_sim_three_frames_match_jax(color):
    """Three frames through integrate_frame(..., wire_sim=True) in both
    packages, compared block by block with the tolerances of
    tests/test_torch_projective.py test_three_frames_match_jax; the
    wire's grid differs from the float32 route's."""
    cj, ct = configs(color)
    ds = SyntheticDataset(num_frames=6, intr=INTR,
                          label_map=LabelColorMap.random())
    fs = [ds.frame(i) for i in range(3)]
    tintr = kt.PinholeIntrinsics(**INTR.__dict__)
    g = jblocks.create(cj)
    tg = tblocks.create(ct, device="cpu")
    plain = tblocks.create(ct, device="cpu")
    for f in fs:
        g = jproj_model.integrate_frame(g, f, cj, INTR, wire_sim=True)
        tg = tproj_model.integrate_frame(tg, to_port(f), ct, tintr,
                                         device="cpu", wire_sim=True)
        plain = tproj_model.integrate_frame(plain, to_port(f), ct, tintr,
                                            device="cpu")
        assert int(tg.overflow) == int(g.overflow) == 0
        assert int(tg.n_blocks) == int(g.n_blocks) > 0
    nb = int(g.n_blocks)
    coords = N(g.block_coords)[:nb]
    sj = np.arange(nb)
    st = N(tblocks.lookup_slots(tg, torch.tensor(coords), ct.grid))
    assert (st < ct.grid.block_capacity).all()
    for name in ("wsum", "wsdf"):
        np.testing.assert_allclose(rows(tg, name, st), rows(g, name, sj),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(rows(tg, "sem_count", st),
                                  rows(g, "sem_count", sj))
    np.testing.assert_allclose(rows(tg, "sem_delta", st),
                               rows(g, "sem_delta", sj), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(rows(tg, "wcolor", st),
                                  rows(g, "wcolor", sj))
    assert (rows(g, "wsum", sj) > 0).sum() > 500
    if color:
        assert rows(tg, "wcolor", st).any()
    sp = N(tblocks.lookup_slots(plain, torch.tensor(coords), ct.grid))
    assert not np.array_equal(rows(tg, "wsdf", st), rows(plain, "wsdf", sp))
