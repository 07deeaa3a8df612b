"""The port's I/O (kimera_semantics_tpu_torch/io) against the JAX package's:
PLY bytes, KSDV containers, .vxblx files (the committed fixtures, and the
writer at 16^3 blocks and with the 16^3 -> 32^3 regroup) and the directory
dataset (CPU). Every comparison is exact: bytes, or grids by block
coordinate."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kimera_semantics_tpu import config as jcfg
from kimera_semantics_tpu.core.color import LabelColorMap as JLabelColorMap
from kimera_semantics_tpu.grid import blocks as jblocks
from kimera_semantics_tpu.io import dataset as jdataset
from kimera_semantics_tpu.io import ply as jply
from kimera_semantics_tpu.io import serial as jserial
from kimera_semantics_tpu.io import vxblx as jvxblx

from kimera_semantics_tpu_torch import config as tcfg
from kimera_semantics_tpu_torch import interop
from kimera_semantics_tpu_torch.core.camera import PinholeIntrinsics
from kimera_semantics_tpu_torch.core.color import LabelColorMap
from kimera_semantics_tpu_torch.grid import blocks as tblocks
from kimera_semantics_tpu_torch.io import dataset as tdataset
from kimera_semantics_tpu_torch.io import ply as tply
from kimera_semantics_tpu_torch.io import serial as tserial
from kimera_semantics_tpu_torch.io import vxblx as tvxblx
from kimera_semantics_tpu_torch.models import common as tcommon

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def configs(voxel_size=0.2, vps=8, capacity=64, io_vps=0):
    return [m.FusionConfig(grid=m.GridConfig(
        voxel_size=voxel_size, voxels_per_side=vps, block_capacity=capacity,
        io_voxels_per_side=io_vps),
        tsdf=m.TsdfConfig(truncation_distance=0.4))
        for m in (jcfg, tcfg)]


def random_grid(cj, n=20, seed=0):
    """A JAX grid with `n` random blocks (in sibling clusters, so a 32^3
    regroup has partial parents) and random channels on them."""
    rng = np.random.RandomState(seed)
    coords = rng.randint(-6, 6, (n, 3)).astype(np.int32)
    coords[n // 2:] = coords[:n - n // 2] + rng.randint(0, 2, (n - n // 2, 3))
    g = jblocks.allocate_blocks(jblocks.create(cj), jnp.asarray(coords),
                                jnp.ones(n, bool), cj.grid)
    arr = {f: np.array(getattr(g, f)) for f in tblocks.FIELDS}
    nb = int(arr["n_blocks"])
    V3 = cj.grid.vps3
    w = np.where(rng.rand(nb, V3) < 0.6, rng.uniform(0.1, 30, (nb, V3)), 0)
    arr["wsum"][:nb] = w
    arr["wsdf"][:nb] = w * rng.uniform(-0.4, 0.4, (nb, V3))
    arr["wcolor"][:, :nb] = w[None] * rng.uniform(0, 255, (3, nb, V3))
    arr["sem_count"][:nb] = np.where(w > 0, rng.randint(0, 9, (nb, V3)), 0)
    arr["sem_delta"][:, :nb] = rng.uniform(0, 3, arr["sem_delta"][:, :nb].shape)
    arr["updated"][:nb] = rng.rand(nb) < 0.5
    arr["frame_counter"] = np.int32(7)
    arr = {k: np.asarray(v, dtype=arr[k].dtype) for k, v in arr.items()}
    return jblocks.VoxelGrid(**{k: jnp.asarray(v) for k, v in arr.items()}), arr


def same_grid_by_coords(jg, tg, cfg_t):
    """Fail unless the two grids hold the same blocks with the same TSDF
    channels (by block coordinate)."""
    nb = int(jg.n_blocks)
    assert int(tg.n_blocks) == nb
    coords = np.asarray(jg.block_coords)[:nb]
    st = tblocks.lookup_slots(tg, torch.tensor(coords), cfg_t.grid).numpy()
    assert (st < cfg_t.grid.block_capacity).all()
    for name in ("wsum", "wsdf", "wcolor", "updated"):
        a, b = np.asarray(getattr(jg, name)), getattr(tg, name).numpy()
        a, b = (a[:, :nb], b[:, st]) if a.ndim == 3 else (a[:nb], b[st])
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("normals", [False, True])
def test_ply_bytes_match(tmp_path, normals):
    rng = np.random.RandomState(1)
    v = rng.randn(30, 3).astype(np.float32)
    c = rng.randint(0, 256, (30, 3)).astype(np.uint8)
    t = np.arange(30, dtype=np.int32).reshape(-1, 3)
    n = rng.randn(30, 3).astype(np.float32) if normals else None
    assert tply.ply_bytes(v, c, t, n) == jply.ply_bytes(v, c, t, n)
    tply.write_ply(str(tmp_path / "a.ply"), v, c, t, n)
    jply.write_ply(str(tmp_path / "b.ply"), v, c, t, n)
    a = open(tmp_path / "a.ply", "rb").read()
    assert a == open(tmp_path / "b.ply", "rb").read()
    back = tply.read_ply(str(tmp_path / "a.ply"), with_normals=True)
    for x, y in zip(back, (v, c, t, n)):
        if y is None:
            assert x is None
        else:
            np.testing.assert_array_equal(x, y)


def test_ksdv_bytes_match_and_cross_load(tmp_path):
    cj, ct = configs()
    jg, arr = random_grid(cj)
    tg = interop.grid_from_numpy(arr, ct, device="cpu")
    pj, pt = str(tmp_path / "j.ksdv"), str(tmp_path / "t.ksdv")
    jserial.save_grid(pj, jg)
    tserial.save_grid(pt, tg)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    back_t = interop.grid_to_numpy(tserial.load_grid(pj, ct, device="cpu"))
    back_j = jserial.load_grid(pt, cj)
    for name in tblocks.FIELDS:
        np.testing.assert_array_equal(back_t[name], arr[name], err_msg=name)
        np.testing.assert_array_equal(np.asarray(getattr(back_j, name)),
                                      arr[name], err_msg=name)
    with pytest.raises(ValueError, match="does not match"):
        tserial.load_grid(pj, configs(capacity=128)[1], device="cpu")


@pytest.mark.parametrize("name", ["golden_map.vxblx", "tsdf_unpacked.vxblx",
                                  "tsdf_packed.vxblx", "many_blocks.vxblx"])
def test_vxblx_fixtures_load_like_jax(name):
    """Every section decodes as the JAX package decodes it; the TSDF layer
    loads to the same grid (many_blocks.vxblx carries headers without voxel
    payloads, a framing fixture no grid loads from)."""
    path = os.path.join(FIXTURES, name)
    secs_j, secs_t = jvxblx.read_sections(path), tvxblx.read_sections(path)
    assert [s.type for s in secs_t] == [s.type for s in secs_j]
    for a, b in zip(secs_j, secs_t):
        assert (b.voxel_size, b.voxels_per_side) == (a.voxel_size,
                                                     a.voxels_per_side)
        np.testing.assert_array_equal(b.voxel_data, a.voxel_data)
        np.testing.assert_array_equal(b.block_origins, a.block_origins)
    sec = secs_j[0]
    if sec.voxel_data.size == 0:
        return
    cj, ct = configs(sec.voxel_size, sec.voxels_per_side, capacity=256)
    jg = jvxblx.load_vxblx(path, cj)
    tg = tvxblx.load_vxblx(path, ct, device="cpu")
    assert int(tg.n_blocks) > 0
    same_grid_by_coords(jg, tg, ct)


@pytest.mark.parametrize("io_vps", [0, 32])
def test_save_vxblx_bytes_match(tmp_path, io_vps):
    """16^3 blocks written as they are, and regrouped into 32^3 blocks
    (absent siblings default-filled); loading splits back to the observed
    16^3 tiles."""
    cj, ct = configs(0.05, 16, 64, io_vps)
    jg, arr = random_grid(cj, n=24, seed=3)
    tg = interop.grid_from_numpy(arr, ct, device="cpu")
    pj, pt = str(tmp_path / "j.vxblx"), str(tmp_path / "t.vxblx")
    jvxblx.save_vxblx(pj, jg, cj)
    tvxblx.save_vxblx(pt, tg, ct)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    sec = tvxblx.read_sections(pt)[0]
    assert sec.voxels_per_side == (io_vps or 16)
    jl = jvxblx.load_vxblx(pj, cj)
    tl = tvxblx.load_vxblx(pt, ct, device="cpu")
    same_grid_by_coords(jl, tl, ct)


class ArrayDataset:
    """Frames of seeded random depth, labels and poses: what
    save_directory_dataset needs of a dataset (intr, frame, len)."""

    def __init__(self, n, intr, label_map):
        rng = np.random.RandomState(4)
        shape = (intr.height, intr.width)
        self.intr = intr
        self.frames = []
        for _ in range(n):
            T = np.eye(4, dtype=np.float32)
            T[:3, 3] = rng.uniform(-1, 1, 3)
            self.frames.append(tcommon.frame_from_images(
                rng.uniform(0.2, 6.0, shape).astype(np.float32),
                label_map=label_map,
                labels=rng.randint(0, 21, shape).astype(np.int32),
                T_G_C=T, device="cpu"))

    def __len__(self):
        return len(self.frames)

    def frame(self, i):
        return self.frames[i]


def test_directory_dataset_round_trip(tmp_path):
    """A dataset written by the port and read back by both packages: the
    same frames."""
    intr = PinholeIntrinsics(fx=40.0, fy=40.0, cx=31.5, cy=23.5, width=64,
                             height=48)
    lm = LabelColorMap.random()
    ds = ArrayDataset(3, intr, lm)
    tdataset.save_directory_dataset(str(tmp_path), ds)
    dt = tdataset.DirectoryDataset(str(tmp_path), label_map=lm,
                                   device="cpu")
    dj = jdataset.DirectoryDataset(str(tmp_path),
                                   label_map=JLabelColorMap.random())
    assert len(dt) == len(dj) == 3
    assert dataclasses.asdict(dt.intr) == dataclasses.asdict(dj.intr)
    for i, (ft, host) in enumerate(zip(dt, dt.host_frames())):
        fj, f0 = dj.frame(i), ds.frame(i)
        for n in ("depth", "labels", "colors", "T_G_C"):
            np.testing.assert_array_equal(getattr(ft, n).numpy(),
                                          np.asarray(getattr(fj, n)),
                                          err_msg=n)
            np.testing.assert_array_equal(getattr(ft, n).numpy(),
                                          getattr(f0, n).numpy(), err_msg=n)
        assert isinstance(host["depth"], np.ndarray)
