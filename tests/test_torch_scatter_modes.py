"""The port's plain scatter tail (kimera_semantics_tpu_torch/ops/
integrate.py _plain_scatter_apply, ops/reduce.py SortedUpdates) against
the JAX package (CPU): SortedUpdates on a seeded stream, the fast and
merged integrators with scatter_mode "direct" and "sorted" against the JAX
integrators in the same mode, the plain tail taken where the (voxel, label)
key does not fit int32 (decided from the configuration, before any grid
exists), and the CLI's `batch --scatter-mode direct` against the JAX CLI.

Tolerances: keys, segment slots, counts, block sets and MLE labels exact.
SortedUpdates' segment sums are differences of a running float32 cumsum
whose adds round at the prefix's magnitude, and the reference's sort is
not stable (a segment's entries may be added in another order): two such
sums of a segment of k entries differ by at most 2 k eps max|prefix|
(eps the float32 epsilon), the bound the stream tests hold them to. Grid
floats within 1e-5 relative with a 1e-5 absolute floor, as the other
integrator tests, in "direct" mode; in "sorted" mode each frame's channel
is one running cumsum over the whole update stream, so a voxel's sum is
off by ulps of that prefix, and the float channels are held to 8 eps P,
P the channel's grid total (sum of |values|; for wsdf, truncation times
wsum's): eight ulps of a prefix that no frame's stream exceeds.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kimera_semantics_tpu.ops import integrate as jinteg
from kimera_semantics_tpu.ops import reduce as jreduce
from kimera_semantics_tpu.models import fast as jfast
from kimera_semantics_tpu.models import merged as jmerged
from kimera_semantics_tpu.io.dataset import SyntheticDataset
from kimera_semantics_tpu.core.color import LabelColorMap
from kimera_semantics_tpu.server import node as jnode

from kimera_semantics_tpu_torch import config as tcfg
from kimera_semantics_tpu_torch.grid import blocks as tblocks
from kimera_semantics_tpu_torch.io import dataset as tdataset
from kimera_semantics_tpu_torch.models import fast as tfast
from kimera_semantics_tpu_torch.models import merged as tmerged
from kimera_semantics_tpu_torch.ops import integrate as tinteg
from kimera_semantics_tpu_torch.ops import reduce as treduce
from kimera_semantics_tpu_torch.server import node as tnode

from test_torch_fast import (INTR, N, assert_grids_match, configs, frames,
                             run_jax, run_port)

RTOL = ATOL = 1e-5


def seeded_stream(n=4000, n_keys=300, seed=0):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, n_keys, size=n).astype(np.int32)
    keys[rng.rand(n) < 0.2] = -1                     # trash entries
    vals = rng.standard_normal((n, 3)).astype(np.float32)
    sec = rng.randint(0, 5, size=n).astype(np.int32)
    return keys, vals, sec


@pytest.mark.parametrize("secondary", [False, True])
def test_sorted_updates_match_jax(secondary):
    keys, vals, sec = seeded_stream()
    jsu = jreduce.SortedUpdates.build(
        jnp.asarray(keys), -1, jnp.asarray(sec) if secondary else None)
    tsu = treduce.SortedUpdates.build(
        torch.tensor(keys), -1, torch.tensor(sec) if secondary else None)
    np.testing.assert_array_equal(N(tsu.out_keys), np.asarray(jsu.out_keys))
    np.testing.assert_array_equal(N(tsu.mask), np.asarray(jsu.mask))
    np.testing.assert_array_equal(N(tsu.sorted_keys),
                                  np.asarray(jsu.sorted_keys))
    if secondary:
        np.testing.assert_array_equal(N(tsu.secondary_at_segments()),
                                      np.asarray(jsu.secondary_at_segments()))
    tol = cumsum_bound(keys, sec if secondary else None, vals)
    np.testing.assert_allclose(N(tsu.segment_sums(torch.tensor(vals))),
                               np.asarray(jsu.segment_sums(jnp.asarray(vals))),
                               rtol=0, atol=tol)
    # apply: the trash key's segment and the unused slots are dropped.
    jt = jsu.apply(jnp.zeros((400, 3), jnp.float32), jnp.asarray(vals))
    tt = tsu.apply(torch.zeros((400, 3)), torch.tensor(vals))
    np.testing.assert_allclose(N(tt), np.asarray(jt), rtol=0, atol=tol)
    ref = np.zeros((400, 3), np.float64)
    np.add.at(ref, keys[keys >= 0], vals[keys >= 0])
    np.testing.assert_allclose(N(tt), ref, rtol=0, atol=tol)


def cumsum_bound(keys, sec, vals):
    """2 k eps max|prefix|: k the longest segment, the prefix that of the
    running sum in key order (in float64)."""
    k2 = keys.astype(np.int64) * 8 + (0 if sec is None else sec)
    order = np.argsort(k2, kind="stable")
    k = np.unique(k2, return_counts=True)[1].max()
    prefix = np.abs(np.cumsum(vals[order].astype(np.float64), axis=0)).max()
    return 2 * k * np.finfo(np.float32).eps * prefix


def test_sorted_scatter_add_and_drop_add():
    keys, vals, _ = seeded_stream(seed=1)
    got = treduce.sorted_scatter_add(torch.zeros(300), torch.tensor(keys),
                                     torch.tensor(vals[:, 0]), -1)
    ref = np.asarray(jreduce.sorted_scatter_add(
        jnp.zeros(300, jnp.float32), jnp.asarray(keys),
        jnp.asarray(vals[:, 0]), -1))
    np.testing.assert_allclose(N(got), ref, rtol=0,
                               atol=cumsum_bound(keys, None, vals[:, :1]))
    # The reference's scatter: negative indices wrap once, others past the
    # end drop; the port adds the dropped entries as zeros into the last
    # word.
    idx = np.array([0, 3, -1, 7, 10, -12, 2], np.int32)
    v = np.arange(1, 8, dtype=np.float32)
    ref = np.asarray(jnp.zeros(8, jnp.float32).at[jnp.asarray(idx)].add(
        jnp.asarray(v)))
    got = treduce.drop_add_(torch.zeros(8), torch.tensor(idx),
                            torch.tensor(v))
    np.testing.assert_array_equal(N(got), ref)


def mode_configs(mode, **kw):
    cj, ct = configs(**kw)
    return [dataclasses.replace(c, pipeline=dataclasses.replace(
        c.pipeline, scatter_mode=mode)) for c in (cj, ct)]


@pytest.mark.parametrize("mode", ["direct", "sorted"])
@pytest.mark.parametrize("method", ["fast", "merged"])
def test_plain_modes_match_jax(frames, mode, method):
    """Three frames in each plain mode against the JAX integrator in the
    same mode (its XLA route, the reference's plain tail), by block
    coordinate."""
    jm, tm = (jfast, tfast) if method == "fast" else (jmerged, tmerged)
    cj, ct = mode_configs(mode)
    fj, ft = frames
    g = run_jax(jm, cj, fj, kernel_route=False)
    tg = run_port(tm, ct, ft)
    if mode == "direct":
        assert_grids_match(g, tg, ct)
        return
    assert_sorted_grids_match(g, tg, ct)


def assert_sorted_grids_match(g, tg, cfg):
    """assert_grids_match with the float channels held to 8 eps P."""
    for name in ("n_blocks", "overflow", "dropped_rays", "frame_counter"):
        assert int(getattr(tg, name)) == int(getattr(g, name)), name
    nb = int(g.n_blocks)
    coords = N(g.block_coords)[:nb]
    assert (set(map(tuple, N(tg.block_coords)[:nb]))
            == set(map(tuple, coords)))
    sj = np.arange(nb)
    st = N(tblocks.lookup_slots(tg, torch.tensor(coords), cfg.grid))

    def rows(grid, name, s):
        a = N(getattr(grid, name))
        return a[:, s] if a.ndim == 3 else a[s]
    eps = float(np.finfo(np.float32).eps)
    P = {c: float(np.abs(rows(g, c, sj)).sum()) for c in ("wsum",
                                                          "sem_delta")}
    P["wsdf"] = cfg.tsdf.truncation_distance * P["wsum"]
    for name, p in P.items():
        np.testing.assert_allclose(rows(tg, name, st), rows(g, name, sj),
                                   rtol=0, atol=8 * eps * p, err_msg=name)
    np.testing.assert_array_equal(rows(tg, "sem_count", st),
                                  rows(g, "sem_count", sj))
    np.testing.assert_array_equal(N(tg.updated)[st], N(g.updated)[sj])


def test_key_overflow_takes_plain_tail(frames, monkeypatch):
    """The segment path falls back to the plain tail when the (voxel,
    label) key does not fit int32, as the reference decides it
    (kimera_semantics_tpu/ops/integrate.py:205-210). The decision needs
    only the configuration: at 16^3 blocks and 21 labels a capacity of
    16376 still fits and 16384 does not (that grid would hold 7 GB, so
    none is made here). The plain tail then gives the reference's grid:
    shown on the test configuration with the decision forced, against the
    JAX package's own plain tail (its "direct" scatter, which is what its
    "segment" mode runs when the key overflows)."""
    def big(cap):
        return tcfg.FusionConfig(grid=tcfg.GridConfig(
            voxel_size=0.05, voxels_per_side=16, block_capacity=cap))
    assert tinteg.segment_key_fits(big(16376))
    assert not tinteg.segment_key_fits(big(16384))
    assert ((16385 * 4096) << 5) >= 2 ** 31 > ((16377 * 4096) << 5)
    direct = dataclasses.replace(big(64), pipeline=dataclasses.replace(
        big(64).pipeline, scatter_mode="direct"))
    assert not tinteg.segment_key_fits(direct)

    cj, ct = mode_configs("direct")
    _, ct_seg = configs()
    fj, ft = frames
    g = run_jax(jfast, cj, fj, kernel_route=False)
    calls = []
    real = tinteg._plain_scatter_apply

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tinteg, "segment_key_fits", lambda cfg: False)
    monkeypatch.setattr(tinteg, "_plain_scatter_apply", spy)
    tg = run_port(tfast, ct_seg, ft)
    assert calls
    assert_grids_match(g, tg, ct_seg)


def test_cli_batch_direct_matches_jax(tmp_path, capsys):
    """`batch --scatter-mode direct` runs in the port and prints the JAX
    CLI's numbers."""
    intr = INTR
    ds = SyntheticDataset(num_frames=3, intr=intr,
                          label_map=LabelColorMap.random())
    tdataset.save_directory_dataset(str(tmp_path / "d"), ds)
    argv = ["batch", str(tmp_path / "d"), "--voxel-size", "0.2",
            "--voxels-per-side", "8", "--block-capacity", "512",
            "--truncation", "0.4", "--max-ray-length", "4.0",
            "--max-rays", "2048", "--scatter-mode", "direct",
            "--mesh-out", ""]
    jnode.main(argv)
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = tnode.main(argv + ["--device", "cpu"])
    for k in ("frames", "blocks", "overflow", "dropped_rays",
              "observed_voxels"):
        assert got[k] == ref[k], k
    assert got["triangles"] == ref["triangles"] > 0
