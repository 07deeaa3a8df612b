"""The configurations' references (kbench/spec.py reference) on the CPU:
the fast configurations still reach kbench/reference.py unchanged through
the lookup, and the merged reference's frozen bundling and walk agree with
independent float64 witnesses."""

from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import BENCH, DATA, REPO

from kbench import check, scene, spec, witness
from kbench import reference as ref

DEV = torch.device("cpu")
UPDATE_TENSORS = ("idx", "sums", "vote_voxel", "vote_label", "vote_count",
                  "blocks")
UPDATE_COUNTS = ("outside", "rays", "carve_jobs", "entries", "segments",
                 "touched_blocks", "dropped_rays", "segment_overflow",
                 "rank_overflow")


def _load(path):
    with open(path) as f:
        return json.load(f)


def _fast_case(name):
    """(configuration, its first frames): tiny's six, or two uhumans2
    frames of a two-frame orbit."""
    if name == "tiny":
        conf = _load(os.path.join(DATA, "tiny.json"))
        traffic = _load(os.path.join(DATA, "tiny_batch.json"))
    else:
        conf = _load(os.path.join(BENCH, "configs", "uhumans2.json"))
        traffic = dict(_load(os.path.join(BENCH, "traffic", "batch.json")),
                       frames=2)
    return conf, scene.frames(conf, traffic, 2147483911, DEV)


@pytest.mark.parametrize("name", ["tiny", "uhumans2"])
def test_fast_lookup_equals_the_direct_reference(name):
    """A configuration without a `reference` key reaches
    kbench/reference.py: its sums, votes and work counts through the
    lookup and check.reference_sums equal frame_update called directly."""
    conf, frames = _fast_case(name)
    assert "reference" not in conf
    mod = spec.reference(REPO, conf)
    fu = conf["fusion"]
    box = ref.Box(conf["scene"]["bounds"], fu["voxel_size"], DEV)
    acc = ref.Accumulated(box, fu["num_labels"], DEV,
                          color=fu["color_mode"] == "color")
    counts = [f + 1 for f in range(len(frames))]
    got, work, looked, _ = check.reference_sums(
        frames, counts, conf, DEV, keep_updates=True, reference=mod)
    for f, frame in enumerate(frames):
        direct = ref.frame_update(frame, conf, box, DEV)
        for k in UPDATE_TENSORS:
            assert torch.equal(getattr(looked[f], k), getattr(direct, k)), k
        for k in UPDATE_COUNTS:
            assert getattr(looked[f], k) == getattr(direct, k), k
            assert work[f][k] == getattr(direct, k), k
        acc.add(direct, counts[f])
    for k in ("w", "wsdf", "votes", "blocks"):
        assert torch.equal(getattr(got, k), getattr(acc, k)), k
    assert mod.stream_length(conf) == ref.stream_length(conf)


def _merged_case():
    """The tiny merged frames with two voxels of truncation, as the
    cells have (the tiny cells' truncation lies under a voxel, where the
    drop-off is degenerate)."""
    conf = _load(os.path.join(DATA, "tiny_merged.json"))
    conf["fusion"]["truncation_distance"] = 0.5
    traffic = _load(os.path.join(DATA, "tiny_batch.json"))
    # Frames 1, 2 and 4: the cameras of frames 0 and 3 sit on a voxel
    # face (y = 0), which puts every ray of their normal pass in doubt.
    frames = scene.frames(conf, traffic, 7, DEV)
    return conf, [frames[f] for f in (1, 2, 4)]


@pytest.fixture(scope="module")
def merged_case():
    conf, frames = _merged_case()
    mod = spec.reference(REPO, conf)
    return conf, frames, mod, [mod.frame_passes(f, conf, DEV)
                               for f in frames]


def test_merged_bundle_points_are_their_bins_means(merged_case):
    """Each bundle's frozen float32 point lies within 1e-6 m of the
    float64 weighted mean of its bin's contributing points."""
    conf, frames, mod, passes = merged_case
    for fp in passes:
        b = fp.normal_bin
        w = fp.weights.double()
        gate = (b >= 0) & (fp.weights > 1e-6) & (b < fp.bundle_point.shape[0])
        K = fp.bundle_point.shape[0]
        wsum = torch.zeros(K, dtype=torch.float64).index_add_(
            0, b[gate], w[gate])
        psum = torch.zeros((K, 3), dtype=torch.float64).index_add_(
            0, b[gate], w[gate, None] * fp.pts_G[gate].double())
        ok = fp.bundle_valid
        assert int(ok.sum()) > 200
        gap = (fp.bundle_point[ok].double() - psum[ok] / wsum[ok, None]
               ).norm(dim=1).max()
        assert float(gap) < 1e-6
        assert bool(ok.eq(wsum > 1e-6).all())


def test_merged_walk_agrees_with_the_exact_walk(merged_case):
    """kbench/witness.py's float64 walk agrees with the reference's walk
    of both passes' rays, jobs in doubt (ties) left out."""
    conf, frames, mod, passes = merged_case
    fu = conf["fusion"]
    for fp in passes:
        for name in ("normal", "clearing"):
            jobs = getattr(fp, name)
            walked = ref.walk(jobs, fp.S, fu, fu["storage_voxels_per_side"])
            r = witness.compare(jobs, walked, fp.S, fu)
            assert r["jobs"] > 100, name
            assert r["count_differs"] == 0 and r["voxel_differs"] == 0
            assert r["doubt"] < 0.05 * r["jobs"], name
            assert max(r["w"], r["wsdf"], r["gate"]) <= 1e-4, name


def test_merged_reference_covers_only_its_configuration():
    conf = _load(os.path.join(DATA, "tiny_merged.json"))
    mod = spec.reference(REPO, conf)
    box = ref.Box(conf["scene"]["bounds"], 0.25, DEV)
    for change in (dict(method="fast"), dict(carve_mode="decimated"),
                   dict(voxel_carving_enabled=False),
                   dict(enable_anti_grazing=True)):
        bad = dict(conf, fusion=dict(conf["fusion"], **change))
        with pytest.raises(ValueError):
            mod.frame_update({}, bad, box, DEV)
        with pytest.raises(ValueError):
            mod.stream_length(bad)
