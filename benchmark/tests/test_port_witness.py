"""The second witness of the reference's walk (kbench/witness.py) on the
CPU at a test's size: it agrees with the reference's frozen walk, and it
catches a walk cut short and a walk that steps along the wrong axis."""

from __future__ import annotations

import json
import os

import pytest

from conftest import DATA

import witness as witness_script
from kbench import reference as ref
from kbench import scene, witness


def _frames_and_conf():
    import torch
    with open(os.path.join(DATA, "tiny.json")) as f:
        conf = json.load(f)
    with open(os.path.join(DATA, "tiny_batch.json")) as f:
        traffic = json.load(f)
    # Two voxels of truncation, as the cells have: the tiny cells'
    # truncation lies under a voxel, where the drop-off is degenerate.
    conf["fusion"]["truncation_distance"] = 0.5
    return scene.frames(conf, traffic, 7, torch.device("cpu"))[:2], conf


@pytest.fixture(scope="module")
def frames_conf():
    return _frames_and_conf()


def _report(frames_conf):
    import torch
    frames, conf = frames_conf
    return [witness.frame_report(f, conf, torch.device("cpu"))
            for f in frames]


def test_exact_walk_agrees_with_the_reference(frames_conf):
    for rep in _report(frames_conf):
        for stream, r in rep.items():
            assert r["jobs"] > 500, stream
            assert r["count_differs"] == 0 and r["voxel_differs"] == 0
            assert r["doubt"] < 0.02 * r["jobs"]
            assert max(r["w"], r["wsdf"], r["gate"]) <= \
                witness_script.VALUE_LIMIT


def _cut_short(monkeypatch):
    """The walk one step short of its end, as a ray extent cut short."""
    real = ref.dda_init

    def dda_init(*a):
        curr, n, sign, t_next, t_step = real(*a)
        return curr, n - 1, sign, t_next, t_step
    monkeypatch.setattr(ref, "dda_init", dda_init)


def _wrong_axis(monkeypatch):
    """The walk steps along the axis whose plane it crosses last."""
    import torch

    def dda_advance(curr, t_next, sign, t_step):
        fin = torch.where(torch.isinf(t_next), -torch.inf, t_next)
        axis = fin.argmax(dim=0)
        onehot = torch.arange(3)[:, None] == axis[None, :]
        return (curr + torch.where(onehot, sign, 0),
                t_next + torch.where(onehot, t_step, 0.0))
    monkeypatch.setattr(ref, "dda_advance", dda_advance)


@pytest.mark.parametrize("fault", [_cut_short, _wrong_axis],
                         ids=["cut_short", "wrong_axis"])
def test_exact_walk_catches_a_faulty_walk(frames_conf, monkeypatch, fault):
    fault(monkeypatch)
    rep = _report(frames_conf)[0]
    assert sum(r["count_differs"] + r["voxel_differs"]
               for r in rep.values()) > 100
