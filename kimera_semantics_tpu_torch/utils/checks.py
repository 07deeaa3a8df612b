"""Runtime invariant validation, the glog CHECK/DCHECK contract surface.

Counterpart: kimera_semantics_tpu/utils/checks.py (validate_grid): a
host-side audit of a whole grid snapshot, exhaustive over every voxel.
`validate_grid` raises InvariantError with the first violated contract.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import FusionConfig
from ..grid import blocks as gblocks
from ..grid import hash as bhash
from ..grid.blocks import VoxelGrid
from ..ops import semantic


class InvariantError(AssertionError):
    pass


def _check(ok: bool, msg: str):
    if not ok:
        raise InvariantError(msg)


def validate_grid(grid: VoxelGrid, cfg: FusionConfig) -> dict:
    """Audit hash-table and voxel-channel invariants; returns summary stats.

      H1  n_blocks within [0, capacity]; overflow, dropped_rays >= 0
      H2  every table entry with a slot has a valid key and vice versa
      H3  slot ids are unique and < n_blocks
      H4  table lookup of every allocated block's coords returns its slot
      V1  all accumulator channels finite on the allocated rows
      V2  wsum >= 0; sem_count >= 0
      V3  |wsdf| <= wsum * truncation
      V4  0 <= sem_delta <= sem_count * (log p - log(1-p)) per label
      P1  normalized log-odds label vectors are unit-L2 (a voxel sample)
    """
    g = cfg.grid
    cap = g.block_capacity
    nb = int(grid.n_blocks)
    host = lambda t: t.cpu().numpy()  # noqa: E731
    _check(0 <= nb <= cap, f"H1: n_blocks {nb} outside [0, {cap}]")
    _check(int(grid.overflow) >= 0, "H1: negative overflow")
    _check(int(grid.dropped_rays) >= 0, "H1: negative dropped_rays")

    tk, ts = host(grid.table_keys), host(grid.table_slots)
    has_slot = ts >= 0
    vacant = (tk == bhash.EMPTY_KEY) | (tk == bhash.TOMBSTONE_KEY)
    _check(bool(np.all(~vacant[has_slot])),
           "H2: slot assigned to an empty/tombstone table key")
    _check(bool(np.all(has_slot[~vacant])),
           "H2: claimed key without a slot (post-rollback residue)")
    slots = ts[has_slot]
    _check(len(np.unique(slots)) == len(slots), "H3: duplicate slot ids")
    _check(bool(np.all((slots >= 0) & (slots < nb))),
           f"H3: slot id outside [0, n_blocks={nb})")
    _check(len(slots) == nb, f"H3: {len(slots)} table slots != n_blocks {nb}")
    if nb:
        back = host(gblocks.lookup_slots(grid, grid.block_coords[:nb], g))
        _check(bool(np.all(back == np.arange(nb))),
               "H4: block_coords -> slot lookup round-trip failed")

    for name in ("wsum", "wsdf", "sem_count", "sem_delta", "wcolor"):
        arr = getattr(grid, name)
        live = arr[:nb] if arr.dim() == 2 else arr[:, :nb]
        _check(bool(torch.isfinite(live).all()), f"V1: non-finite {name}")

    wsum = host(grid.wsum[:nb])
    _check(bool((wsum >= 0).all()), "V2: negative wsum")
    semc = host(grid.sem_count[:nb])
    _check(bool((semc >= 0).all()), "V2: negative sem_count")
    wsdf = host(grid.wsdf[:nb])
    trunc = cfg.tsdf.truncation_distance
    _check(bool((np.abs(wsdf) <= wsum * trunc * (1 + 1e-5) + 1e-6).all()),
           "V3: |wsdf| exceeds wsum * truncation")

    lk = semantic.make_likelihood(cfg.semantic)
    sd = host(grid.sem_delta[:, :nb])
    _check(bool((sd >= -1e-6).all()), "V4: negative sem_delta")
    _check(bool((sd <= semc[None] * lk.delta * (1 + 1e-5) + 1e-5).all()),
           "V4: sem_delta exceeds count * delta")

    if nb:
        lo = gblocks.label_logodds(grid, lk.log_match, lk.log_nonmatch)
        sample = torch.movedim(lo[:, :min(nb, 4)], 0, -1)   # (b, V3, L)
        probs = host(semantic.normalize_probabilities(sample))
        norms = np.linalg.norm(probs, axis=-1)
        _check(bool(np.allclose(norms, 1.0, atol=1e-4)),
               "P1: normalized posterior label vectors are not unit-norm")

    return {"n_blocks": nb, "overflow": int(grid.overflow),
            "dropped_rays": int(grid.dropped_rays),
            "observed_voxels": int((wsum > 0).sum()),
            "table_load": float(len(slots) / len(tk))}
