"""Carry grid state between the JAX package and the port.

No JAX counterpart. A grid crosses as a dict of numpy arrays keyed by the
field names of the JAX VoxelGrid (kimera_semantics_tpu/grid/blocks.py),
e.g. `{f: np.asarray(getattr(jax_grid, f)) for f in FIELDS}`. The hash table
crosses too, so a grid carried across keeps its slot ids and two grids can
be compared slot for slot.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import FusionConfig
from .device import resolve
from .grid.blocks import FIELDS, VoxelGrid, create

_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32,
           np.dtype(np.bool_): torch.bool}


def grid_from_numpy(arrays, cfg: FusionConfig, device="cuda") -> VoxelGrid:
    """A port VoxelGrid on `device` from numpy arrays of the JAX grid's
    fields, checked against the shapes `cfg` gives."""
    ref = create(cfg, device="cpu")
    dev = resolve(device)
    out = {}
    for name in FIELDS:
        a = np.asarray(arrays[name])
        want = getattr(ref, name)
        if tuple(a.shape) != tuple(want.shape) or \
                _DTYPES.get(a.dtype) != want.dtype:
            raise ValueError(f"{name}: got {a.dtype} {a.shape}, expected "
                             f"{want.dtype} {tuple(want.shape)}")
        # A copy: the port updates grids in place, and the arrays may be
        # read-only views of the JAX package's buffers.
        out[name] = torch.tensor(a, device=dev)
    return VoxelGrid(**out)


def grid_to_numpy(grid: VoxelGrid) -> dict:
    """The grid's fields as numpy arrays, keyed as the JAX VoxelGrid's."""
    return {name: getattr(grid, name).cpu().numpy() for name in FIELDS}
