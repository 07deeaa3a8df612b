"""Carry grid state between the JAX package and the port.

No JAX counterpart. A grid crosses as a dict of numpy arrays keyed by the
field names of the JAX VoxelGrid (kimera_semantics_tpu/grid/blocks.py),
e.g. `{f: np.asarray(getattr(jax_grid, f)) for f in FIELDS}`. The hash table
crosses too, so a grid carried across keeps its slot ids and two grids can
be compared slot for slot. A sharded grid (parallel/sharding.py) crosses as
the JAX sharded stack's fields, each with a leading (D, ...) shard axis.
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


def sharded_from_numpy(arrays, cfg: FusionConfig, mesh):
    """A port ShardedGrid on the mesh's local shards from numpy arrays of
    the JAX sharded stack's fields (leading axis D = mesh.size); this
    process takes its own shards' rows."""
    from .parallel.sharding import ShardedGrid
    first = mesh.shard_index(0)
    return ShardedGrid([
        grid_from_numpy({n: np.asarray(arrays[n])[first + i] for n in FIELDS},
                        cfg, device=d)
        for i, d in enumerate(mesh.devices)])


def sharded_to_numpy(sgrid) -> dict:
    """The local shards' fields stacked as numpy arrays (D, ...), keyed as
    the JAX VoxelGrid's."""
    return {name: sgrid.stacked(name).numpy() for name in FIELDS}
