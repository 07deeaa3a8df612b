"""VoxelGrid checkpoint save/load, the saveMap/loadMap equivalent.

Counterpart: kimera_semantics_tpu/io/serial.py (save_grid, load_arrays,
load_grid): the KSDV container, which round-trips every channel, semantic
ones included. Pure Python/numpy (the port does not load the JAX package's
native library); the bytes are those of the JAX package:

  b"KSDV", u32 version 1, u32 field count, then per field: u32 name
  length, name, u32 dtype code, u32 ndim, ndim x i64 dims, raw data.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..config import FusionConfig
from ..grid import blocks as gblocks
from ..grid.blocks import VoxelGrid

_MAGIC = b"KSDV"
_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.int32): 1,
                np.dtype(np.uint8): 2, np.dtype(np.bool_): 3}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}

# Field order of the container (the JAX VoxelGrid's field order).
_FIELDS = ["table_keys", "table_slots", "block_coords", "n_blocks", "overflow",
           "dropped_rays",
           "wsum", "wsdf", "wcolor", "sem_count", "sem_delta", "updated",
           "start_set", "observed_set", "frame_counter"]

# Fields older checkpoints may lack; load_grid then keeps the default (0).
_OPTIONAL_FIELDS = {"dropped_rays"}


def save_grid(path: str, grid: VoxelGrid) -> None:
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<II", 1, len(_FIELDS)))
        for name in _FIELDS:
            arr = getattr(grid, name).cpu().numpy()
            if arr.dtype == np.int64:
                arr = arr.astype(np.int32)
            # 0-d scalars are written as (1,), as the JAX package does.
            arr = np.ascontiguousarray(arr)
            if arr.ndim == 0:
                arr = arr.reshape(1)
            nb = name.encode()
            f.write(struct.pack("<I", len(nb)))
            f.write(nb)
            f.write(struct.pack("<II", _DTYPE_CODES[arr.dtype], arr.ndim))
            f.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
            f.write(arr.tobytes())


def load_arrays(path: str) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != _MAGIC:
        raise IOError(f"{path}: not a KSDV container")
    version, count = struct.unpack_from("<II", data, 4)
    if version != 1:
        raise IOError(f"{path}: unsupported version {version}")
    off = 12
    out = {}
    for _ in range(count):
        (nlen,) = struct.unpack_from("<I", data, off)
        off += 4
        name = data[off:off + nlen].decode()
        off += nlen
        code, ndim = struct.unpack_from("<II", data, off)
        off += 8
        dims = struct.unpack_from(f"<{ndim}q", data, off)
        off += 8 * ndim
        dtype = _CODE_DTYPES[code]
        n = int(np.prod(dims)) if ndim else 1
        arr = np.frombuffer(data, dtype=dtype, count=max(n, 1),
                            offset=off).reshape(dims)
        off += n * dtype.itemsize
        out[name] = arr.copy()
    return out


def load_grid(path: str, cfg: FusionConfig, device="cuda") -> VoxelGrid:
    """Load a checkpoint onto `device` (kReplace: the file's state replaces
    the in-memory layer)."""
    arrays = load_arrays(path)
    ref = gblocks.create(cfg, device=device)
    for name in _FIELDS:
        if name not in arrays and name in _OPTIONAL_FIELDS:
            continue
        arr = arrays[name]
        want = getattr(ref, name)
        if arr.size != want.numel():
            raise ValueError(
                f"{path}: field {name} shape {arr.shape} does not match "
                f"config shape {tuple(want.shape)}")
        setattr(ref, name, torch.as_tensor(arr.reshape(tuple(want.shape)),
                                           device=want.device).to(want.dtype))
    return ref
