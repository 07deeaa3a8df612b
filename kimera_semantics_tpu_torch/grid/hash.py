"""Open-addressing block hash table: BlockIndex -> slot.

Counterpart: kimera_semantics_tpu/grid/hash.py (pack/unpack and their SoA
forms, mix, lookup, insert, insert_compacted, unique_keys,
insert_frame_list). Block coordinates pack into one int32 key (10 bits per
axis, offset by +world_extent_blocks), hash with a murmur3-style finalizer,
and probe linearly. Insertion is a batched claim and verify loop in which,
of the keys bidding for one free position, the largest batch index wins:
the last-writer rule of XLA:CPU's scatter, so the tables, slot ids
included, equal the JAX package's and are the same from run to run.

The probe loops are the kernels H1 (`lookup`, `lookup_bounded`) and H2
(`insert`) of ops/kernels.py on CUDA tensors, and their plain versions on
CPU tensors. On the card no function here waits on the host: the counters
stay 0-d device tensors and every scatter goes through a trash entry
instead of a boolean-mask index.
"""

from __future__ import annotations

import numpy as np
import torch

EMPTY_KEY = -1
TOMBSTONE_KEY = -2
MAX_PROBES = 64
_TRASH_KEY = 0x7FFFFFFF  # packed keys are 30-bit positive


def pack_block_coords(coords: torch.Tensor, extent: int) -> torch.Tensor:
    """Pack (..., 3) int32 block coords in [-extent, extent) into keys."""
    c = coords + extent
    return (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]


def unpack_block_key(keys: torch.Tensor, extent: int) -> torch.Tensor:
    x = (keys >> 20) & 0x3FF
    y = (keys >> 10) & 0x3FF
    z = keys & 0x3FF
    return torch.stack([x, y, z], dim=-1) - extent


def in_bounds(coords: torch.Tensor, extent: int) -> torch.Tensor:
    return ((coords >= -extent) & (coords < extent)).all(dim=-1)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Integers carried in int64 wrapped to int32 two's complement, as the
    reference's int32 multiplies and shifts wrap."""
    return (((x.to(torch.int64) + (1 << 31)) & 0xFFFFFFFF)
            - (1 << 31)).to(torch.int32)


def mul_i32(a: torch.Tensor, c: int) -> torch.Tensor:
    """int32 a * c with wrap-around (computed in int64)."""
    return wrap_i32(a.to(torch.int64) * c)


def mix(keys: torch.Tensor) -> torch.Tensor:
    """32-bit finalizer producing well-spread non-negative hashes; uint32
    arithmetic carried in int64 with explicit masking."""
    m32 = 0xFFFFFFFF
    h = keys.to(torch.int64) & m32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & m32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & m32
    h = h ^ (h >> 16)
    return (h & 0x7FFFFFFF).to(torch.int32)


def pack_block_coords_soa(bx: torch.Tensor, by: torch.Tensor,
                          bz: torch.Tensor, extent: int) -> torch.Tensor:
    """Component-wise pack_block_coords."""
    return ((bx + extent) << 20) | ((by + extent) << 10) | (bz + extent)


def in_bounds_soa(bx, by, bz, extent: int) -> torch.Tensor:
    """Component-wise in_bounds."""
    ok = (bx >= -extent) & (bx < extent)
    ok &= (by >= -extent) & (by < extent)
    ok &= (bz >= -extent) & (bz < extent)
    return ok


def sample_keys(rng: np.random.RandomState, n: int, spread: int,
                extent: int) -> np.ndarray:
    """n distinct packed keys (int32 numpy) of block coordinates drawn from
    [-spread, spread)^3, in random order: key sets for the table's tests
    and card checks."""
    side = 2 * spread
    cells = rng.choice(side ** 3, size=n, replace=False)
    c = np.stack(np.unravel_index(cells, (side,) * 3), axis=-1) - spread
    c = (c + extent).astype(np.int64)
    return ((c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2]).astype(np.int32)


def colliding_keys(rng: np.random.RandomState, n: int, per_home: int,
                   table_size: int, extent: int,
                   home_step: int = 1) -> np.ndarray:
    """n packed keys in groups of `per_home` that share one home position
    mix(key) & (table_size - 1), found among random block coordinates;
    the groups interleaved, so each group's probe chain is contested round
    after round. The groups take the lowest homes that are multiples of
    `home_step`: at 1 their chains run into each other."""
    k = sample_keys(rng, min(60 * table_size, 200 ** 3), 100, extent)
    home = mix(torch.from_numpy(k)).numpy() & (table_size - 1)
    order = np.argsort(home, kind="stable")
    k, home = k[order], home[order]
    starts = np.flatnonzero(np.r_[True, home[1:] != home[:-1]])
    counts = np.diff(np.r_[starts, len(home)])
    full = starts[(counts >= per_home)
                  & (home[starts] % home_step == 0)][: n // per_home]
    if len(full) * per_home < n:
        raise ValueError(f"too few groups of {per_home} colliding keys")
    groups = np.stack([k[s:s + per_home] for s in full])   # (G, per_home)
    return groups.T.reshape(-1)[:n].copy()


def _kernels():
    # ops/kernels.py imports this module; the wrappers are reached through
    # the module attribute, so a caller may swap them for their plain
    # versions (chip_smoke.py's reference runs).
    from ..ops import kernels
    return kernels


def lookup(table_keys: torch.Tensor, table_slots: torch.Tensor,
           keys: torch.Tensor, table_size: int) -> torch.Tensor:
    """Key -> slot; -1 for missing keys. A key's probe ends at its match or
    at the first EMPTY position, within MAX_PROBES rounds (H1)."""
    return _kernels().hash_lookup(table_keys, table_slots,
                                  keys.to(torch.int32).contiguous(),
                                  table_size, MAX_PROBES)[0]


def lookup_bounded(table_keys: torch.Tensor, table_slots: torch.Tensor,
                   keys: torch.Tensor, table_size: int, rounds: int):
    """`lookup` in at most `rounds` probe rounds: (slots, complete),
    `complete` a device bool that every probe ended (else the unfinished
    keys read -1)."""
    return _kernels().hash_lookup(table_keys, table_slots,
                                  keys.to(torch.int32).contiguous(),
                                  table_size, rounds)


def insert(table_keys, table_slots, block_coords, n_blocks, keys, active,
           table_size: int, capacity: int, extent: int):
    """Batch-insert packed block keys; allocate slots for new blocks (H2).

    Returns new (table_keys, table_slots, block_coords, n_blocks,
    overflowed); the inputs are not modified. Keys that find no table
    position within MAX_PROBES, or whose slot would pass `capacity`, count
    in `overflowed`; a claim rolled back for capacity becomes a TOMBSTONE
    so wrapped probe chains stay walkable."""
    return _kernels().hash_insert(
        table_keys, table_slots, block_coords, n_blocks,
        keys.to(torch.int32).contiguous(), active.contiguous(), table_size,
        capacity, extent)


def _unique_sorted(keys: torch.Tensor, active: torch.Tensor, budget: int):
    """Ascending unique active keys, trash-padded, cut to `budget`; and
    the number of uniques beyond it."""
    k = torch.where(active, keys, torch.full_like(keys, _TRASH_KEY))
    sk, _ = torch.sort(k)
    is_first = torch.ones_like(sk, dtype=torch.bool)
    is_first[1:] = sk[1:] != sk[:-1]
    is_first &= sk != _TRASH_KEY
    n_uniq = is_first.sum(dtype=torch.int32)
    uk, _ = torch.sort(torch.where(is_first, sk,
                                   torch.full_like(sk, _TRASH_KEY)))
    return uk[:budget], torch.clamp(n_uniq - budget, min=0)


def unique_keys(keys: torch.Tensor, active: torch.Tensor, budget: int):
    """Compact a duplicate-heavy key stream to its unique values: (uk
    (budget,) int32 ascending with trash 0x7FFFFFFF beyond the uniques,
    n_dropped)."""
    return _unique_sorted(keys.reshape(-1), active.reshape(-1), budget)


def insert_compacted(table_keys, table_slots, block_coords, n_blocks, keys,
                     active, table_size: int, capacity: int, extent: int):
    """insert() after compacting `keys` to its unique values; uniques
    beyond `capacity` count as overflow (they could never be allocated)."""
    uk, dropped = _unique_sorted(keys, active, capacity)
    tk, ts, bc, nb, ov = insert(table_keys, table_slots, block_coords,
                                n_blocks, uk, uk != _TRASH_KEY, table_size,
                                capacity, extent)
    return tk, ts, bc, nb, ov + dropped


def insert_frame_list(table_keys, table_slots, block_coords, n_blocks, keys,
                      active, table_size: int, capacity: int, extent: int,
                      budget: int):
    """Insert this frame's candidate keys and return its touched-block list.

    Returns (table_keys, table_slots, block_coords, n_blocks, overflow,
    frame_coords (budget, 3) int32, frame_slots (budget,) int32,
    frame_real (budget,) bool).

    The list is GROUP-ALIGNED: 8-row tiles, one per distinct slot group
    (slot // 8) touched this frame, groups ascending; entry j covers slot
    group(j // 8) * 8 + j % 8, the row layout of the grid channels. Rows of
    a touched group that this frame did not touch are padding
    (`frame_real` False); tiles past the touched groups are trash tiles
    (slots capacity + j % 8, the grid's trash rows). Touched blocks that do
    not fit `budget` rows are dropped and counted in overflow."""
    if budget % 8 or capacity % 8:
        raise ValueError("block_budget and block_capacity must be multiples "
                         "of 8 (one tile group is 8 rows)")
    dev = keys.device
    uk, dropped = _unique_sorted(keys, active, budget)
    tk, ts, bc, nb, ov = insert(table_keys, table_slots, block_coords,
                                n_blocks, uk, uk != _TRASH_KEY, table_size,
                                capacity, extent)
    slots_u = lookup(tk, ts, uk, table_size)
    real_u = (uk != _TRASH_KEY) & (slots_u >= 0)
    big = 1 << 30
    s_sort = torch.where(real_u, slots_u, torch.full_like(slots_u, big))
    s, order = torch.sort(s_sort, stable=True)
    coords_u = torch.where(real_u[:, None], unpack_block_key(uk, extent),
                           torch.zeros_like(uk)[:, None])[order]
    isreal = s < big
    grp = torch.div(s, 8, rounding_mode="floor")
    newg = isreal.clone()
    newg[1:] &= grp[1:] != grp[:-1]
    grank = torch.cumsum(newg.to(torch.int32), 0, dtype=torch.int32) - 1
    pos = torch.where(isreal, grank * 8 + s % 8,
                      torch.full_like(s, budget))
    group_overflow = ((pos >= budget) & isreal).sum(dtype=torch.int32)
    # Rows past the budget scatter into one trash row (tile) past the
    # list's end, which is cut off.
    pos = torch.clamp(pos, max=budget).long()
    n_tiles = budget // 8
    tile_groups = torch.full((n_tiles + 1,), capacity // 8,
                             dtype=torch.int32, device=dev)
    tile_groups[pos // 8] = grp
    row = torch.arange(budget, dtype=torch.int32, device=dev) % 8
    fslots = tile_groups[:n_tiles].repeat_interleave(8) * 8 + row
    freal = torch.zeros((budget + 1,), dtype=torch.bool, device=dev)
    freal[pos] = isreal
    fcoords = torch.zeros((budget + 1, 3), dtype=torch.int32, device=dev)
    fcoords[pos] = coords_u
    return (tk, ts, bc, nb, ov + dropped + group_overflow, fcoords[:budget],
            fslots, freal[:budget])
