"""Open-addressing block hash table: BlockIndex -> slot.

Counterpart: kimera_semantics_tpu/grid/hash.py (pack/unpack, mix, lookup,
insert, insert_compacted, unique_keys, insert_frame_list). Block coordinates pack into one int32 key
(10 bits per axis, offset by +world_extent_blocks), hash with a
murmur3-style finalizer, and probe linearly. Insertion is a batched claim
and verify loop: a racing `index_put_` claims empty positions and a read
back tells each key whether it won. Of colliding writers an arbitrary one
wins, so slot ids may differ between runs and from the JAX package; grids
are compared by block coordinate.

Each probe round of `lookup` and `insert` ends in one host sync (`.any()`)
that decides whether another round is needed.
"""

from __future__ import annotations

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


def _probe(table_keys, table_slots, keys, table_size: int):
    """Generator of the probe rounds of `lookup`: yields (result, done)
    after each round."""
    mask = table_size - 1
    idx = (mix(keys) & mask).long()
    result = torch.full_like(keys, -1)
    done = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    for _ in range(MAX_PROBES):
        k = table_keys[idx]
        hit = (k == keys) & ~done
        miss = (k == EMPTY_KEY) & ~done
        result = torch.where(hit, table_slots[idx], result)
        done = done | hit | miss
        idx = torch.where(done, idx, (idx + 1) & mask)
        yield result, done


def lookup(table_keys: torch.Tensor, table_slots: torch.Tensor,
           keys: torch.Tensor, table_size: int) -> torch.Tensor:
    """Key -> slot; -1 for missing keys. A key's probe ends at its match or
    at the first EMPTY position."""
    for result, done in _probe(table_keys, table_slots, keys, table_size):
        if bool(done.all()):
            break
    return result


def lookup_bounded(table_keys: torch.Tensor, table_slots: torch.Tensor,
                   keys: torch.Tensor, table_size: int, rounds: int):
    """`lookup` in exactly `rounds` probe rounds, with no host sync: (slots,
    complete), `complete` a device bool that every probe ended (else the
    unfinished keys read -1)."""
    for i, (result, done) in enumerate(_probe(table_keys, table_slots, keys,
                                              table_size)):
        if i + 1 == rounds:
            break
    return result, done.all()


def insert(table_keys, table_slots, block_coords, n_blocks, keys, active,
           table_size: int, capacity: int, extent: int):
    """Batch-insert packed block keys; allocate slots for new blocks.

    Returns new (table_keys, table_slots, block_coords, n_blocks,
    overflowed); the inputs are not modified. Keys that find no table
    position within MAX_PROBES, or whose slot would pass `capacity`, count
    in `overflowed`; a claim rolled back for capacity becomes a TOMBSTONE
    so wrapped probe chains stay walkable."""
    mask = table_size - 1
    table_keys = table_keys.clone()
    idx = (mix(keys) & mask).long()
    pending = active.clone()
    for _ in range(MAX_PROBES):
        if not bool(pending.any()):
            break
        k = table_keys[idx]
        placed = (k == keys) & pending
        pending = pending & ~placed
        is_empty = ((k == EMPTY_KEY) | (k == TOMBSTONE_KEY)) & pending
        # Racing claim: of colliding writers an arbitrary one is kept.
        table_keys.index_put_((idx[is_empty],), keys[is_empty])
        won = (table_keys[idx] == keys) & pending
        pending = pending & ~won
        idx = torch.where(pending, (idx + 1) & mask, idx)

    # Slot assignment for newly claimed table positions, in table order.
    is_new = ((table_keys != EMPTY_KEY) & (table_keys != TOMBSTONE_KEY)
              & (table_slots < 0))
    order = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    new_slots = n_blocks + order
    fits = is_new & (new_slots < capacity)
    table_slots = torch.where(fits, new_slots, table_slots)
    table_keys = torch.where(is_new & ~fits,
                             torch.full_like(table_keys, TOMBSTONE_KEY),
                             table_keys)
    block_coords = block_coords.clone()
    block_coords[table_slots[fits].long()] = unpack_block_key(
        table_keys[fits], extent)
    n_new = fits.sum(dtype=torch.int32)
    slot_overflow = (is_new & ~fits).sum(dtype=torch.int32)
    probe_overflow = pending.sum(dtype=torch.int32)
    return (table_keys, table_slots, block_coords, n_blocks + n_new,
            slot_overflow + probe_overflow)


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
    keep = pos < budget
    n_tiles = budget // 8
    tile_groups = torch.full((n_tiles,), capacity // 8, dtype=torch.int32,
                             device=dev)
    tile_groups[(pos[keep] // 8).long()] = grp[keep]
    row = torch.arange(budget, dtype=torch.int32, device=dev) % 8
    fslots = tile_groups.repeat_interleave(8) * 8 + row
    freal = torch.zeros((budget,), dtype=torch.bool, device=dev)
    freal[pos[keep].long()] = isreal[keep]
    fcoords = torch.zeros((budget, 3), dtype=torch.int32, device=dev)
    fcoords[pos[keep].long()] = coords_u[keep]
    return (tk, ts, bc, nb, ov + dropped + group_overflow, fcoords, fslots,
            freal)
