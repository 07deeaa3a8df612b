"""Sorted segment reduction: the ray integrators' update-stream reduce.

Counterpart: kimera_semantics_tpu/ops/reduce.py (TRASH_KEY,
stable_compact_order, segmented_scan_sums, segment_compact_reduce,
SortedUpdates, sorted_scatter_add) and the in-order scatter-add of a
sorted index list (add_sorted_runs). The
update stream is sorted by key, summed within runs of equal keys by an exact
segmented scan, and the run totals are compacted to a static budget, so the
grid sees each (voxel, label) once per frame.

Sorts here are stable (`torch.sort(stable=True)`), where the JAX package's
are not: keys, counts and the number of dropped segments come out the same,
and float sums agree within rounding (the same Hillis-Steele tree, over
entries of equal key that may sit in another order). No sum goes through
`index_add_`/`scatter_add_`, whose atomics on CUDA would make two runs
differ.

`SortedUpdates` (scatter_mode "sorted") keeps the reference's form: one
stable sort, segment ends, and segment sums taken as differences of a
float32 cumsum, so a sum's rounding is set by the prefix magnitude, not by
the segment. On CUDA `torch.cumsum` is a parallel scan that rounds
differently from the CPU's sequential one: the difference is bounded by
the prefix magnitude times the float32 epsilon.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

TRASH_KEY = 0x7FFFFFFF


def stable_compact_order(keep_mask: torch.Tensor, max_out: int):
    """(kept (n,), order (n,)) with n = min(len, max_out): `order` holds the
    positions of keep_mask's True entries first, in their original order,
    then the dropped positions; `kept` flags which output slots are real."""
    order = torch.argsort((~keep_mask).to(torch.int8), stable=True)[:max_out]
    return keep_mask[order], order


def segmented_scan_sums(is_start: torch.Tensor, channels,
                        max_run: int | None = None):
    """Exact inclusive segmented prefix sums (Hillis-Steele with flags).

    Position i of a segment (delimited by `is_start`) holds the sum of its
    segment's entries up to i; additions only ever combine entries of one
    segment. `max_run` bounds the longest segment whose sum must be exact
    (the doubling stops once it covers it); longer segments get partial
    sums, which is only acceptable for discarded trash."""
    n = int(is_start.shape[0])
    limit = n if max_run is None else min(n, max_run)
    s_list = list(channels)
    f = is_start
    d = 1
    while d < limit:
        f_shift = torch.cat([torch.ones((d,), dtype=torch.bool,
                                        device=f.device), f[:-d]])
        for j, s in enumerate(s_list):
            s_shift = torch.cat([torch.zeros((d,), dtype=s.dtype,
                                             device=s.device), s[:-d]])
            s_list[j] = torch.where(f, s, s + s_shift)
        f = f | f_shift
        d *= 2
    return tuple(s_list)


def segment_compact_reduce(keys: torch.Tensor, channels, budget: int,
                           max_run: int | None = None,
                           active_frac: float | None = None):
    """Group-reduce an update stream by key and compact to a static budget.

    keys: (N,) int32, trash entries TRASH_KEY (their channel values must be
    zero); channels: tuple of (N,) float32. Returns (out_keys, out_sums,
    n_dropped): the unique keys ascending (TRASH_KEY past the segments),
    their channel totals, and the real segments that did not fit `budget`
    (plus, with `active_frac` < 1, the real entries beyond the first
    ceil(active_frac * N) sorted entries, which are sliced off before the
    scan, as in the reference)."""
    sk, perm = torch.sort(keys, stable=True)
    sch = [c[perm] for c in channels]
    pre_drop = torch.zeros((), dtype=torch.int32, device=keys.device)
    if active_frac is not None and active_frac < 1.0:
        n_keep = int(math.ceil(active_frac * sk.shape[0]))
        n_act = (keys != TRASH_KEY).sum(dtype=torch.int32)
        pre_drop = torch.clamp(n_act - n_keep, min=0)
        sk = sk[:n_keep]
        sch = [c[:n_keep] for c in sch]
    neq = sk[1:] != sk[:-1]
    one = torch.ones((1,), dtype=torch.bool, device=sk.device)
    is_start = torch.cat([one, neq])
    is_end = torch.cat([neq, one])
    scans = segmented_scan_sums(is_start, sch, max_run=max_run)
    valid_end = is_end & (sk != TRASH_KEY)
    ck = torch.where(valid_end, sk, torch.full_like(sk, TRASH_KEY))
    ok, order = torch.sort(ck, stable=True)
    order = order[:budget]
    n_seg = valid_end.sum(dtype=torch.int32)
    n_dropped = torch.clamp(n_seg - budget, min=0) + pre_drop
    return ok[:budget], tuple(s[order] for s in scans), n_dropped


def add_sorted_runs(buf: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                    keep: torch.Tensor):
    """buf[:, idx] += vals (C, N) where `keep`, for `idx` whose equal
    entries are adjacent. Each run of equal indices is summed first, left
    to right, and added once: the reference's in-order scatter-add, with
    the same result on every run (no atomics decide an order)."""
    idx, vals = idx[keep], vals[:, keep]
    n = idx.shape[0]
    if n == 0:
        return
    new = torch.ones((n,), dtype=torch.bool, device=idx.device)
    new[1:] = idx[1:] != idx[:-1]
    pos = torch.arange(n, device=idx.device)
    rank = pos - torch.cummax(torch.where(new, pos, 0), dim=0)[0]
    acc = vals
    for k in range(1, int(rank.max()) + 1):
        acc = torch.where(rank == k, acc.roll(1, dims=1) + vals, acc)
    last = torch.ones((n,), dtype=torch.bool, device=idx.device)
    last[:-1] = new[1:]
    buf.index_add_(1, idx[last].long(), acc[:, last])


def drop_add_(target_flat: torch.Tensor, idx: torch.Tensor,
              vals: torch.Tensor):
    """target_flat[idx] += vals with the reference's scatter semantics:
    negative indices count from the end (numpy), and indices still out of
    range are dropped (`mode="drop"`). torch has no drop mode, and on CUDA
    an out-of-range index is a device-side assert, so a dropped entry adds
    0.0 into the target's last word instead (the trash tile's, for a grid
    channel), on the CPU and on the card alike. Duplicate indices
    accumulate; on CUDA in an order that varies from run to run."""
    n = target_flat.shape[0]
    idx = idx.reshape(-1).long()
    vals = vals.reshape((idx.shape[0],) + tuple(target_flat.shape[1:]))
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    okv = ok.reshape((-1,) + (1,) * (vals.dim() - 1))
    target_flat.index_add_(0, torch.where(ok, idx, n - 1),
                           torch.where(okv, vals, torch.zeros_like(vals)))
    return target_flat


def sorted_scatter_add(target_flat: torch.Tensor, keys: torch.Tensor,
                       values: torch.Tensor, trash_key: int) -> torch.Tensor:
    """target_flat (M[, C]) += segment sums of values (N[, C]) grouped by
    keys (N,), in place; entries with key == trash_key are dropped."""
    return SortedUpdates.build(keys, trash_key).apply(target_flat, values)


class SortedUpdates:
    """One sort, many channels: the update stream sorted by key (and a
    secondary key), its segment ends, and one output key per segment."""

    def __init__(self, order, sorted_keys, ends, out_keys, mask,
                 sec_sorted=None):
        self.order = order                # (N,) sorting permutation
        self.sorted_keys = sorted_keys
        self.ends = ends                  # (N,) segment end positions
        self.out_keys = out_keys          # (N,) key per segment slot, -1 off
        self.mask = mask                  # (N,) bool: a real segment slot
        self._sec_sorted = sec_sorted

    @staticmethod
    def build(keys: torch.Tensor, trash_key: int,
              secondary: Optional[torch.Tensor] = None) -> "SortedUpdates":
        keys = keys.reshape(-1)
        n = keys.shape[0]
        idx = torch.arange(n, dtype=torch.int32, device=keys.device)
        if secondary is None:
            sk, order = torch.sort(keys, stable=True)
            sec_sorted = None
        else:
            secondary = secondary.reshape(-1)
            o2 = torch.argsort(secondary, stable=True)
            o1 = torch.argsort(keys[o2], stable=True)
            order = o2[o1]
            sk, sec_sorted = keys[order], secondary[order]
        # Segment end i: the last position of a run of equal (key[, sec]).
        neq = sk[:-1] != sk[1:]
        if sec_sorted is not None:
            neq = neq | (sec_sorted[:-1] != sec_sorted[1:])
        one = torch.ones((1,), dtype=torch.bool, device=keys.device)
        is_end = torch.cat([neq, one])
        # The ends compacted to the front, ascending (n past them).
        ends = torch.sort(torch.where(is_end, idx, n))[0]
        seg_count = is_end.sum(dtype=torch.int32)
        mask = (idx < seg_count) & (ends < n)
        safe_ends = torch.clamp(ends, max=n - 1).long()
        ek = sk[safe_ends]
        out_keys = torch.where(mask & (ek != trash_key), ek,
                               torch.full_like(ek, -1))
        return SortedUpdates(order, sk, safe_ends, out_keys, mask,
                             sec_sorted)

    def segment_sums(self, values: torch.Tensor) -> torch.Tensor:
        """Per-segment sums of values (N[, C]) at the segment slots, as
        differences of the float32 cumsum at the segment ends."""
        v = values.reshape((self.order.shape[0],) + tuple(values.shape[1:]))
        c = torch.cumsum(v[self.order].float(), dim=0)
        at_end = c[self.ends]
        prev = torch.cat([torch.zeros_like(at_end[:1]), at_end[:-1]])
        m = self.mask.reshape((-1,) + (1,) * (v.dim() - 1))
        return torch.where(m, at_end - prev, torch.zeros_like(at_end))

    def apply(self, target_flat: torch.Tensor, values: torch.Tensor,
              out_index: Optional[torch.Tensor] = None) -> torch.Tensor:
        """target_flat += the segment sums at their keys (or `out_index`),
        in place; slots with a negative key are dropped."""
        sums = self.segment_sums(values)
        keys = self.out_keys if out_index is None else out_index
        n = target_flat.shape[0]
        # Dropped slots aim past the end, as the reference's do.
        slot = torch.arange(keys.shape[0], device=keys.device)
        return drop_add_(target_flat, torch.where(keys >= 0, keys.long(),
                                                  n + slot), sums)

    def secondary_at_segments(self) -> torch.Tensor:
        """The sorted secondary key (e.g. the label) of each segment."""
        return self._sec_sorted[self.ends]
