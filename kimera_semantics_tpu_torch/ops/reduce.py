"""Sorted segment reduction: the ray integrators' update-stream reduce.

Counterpart: kimera_semantics_tpu/ops/reduce.py (TRASH_KEY,
stable_compact_order, segmented_scan_sums, segment_compact_reduce) and
the in-order scatter-add of a sorted index list (add_sorted_runs). The
update stream is sorted by key, summed within runs of equal keys by an exact
segmented scan, and the run totals are compacted to a static budget, so the
grid sees each (voxel, label) once per frame.

Sorts here are stable (`torch.sort(stable=True)`), where the JAX package's
are not: keys, counts and the number of dropped segments come out the same,
and float sums agree within rounding (the same Hillis-Steele tree, over
entries of equal key that may sit in another order). No sum goes through
`index_add_`/`scatter_add_`, whose atomics on CUDA would make two runs
differ. `SortedUpdates` (scatter_mode "sorted") is not ported yet.
"""

from __future__ import annotations

import math

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
