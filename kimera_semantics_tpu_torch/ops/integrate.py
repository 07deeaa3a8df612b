"""The ray integrators' per-frame voxel update: expand, allocate, resolve,
reduce, apply.

Counterpart: kimera_semantics_tpu/ops/integrate.py (_Stream, expand_jobs,
integrate_jobs, frame_cube, integrate_ray_batch, _segment_scatter_apply,
_staged_segment_apply). Every (step, job) pair of a frame's traversal jobs
becomes one element of an update stream; the stream is reduced to its
unique (voxel, label) segments and added into the grid once:

  1. expand   K1 dda_job_stream at voxel granularity, with block runs
  2. alloc    the runs' block keys, compacted and batch-inserted into the
              block hash table (grid/hash.py insert_compacted)
  3. resolve  K6 slot_resolve_stream against the frame's camera cube
              (frame_cube), or hash lookups of the runs where there is no
              cube (anti-grazing, integrate_ray_batch without an origin)
  4. reduce   ops/reduce.py segment_compact_reduce
  5. apply    compact group-aligned staging of the segments, then K5
              block_rmw_add into the grid (the staged apply); or, with
              PipelineConfig.staged_apply False, direct indexed adds

scatter_mode "direct" and "sorted" (the reference's debug baselines) skip
steps 3-5's segment reduce: slots resolve by hash lookups and every update
is added into the grid as it is (_plain_scatter_apply); "segment" takes
that plain tail too when the (voxel, label) key does not fit int32, as the
reference does.

The port always takes the reference's kernel route: K1's plain version
emits block runs too, so the reference's XLA scan form of the DDA is not
needed, and `PipelineConfig.use_pallas` has no effect here. The grid's
channel tensors are updated IN PLACE and the same VoxelGrid object is
returned with its hash-table and counter fields replaced.

Not ported yet (they raise NotImplementedError): spatial sharding
(shard_id/num_shards) and multi-frame anti-grazing (ag_frames > 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..config import ColorMode, FusionConfig
from ..core.fp import f32, fma
from ..grid import blocks as gblocks
from ..grid import hash as bhash
from ..grid.blocks import VoxelGrid
from ..models.common import stage
from . import kernels
from . import semantic
from .carve import JobBatch, full_jobs
from .reduce import (TRASH_KEY, SortedUpdates, add_sorted_runs, drop_add_,
                     segment_compact_reduce)

# Profiler ranges of the ray path, in order (models/common.py stage).
STAGES = ("expand", "alloc", "cube", "resolve", "reduce", "stage", "apply")


@dataclasses.dataclass
class _Stream:
    """Expanded (S, R) update-stream planes for one JobBatch."""
    keys: torch.Tensor        # (S, R) int32 packed block keys (-1 invalid)
    local: torch.Tensor       # (S, R) int32 in-block linear voxel index
    w: torch.Tensor           # (S, R) f32 weight contribution
    w_sdf: torch.Tensor       # (S, R) f32 weight * clamped sdf
    wc_gate: torch.Tensor     # (S, R) f32 colour-gated weight
    step_valid: torch.Tensor  # (S, R) bool
    run_key: torch.Tensor     # (MAXR, R) int32 block-run keys
    run_idx: torch.Tensor     # (S, R) int32 step -> run row
    labels: torch.Tensor      # (R,) int32 per-job labels
    colors: torch.Tensor      # (R, 3) f32 per-job colours
    job_valid: torch.Tensor   # (R,) bool
    slots: Optional[torch.Tensor] = None      # (S, R) int32 (hash path)
    key: Optional[torch.Tensor] = None        # (S, R) int32 flat voxel key
    valid_upd: Optional[torch.Tensor] = None  # (S, R) bool
    sem_upd: Optional[torch.Tensor] = None    # (S, R) bool
    k2: Optional[torch.Tensor] = None         # (S, R) (voxel, label) key
    wv: Optional[torch.Tensor] = None         # (S, R) masked w
    wsdfv: Optional[torch.Tensor] = None      # (S, R) masked w*sdf + trunc*w
    cntv: Optional[torch.Tensor] = None       # (S, R) semantic counts


def expand_jobs(cfg: FusionConfig, jobs: JobBatch, S: int) -> _Stream:
    """Stage 1: DDA-expand a JobBatch into its (S, R) update stream (K1)."""
    soa = lambda a: a.T.contiguous()  # noqa: E731
    keys, local, w, w_sdf, wc_gate, step_valid, run_key, run_idx = (
        kernels.dda_job_stream(cfg, S, soa(jobs.origin), soa(jobs.point),
                               soa(jobs.start), soa(jobs.end),
                               jobs.weight.contiguous(), jobs.valid))
    return _Stream(keys, local, w, w_sdf, wc_gate, step_valid, run_key,
                   run_idx, jobs.label, jobs.color, jobs.valid)


def _mask_stream(st: _Stream):
    st.w = torch.where(st.step_valid, st.w, 0.0)
    st.w_sdf = torch.where(st.step_valid, st.w_sdf, 0.0)
    st.wc_gate = torch.where(st.step_valid, st.wc_gate, 0.0)


def integrate_jobs(
    grid: VoxelGrid,
    cfg: FusionConfig,
    batches: Sequence[Tuple[JobBatch, int]],   # (jobs, step budget) pairs
    shard_id: Optional[torch.Tensor] = None,
    num_shards: int = 1,
    ag_dest_voxels: Optional[torch.Tensor] = None,  # (M, 3) anti-grazing
    ag_own_bundle: bool = False,
    ag_frames: int = 1,
    sem_points: Optional[tuple] = None,
    cube_origin: Optional[torch.Tensor] = None,     # (3,) or (B, 3)
) -> VoxelGrid:
    """Apply a frame's job batches to the grid, in place.

    `cube_origin`: camera origin(s) of the frame cube (frame_cube); slots
    then resolve through K6 against a dense block cube around the camera.
    (B, 3) = batched frames whose every stream's ray axis splits into B
    equal per-frame chunks. None resolves by hash lookups.

    `ag_dest_voxels`: the merged integrator's anti-grazing rule
    (_merged.cpp:306-313): traversed voxels that are destination voxels of
    the frame's ray bundles are skipped; with `ag_own_bundle` a batch-0 job
    may still update its own destination voxel.

    `sem_points`: (ray_idx, labels, valid, counts) of shape (P,), weighted
    per-(job, label) semantic votes riding batch 0's geometry (the merged
    integrator's histogram per bundle, in sparse form); batch 0's per-job
    labels should then be uninformative.
    """
    if shard_id is not None or num_shards != 1:
        raise NotImplementedError("spatial sharding (shard_id/num_shards) "
                                  "is not ported yet (slice E)")
    if ag_frames != 1:
        raise NotImplementedError("multi-frame anti-grazing (ag_frames > 1) "
                                  "is not ported yet (slice E)")
    g = cfg.grid
    vps, v3, cap, L = g.voxels_per_side, g.vps3, g.block_capacity, \
        g.num_labels
    lab_shift = max(1, (L - 1).bit_length())
    n_flat = (cap + 1) * v3
    use_segment = segment_key_fits(cfg)

    n_frames = (cube_origin.shape[0]
                if cube_origin is not None and cube_origin.dim() == 2 else 1)
    staged_ok = n_frames == 1 or sem_points is None
    staged_rows = min(cap - (cap % 8), cfg.pipeline.block_budget * n_frames)

    with stage("expand"):
        streams = [expand_jobs(cfg, jobs, S) for jobs, S in batches]
    use_cube = (use_segment and cube_origin is not None
                and ag_dest_voxels is None
                and kernels.cube_lut_supported(cfg)
                and all(st.local.shape[1] % n_frames == 0 for st in streams))

    with stage("alloc"):
        alloc_keys = torch.cat([st.run_key.reshape(-1) for st in streams])
        tk, ts, bc, nb, ov = bhash.insert_compacted(
            grid.table_keys, grid.table_slots, grid.block_coords,
            grid.n_blocks, alloc_keys, alloc_keys >= 0, g.table_size, cap,
            g.world_extent_blocks)
        grid.table_keys, grid.table_slots, grid.block_coords = tk, ts, bc
        grid.n_blocks = nb
        grid.overflow = grid.overflow + ov

    lk = semantic.make_likelihood_cached(cfg)
    touched = []
    if use_cube:
        with stage("cube"):
            cube_vals, cam_block = frame_cube(grid, cfg, cube_origin)
        gate_near = cfg.semantic.update_near_surface_only
        with stage("resolve"):
            for st in streams:
                inform = semantic.informative(st.labels) & st.job_valid
                (st.k2, st.wv, st.wsdfv, st.cntv, st.key, st.valid_upd,
                 run_slots) = kernels.slot_resolve_stream(
                    cfg, cube_vals, cam_block, st.run_key, st.run_idx,
                    st.local, st.w, st.w_sdf, st.wc_gate, st.step_valid,
                    st.labels, inform, lab_shift, gate_near)
                st.sem_upd = (st.valid_upd & (st.wc_gate > 0.0) if gate_near
                              else st.valid_upd)
                touched.append(torch.where(run_slots >= 0, run_slots,
                                           cap).reshape(-1))
        return _segment_scatter_apply(
            grid, cfg, streams, torch.cat(touched), lab_shift, lk,
            sem_points=sem_points, staged_ok=staged_ok,
            staged_rows=staged_rows)

    with stage("resolve"):
        lut = bhash.lookup(grid.table_keys, grid.table_slots, alloc_keys,
                           g.table_size)
        off = 0
        for st in streams:
            n = st.run_key.numel()
            run_slots = lut[off:off + n].reshape(st.run_key.shape)
            off += n
            run_slots = torch.where((st.run_key >= 0) & (run_slots >= 0),
                                    run_slots, cap)
            slots = run_slots.gather(0, st.run_idx.clamp(min=0).long())
            st.slots = torch.where(st.step_valid, slots, cap)
            st.key = st.slots * v3 + st.local
            touched.append(run_slots.reshape(-1))

        if ag_dest_voxels is not None:
            dblock, dlin = gblocks.voxel_to_block_local(ag_dest_voxels, vps)
            dslots = gblocks.lookup_slots(grid, dblock, g)
            dkey = torch.where(dslots < cap, dslots * v3 + dlin, n_flat)
            dest_mask = torch.zeros((n_flat + 1,), dtype=torch.bool,
                                    device=dkey.device)
            dest_mask[dkey.long()] = True
            for bi, st in enumerate(streams):
                hit = dest_mask[st.key.long()]
                if ag_own_bundle and bi == 0:
                    hit = hit & (st.key != dkey[None, :st.key.shape[1]])
                st.step_valid = st.step_valid & ~hit
                _mask_stream(st)
                st.key = torch.where(st.step_valid, st.key,
                                     cap * v3 + st.local)
    if not use_segment:
        with stage("apply"):
            return _plain_scatter_apply(grid, cfg, streams,
                                        torch.cat(touched), lk,
                                        sem_points=sem_points)
    return _segment_scatter_apply(
        grid, cfg, streams, torch.cat(touched), lab_shift, lk,
        sem_points=sem_points, staged_ok=staged_ok, staged_rows=staged_rows)


def segment_key_fits(cfg: FusionConfig) -> bool:
    """Whether integrate_jobs takes the segment reduce: scatter_mode
    "segment" and a combined (voxel, label) key
    ((capacity + 1) * vps^3) << ceil(log2 L) that fits int32. Otherwise the
    plain tail (_plain_scatter_apply) applies the updates, as in the
    reference. Decided from the configuration alone, before any grid or
    stream exists."""
    g = cfg.grid
    lab_shift = max(1, (g.num_labels - 1).bit_length())
    n_flat = (g.block_capacity + 1) * g.vps3
    return (cfg.pipeline.scatter_mode == "segment"
            and (n_flat << lab_shift) < 2 ** 31)


def frame_cube(grid: VoxelGrid, cfg: FusionConfig, origin: torch.Tensor):
    """The frame's dense block -> slot cube around the camera block:
    (vals (B, pad) float32, -1 where the block is missing or out of world
    bounds; cam_block (B, 3) int32), origin (3,) or (B, 3)."""
    g = cfg.grid
    E, side, pad = kernels.cube_geometry(cfg)
    origin = origin.reshape(-1, 3)
    B = origin.shape[0]
    ob = torch.floor(origin / f32(g.block_size)).to(torch.int32)
    r = torch.arange(side, dtype=torch.int32, device=origin.device) - E
    rel = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                      dim=-1).reshape(-1, 3)
    coords = rel[None, :, :] + ob[:, None, :]
    ext = g.world_extent_blocks
    inb = bhash.in_bounds(coords, ext)
    keys = bhash.pack_block_coords(torch.clamp(coords, -ext, ext - 1), ext)
    keys = torch.where(inb, keys, -3)
    slots = bhash.lookup(grid.table_keys, grid.table_slots,
                         keys.reshape(-1), g.table_size).reshape(keys.shape)
    vals = torch.where(inb & (slots >= 0), slots.float(), -1.0)
    vals = torch.nn.functional.pad(vals, (0, pad - side ** 3), value=-1.0)
    return vals.contiguous(), ob


def integrate_ray_batch(grid: VoxelGrid, cfg: FusionConfig, origin,
                        points_G, weights, colors, labels, is_clearing,
                        ray_valid, **kw) -> VoxelGrid:
    """One full-traversal ray batch with voxblox extents; extra keyword
    arguments pass to integrate_jobs."""
    origin = origin.expand(points_G.shape)
    jobs = full_jobs(origin, points_G, weights, labels, colors, is_clearing,
                     ray_valid, cfg)
    return integrate_jobs(grid, cfg, [(jobs, cfg.resolved_max_steps())], **kw)


def _plain_scatter_apply(grid, cfg, streams, touched_slots, lk,
                         sem_points=None):
    """scatter_mode "direct" and "sorted" (and "segment" where its key
    does not fit int32): every update of the streams added into the grid
    as it is, by indexed adds ("direct") or through SortedUpdates, one sort
    and cumsum-difference segment sums per key set ("sorted").
    Mathematically the same grid as the segment path; "direct" on CUDA adds
    duplicates with float atomics, so two card runs may differ in the last
    bits."""
    g, L = cfg.grid, cfg.grid.num_labels
    row_flat = g.padded_rows * g.vps3
    flat = lambda t: t.view(-1)  # noqa: E731

    kf = torch.cat([st.key.reshape(-1) for st in streams])
    wf = torch.cat([st.w.reshape(-1) for st in streams])
    wsdff = torch.cat([st.w_sdf.reshape(-1) for st in streams])

    sorted_mode = cfg.pipeline.scatter_mode == "sorted"
    if sorted_mode:
        su = SortedUpdates.build(kf, trash_key=-1)
        scat = su.apply
    else:
        scat = lambda tgt, vals: drop_add_(tgt, kf, vals)  # noqa: E731

    scat(flat(grid.wsum), wf)
    scat(flat(grid.wsdf), wsdff)
    if cfg.semantic.color_mode == ColorMode.COLOR:
        for c in range(3):
            vals = torch.cat([(st.wc_gate * st.colors[None, :, c])
                              .reshape(-1) for st in streams])
            scat(flat(grid.wcolor[c]), vals)

    def sem_step(st):
        return (st.step_valid & (st.wc_gate > 0.0)
                if cfg.semantic.update_near_surface_only else st.step_valid)

    label_hist = None
    if sem_points is not None:
        # The sparse votes folded back into per-ray histograms of batch 0.
        pr, pl_, pv, pc = sem_points
        R0 = streams[0].key.shape[1]
        pl_ = torch.where(pl_ < 0, pl_ + L, pl_).long()
        ok = (pl_ >= 0) & (pl_ < L)
        label_hist = torch.zeros((R0 * L + 1,), dtype=torch.float32,
                                 device=kf.device)
        label_hist.index_add_(
            0, torch.where(ok, pr.long() * L + pl_, R0 * L),
            torch.where(pv & ok, pc, 0.0))
        label_hist = label_hist[:R0 * L].reshape(R0, L)

    for bi, st in enumerate(streams):
        ss = sem_step(st)
        kfs = st.key.reshape(-1)
        if sorted_mode:
            sus = SortedUpdates.build(kfs, trash_key=-1)
            scs = sus.apply
        else:
            def scs(tgt, vals, k=kfs):
                return drop_add_(tgt, k, vals)
        if bi == 0 and label_hist is not None:
            # The merged integrator: each ray's histogram applied to every
            # voxel it traverses (_merged.cpp:254-328); unknown adds 0.
            hist = label_hist.clone()
            hist[:, semantic.UNKNOWN_LABEL] = 0.0
            total = hist.sum(dim=-1)
            scs(flat(grid.sem_count),
                torch.where(ss, total[None, :], 0.0).reshape(-1))
            for lab in range(L):
                add = torch.where(ss, hist[:, lab][None, :], 0.0) * f32(
                    lk.delta)
                scs(flat(grid.sem_delta[lab]), add.reshape(-1))
            continue
        # One label per job: scalar adds at (label, key).
        inform = semantic.informative(st.labels) & st.job_valid
        cnt = torch.where(ss & inform[None, :], 1.0, 0.0)
        scs(flat(grid.sem_count), cnt.reshape(-1))
        lab_b = st.labels[None, :].to(torch.int64).expand(st.key.shape)
        if sorted_mode:
            su2 = SortedUpdates.build(kfs, trash_key=-1,
                                      secondary=lab_b.reshape(-1))
            seg_lab = su2.secondary_at_segments()
            out_idx = torch.where(su2.out_keys >= 0,
                                  seg_lab * row_flat + su2.out_keys, -1)
            su2.apply(flat(grid.sem_delta), cnt.reshape(-1) * f32(lk.delta),
                      out_index=out_idx)
        else:
            lkey = torch.where(cnt > 0, lab_b * row_flat + st.key,
                               L * row_flat)
            drop_add_(flat(grid.sem_delta), lkey,
                      torch.full(lkey.shape, f32(lk.delta),
                                 device=lkey.device))

    grid.updated[touched_slots.long()] = True
    return grid


def _segment_scatter_apply(grid, cfg, streams, touched_slots, lab_shift, lk,
                           sem_points=None, staged_ok=True, staged_rows=None):
    """Reduce the concatenated update streams to their unique (voxel,
    label) segments, then apply them: staged through K5, or (staged_apply
    False) by direct indexed adds. The signed w*sdf channel rides the
    reduce as w*(sdf + trunc) >= 0 and is recovered after it."""
    g, t = cfg.grid, cfg.tsdf
    v3, cap, L = g.vps3, g.block_capacity, g.num_labels
    n_flat = (cap + 1) * v3
    B = cfg.pipeline.segment_budget
    trunc = f32(t.truncation_distance)
    frac = cfg.pipeline.stream_active_fraction

    with stage("reduce"):
        k2s, wvs, wsdfs, cnts = [], [], [], []
        n_jobs_total = 0
        for st in streams:
            n_jobs_total += st.local.shape[1]
            if st.k2 is not None:
                k2s.append(st.k2.reshape(-1))
                wvs.append(st.wv.reshape(-1))
                wsdfs.append(st.wsdfv.reshape(-1))
                cnts.append(st.cntv.reshape(-1))
                continue
            st.valid_upd = st.step_valid & (st.slots < cap)
            k2, wv, wsdfv, st.sem_upd, cnt = kernels.segment_inputs(
                st.valid_upd, st.key, st.w, st.w_sdf, st.wc_gate,
                torch.clamp(st.labels, 0, (1 << lab_shift) - 1),
                semantic.informative(st.labels) & st.job_valid, trunc,
                lab_shift, cfg.semantic.update_near_surface_only)
            for out, x in ((k2s, k2), (wvs, wv), (wsdfs, wsdfv),
                           (cnts, cnt)):
                out.append(x.reshape(-1))
        ok, (tw, tsdf_s, tcnt), n_drop = segment_compact_reduce(
            torch.cat(k2s), (torch.cat(wvs), torch.cat(wsdfs),
                             torch.cat(cnts)), B,
            max_run=n_jobs_total, active_frac=frac)

        pvotes = None
        if sem_points is not None:
            pr, pl_, pv, pc = sem_points
            st0 = streams[0]
            pr = pr.long()
            pkey = st0.key.T[pr]                                # (P, S)
            pupd = st0.sem_upd.T[pr] & (pv & semantic.informative(pl_)
                                        )[:, None]
            plab = torch.clamp(pl_, 0, (1 << lab_shift) - 1)[:, None]
            k2p = torch.where(pupd, (pkey << lab_shift) | plab, TRASH_KEY)
            pcnt = torch.where(pupd, pc[:, None], 0.0)
            okp, (tpcnt,), n_drop_p = segment_compact_reduce(
                k2p.reshape(-1), (pcnt.reshape(-1),), B,
                max_run=pkey.shape[0], active_frac=frac)
            n_drop = n_drop + n_drop_p
            pvotes = (okp, tpcnt)

        csegs = None
        if cfg.semantic.color_mode == ColorMode.COLOR:
            kv = torch.cat([torch.where(st.valid_upd, st.key,
                                        TRASH_KEY).reshape(-1)
                            for st in streams])
            chans = tuple(torch.cat([(st.wc_gate * st.colors[None, :, c])
                                     .reshape(-1) for st in streams])
                          for c in range(3))
            okc, tcol, n_drop_c = segment_compact_reduce(
                kv, chans, B, max_run=n_jobs_total, active_frac=frac)
            n_drop = n_drop + n_drop_c
            csegs = (okc, tcol)

    if staged_rows is None:
        staged_rows = cfg.pipeline.block_budget
    v3_tiled = (v3 % 128 == 0 and (v3 <= 8192 or v3 % 8192 == 0)
                and staged_rows % 8 == 0)
    if staged_ok and cfg.pipeline.staged_apply and v3_tiled:
        return _staged_segment_apply(
            grid, cfg, ok, (tw, tsdf_s, tcnt), touched_slots, lab_shift, lk,
            n_drop, pvotes=pvotes, csegs=csegs, Kb=staged_rows)

    with stage("apply"):
        row_flat = g.padded_rows * v3
        seg = ok != TRASH_KEY
        vox = (ok >> lab_shift)[seg].long()
        lab_seg = (ok & ((1 << lab_shift) - 1))[seg].long()
        # A voxel's segments (one per label) are adjacent: their sums are
        # added in order, as the reference's sorted scatter does.
        every = torch.ones_like(vox, dtype=torch.bool)
        for ch, v in ((grid.wsum, tw[seg]),
                      (grid.wsdf, fma(tw[seg], -trunc, tsdf_s[seg])),
                      (grid.sem_count, tcnt[seg])):
            add_sorted_runs(ch.view(1, -1), vox, v[None], every)
        grid.sem_delta.view(-1).index_add_(0, lab_seg * row_flat + vox,
                                           tcnt[seg] * f32(lk.delta))
        if pvotes is not None:
            okp, tpcnt = pvotes
            pseg = okp != TRASH_KEY
            pvox = (okp >> lab_shift)[pseg].long()
            plab = (okp & ((1 << lab_shift) - 1))[pseg].long()
            # Counts are integral: their sums are exact in any order.
            grid.sem_count.view(-1).index_add_(0, pvox, tpcnt[pseg])
            grid.sem_delta.view(-1).index_add_(
                0, plab * row_flat + pvox, tpcnt[pseg] * f32(lk.delta))
        if csegs is not None:
            okc, tcol = csegs
            cseg = okc != TRASH_KEY
            for c in range(3):
                grid.wcolor[c].view(-1).index_add_(
                    0, okc[cseg].long(), tcol[c][cseg])
        grid.updated[touched_slots.long()] = True
        grid.overflow = grid.overflow + n_drop
    return grid


def _staged_segment_apply(grid, cfg, ok, sums, touched_slots, lab_shift, lk,
                          n_drop, pvotes=None, csegs=None, Kb=None):
    """Apply the compacted (voxel, label) segments through K5.

    1. Segments arrive sorted by (voxel << lab_shift | label), i.e. by
       slot: tile groups (slot // 8) are ranked in order of appearance and
       slot s goes to staging row group_rank * 8 + s % 8.
    2. Staging buffers (Kb rows) collect w, wsdf and counts, and the
       semantic votes as P packed rank planes of count * 32 + label (or L
       dense planes), plus COLOR-mode colour sums.
    3. One block_rmw_add (K5) adds them into the grid.

    Blocks beyond the Kb staging rows, votes past rank P-1 and counts of
    2^19 or more are dropped and counted in grid.overflow."""
    g, t = cfg.grid, cfg.tsdf
    v3, cap, L = g.vps3, g.block_capacity, g.num_labels
    n_flat = (cap + 1) * v3
    if Kb is None:
        Kb = cfg.pipeline.block_budget
    n_tiles = Kb // 8
    trash_group = cap // 8
    trunc = f32(t.truncation_distance)
    tw, tsdf_s, tcnt = sums
    dev = ok.device
    dump = Kb * v3
    lab_mask = (1 << lab_shift) - 1

    with stage("stage"):
        seg_valid = ok != TRASH_KEY
        vox = torch.where(seg_valid, ok >> lab_shift, n_flat)
        lab = ok & lab_mask
        slot = torch.div(vox, v3, rounding_mode="floor")
        local = vox % v3
        grp = torch.div(slot, 8, rounding_mode="floor")

        newg = seg_valid.clone()
        newg[1:] &= grp[1:] != grp[:-1]
        grank = torch.cumsum(newg.to(torch.int32), 0, dtype=torch.int32) - 1
        pos = torch.where(seg_valid, grank * 8 + slot % 8, Kb)
        group_overflow = ((pos >= Kb) & seg_valid).sum(dtype=torch.int32)
        rvox = torch.where(pos < Kb, pos * v3 + local, dump)
        first = newg & (grank < n_tiles)
        tile_groups = torch.full((n_tiles,), trash_group, dtype=torch.int32,
                                 device=dev)
        tile_groups[grank[first].long()] = grp[first]
        row = torch.arange(Kb, dtype=torch.int32, device=dev) % 8
        fslots = tile_groups.repeat_interleave(8) * 8 + row
        glut = torch.full((cap // 8 + 2,), n_tiles, dtype=torch.int32,
                          device=dev)
        glut[grp[first].long()] = grank[first]

        st0 = torch.zeros((3, Kb * v3), dtype=torch.float32, device=dev)
        add_sorted_runs(st0, rvox, torch.stack([tw, fma(tw, -trunc, tsdf_s),
                                                tcnt]), rvox != dump)

        packed = (cfg.pipeline.sem_stage_mode == "packed"
                  and (1 << lab_shift) <= 32)
        P = cfg.pipeline.sem_stage_ranks if packed else L
        rank_drop = torch.zeros((), dtype=torch.int32, device=dev)
        cnt_max = float(2 ** 19 - 1)

        def clamp_cnt(c, drop):
            over = (c > cnt_max).sum(dtype=torch.int32)
            return torch.clamp(c, max=cnt_max), drop + over

        def label_ranks(vx, valid, cnt, lb):
            """Rank among the nonzero-count pairs of the same voxel in a
            (voxel, label)-sorted list."""
            has = valid & (cnt > 0.0) & (lb < L)
            hi = has.to(torch.int32)
            c = torch.cumsum(hi, 0, dtype=torch.int32)
            newv = torch.ones_like(has)
            newv[1:] = vx[1:] != vx[:-1]
            base = torch.cummax(torch.where(newv, c - hi, -1), dim=0)[0]
            return torch.where(has, c - hi - base, -1), has

        st_sem = torch.zeros((P * Kb * v3,), dtype=torch.float32, device=dev)

        def stage_votes(vx, valid, cnt, lb, rvx, in_rows, drop,
                        first_rank=None):
            """Add one sorted (voxel, label) list's votes into st_sem; each
            (plane, row voxel) receives at most one of them. Packed ranks
            start at `first_rank` (per entry) where another list already
            holds ranks of the same voxel."""
            if packed:
                rank, has = label_ranks(vx, valid, cnt, lb)
                if first_rank is not None:
                    rank = torch.where(has, rank + first_rank, rank)
                drop = drop + (rank >= P).sum(dtype=torch.int32)
                cnt_p, drop = clamp_cnt(cnt, drop)
                sel = has & (rank >= 0) & (rank < P) & in_rows
                st_sem.index_add_(0, (rank * dump + rvx)[sel].long(),
                                  fma(cnt_p, 32.0, lb.float())[sel])
            else:
                sel = in_rows & valid & (lb < L)
                st_sem.index_add_(0, (lb * dump + rvx)[sel].long(), cnt[sel])
            return drop

        rank_drop = stage_votes(vox, seg_valid, tcnt, lab, rvox, pos < Kb,
                                rank_drop)

        vote_drop = torch.zeros((), dtype=torch.int32, device=dev)
        if pvotes is not None:
            okp, tpcnt = pvotes
            pvalid = okp != TRASH_KEY
            pvox = torch.where(pvalid, okp >> lab_shift, n_flat)
            plab = okp & lab_mask
            pslot = torch.div(pvox, v3, rounding_mode="floor")
            pg = glut[torch.clamp(torch.div(pslot, 8, rounding_mode="floor"),
                                  max=cap // 8 + 1).long()]
            ppos = torch.where(pvalid & (pg < n_tiles), pg * 8 + pslot % 8,
                               Kb)
            prvox = torch.where(ppos < Kb, ppos * v3 + pvox % v3, dump)
            vote_drop = (pvalid & (tpcnt > 0) & (ppos >= Kb)).sum(
                dtype=torch.int32)
            # The votes' packed ranks follow those the main list holds at
            # the same voxel. (The reference starts both lists at rank 0,
            # which adds two count*32+label codes into one plane slot when
            # jobs with informative labels, the decimated carve jobs, share
            # a voxel with votes: ROADMAP faults.)
            main_has = (seg_valid & (tcnt > 0.0) & (lab < L)).to(torch.int32)
            n_main = torch.nn.functional.pad(
                torch.cumsum(main_has, 0, dtype=torch.int32), (1, 0))
            held = (n_main[torch.searchsorted(vox, pvox, right=True)]
                    - n_main[torch.searchsorted(vox, pvox)])
            rank_drop = stage_votes(pvox, pvalid, tpcnt, plab, prvox,
                                    ppos < Kb, rank_drop, first_rank=held)
            zero = torch.zeros_like(tpcnt)
            add_sorted_runs(st0, prvox, torch.stack([zero, zero, tpcnt]),
                            prvox != dump)

        d_wc = None
        color_drop = torch.zeros((), dtype=torch.int32, device=dev)
        if csegs is not None:
            okc, tcol = csegs
            cvalid = okc != TRASH_KEY
            cvox = torch.where(cvalid, okc, n_flat)
            cslot = torch.div(cvox, v3, rounding_mode="floor")
            cg = glut[torch.clamp(torch.div(cslot, 8, rounding_mode="floor"),
                                  max=cap // 8 + 1).long()]
            cpos = torch.where(cvalid & (cg < n_tiles), cg * 8 + cslot % 8,
                               Kb)
            crvox = torch.where(cpos < Kb, cpos * v3 + cvox % v3, dump)
            color_drop = (cvalid & (cpos >= Kb)).sum(dtype=torch.int32)
            stc = torch.zeros((3, Kb * v3), dtype=torch.float32, device=dev)
            add_sorted_runs(stc, crvox, torch.stack(tcol), crvox != dump)
            d_wc = stc.reshape(3, Kb, v3).permute(1, 0, 2).contiguous()

    with stage("apply"):
        d_w, d_wsdf, d_cnt = st0.reshape(3, Kb, v3)
        kernels.block_rmw_add(
            grid.wsum, grid.wsdf, grid.sem_count, grid.sem_delta,
            grid.wcolor, fslots, d_w, d_wsdf, d_cnt, None, d_wc,
            lk_delta=lk.delta, d_sem=st_sem.reshape(P, Kb, v3),
            sem_packed_ranks=P if packed else 0)
        grid.updated[touched_slots.long()] = True
        grid.overflow = (grid.overflow + n_drop + group_overflow + rank_drop
                         + vote_drop + color_drop)
    return grid
