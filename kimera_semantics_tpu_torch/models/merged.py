"""Merged semantic TSDF integrator: ray bundling.

Counterpart: kimera_semantics_tpu/models/merged.py (_bundle, _bundle_scan,
_bundle_prepare, _frame_parts, integrate_frame,
MergedSemanticTsdfIntegrator, integrate_frames), the capability of
`kimera::MergedSemanticTsdfIntegrator`
(kimera_semantics/src/semantic_tsdf_integrator_merged.cpp): points are
binned by destination voxel (bundleRays, _merged.cpp:110-124), each bin
becomes one weighted-average ray carrying a label histogram (:254-285), and
the merged rays update every voxel they cross with the histogram
(:288-328). Clearing rays take the first point of each bin (:282-284).

Binning is a lexicographic sort on packed voxel keys and a segment reduce;
the histogram rides the update as sparse (bundle, label) votes
(ops/integrate.py sem_points). In the banded carve modes the bundles walk
their truncation band and free space is carved densely (projective) or by
decimated jobs; carve_mode "full" runs the reference's two passes (normal
then clearing bundles) at full length. The grid is updated IN PLACE.
"""

from __future__ import annotations

import torch

from ..config import FusionConfig
from ..core.camera import PinholeIntrinsics
from ..device import check_on, resolve
from ..grid.blocks import VoxelGrid, point_to_voxel
from ..ops import carve as carve_ops
from ..ops import semantic
from ..ops.integrate import integrate_jobs, integrate_ray_batch
from ..ops.reduce import (TRASH_KEY, add_sorted_runs, segment_compact_reduce,
                          segmented_scan_sums, stable_compact_order)
from . import common
from .fast import (_cat_jobs, _maybe_projective_carve,
                   _projective_carve_batched)

_EPS_WEIGHT = 1e-6  # voxblox kEpsilon gate on point weights


def _sort_by_voxel(points_G, weights, colors, labels, active,
                   voxel_size_inv: float):
    """Points sorted by destination voxel (inactive last), as (perm, is_first
    of each bin, w, pg, col, lab, act, vox) in sorted order."""
    n = points_G.shape[0]
    vox = point_to_voxel(points_G, voxel_size_inv)
    c = torch.clamp(vox + (1 << 14), 0, (1 << 15) - 1).to(torch.int64)
    key_hi = torch.where(active, (c[:, 0] << 15) | c[:, 1], 0x7FFFFFFF)
    perm = torch.argsort((key_hi << 32) | c[:, 2], stable=True)
    key = ((key_hi << 32) | c[:, 2])[perm]
    is_first = torch.ones((n,), dtype=torch.bool, device=points_G.device)
    is_first[1:] = key[1:] != key[:-1]
    w, pg, col, lab, act, vox_p = common.gather_packed(
        perm, torch.where(active, weights, 0.0), points_G, colors, labels,
        active, vox)
    return perm, is_first, w, pg, col, lab, act, vox_p


def _bundle(points_G, weights, colors, labels, active, *,
            voxel_size_inv: float, num_labels: int, max_bundles: int):
    """Bin points by destination voxel; reduce each bin to one merged ray.

    Returns per-bundle (valid, point_G, weight, color, hist, first_idx,
    dest, seg_orig, n_dropped): first_idx is the original index of the
    bin's first point, seg_orig the bundle of each point in the original
    order, n_dropped the bins beyond max_bundles. Weighted sums add the
    bin's points in sorted order, as the reference's scatter does."""
    n = points_G.shape[0]
    dev = points_G.device
    perm, is_first, w, pg, col, lab, act, vox_p = _sort_by_voxel(
        points_G, weights, colors, labels, active, voxel_size_inv)
    contrib = w > _EPS_WEIGHT
    seg = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32) - 1
    n_bins = (is_first & act).sum(dtype=torch.int32)
    n_dropped = torch.clamp(n_bins - max_bundles, min=0)
    seg = torch.where(act, seg, max_bundles)
    inb = seg < max_bundles

    wc = w * contrib
    sums = torch.zeros((7, max_bundles), dtype=torch.float32, device=dev)
    add_sorted_runs(sums, seg, torch.cat([wc[None], (wc[:, None] * pg).T,
                                          (wc[:, None] * col).T]), inb)
    wsum, wpoint, wcolor = sums[0], sums[1:4].T, sums[4:7].T
    hist = torch.zeros((max_bundles * num_labels,), dtype=torch.float32,
                       device=dev)
    # Counts are integral: their sums are exact in any order.
    hist.index_add_(0, (seg * num_labels + lab)[inb].long(),
                    contrib[inb].float())
    hist = hist.reshape(max_bundles, num_labels)
    dest = torch.zeros((max_bundles + 1, 3), dtype=torch.int32, device=dev)
    dest.scatter_reduce_(0, seg.long()[:, None].expand(n, 3).clamp(
        max=max_bundles), vox_p + (1 << 14), reduce="amax")
    first_idx = torch.full((max_bundles + 1,), n, dtype=torch.int32,
                           device=dev)
    first_idx.scatter_reduce_(0, seg.long().clamp(max=max_bundles),
                              perm.to(torch.int32), reduce="amin")
    valid = wsum > _EPS_WEIGHT
    denom = torch.clamp(wsum[:, None], min=1e-12)
    seg_orig = torch.full((n,), max_bundles, dtype=torch.int32, device=dev)
    seg_orig[perm] = torch.where(act & contrib, seg, max_bundles)
    return (valid, wpoint / denom, wsum, wcolor / denom, hist,
            first_idx[:max_bundles], dest[:max_bundles] - (1 << 14), seg_orig,
            n_dropped)


def _bundle_scan(points_G, weights, colors, labels, active, *,
                 voxel_size_inv: float, max_bundles: int):
    """Scan-form bundling for the banded paths: sort by destination voxel,
    segmented-scan the weighted sums, compact the bin ends to bin rank
    order. Returns (valid, point, weight, color, seg_sorted, lab_sorted,
    act_sorted, contrib_sorted, dest, n_dropped), the per-point streams in
    sorted order."""
    perm, is_first, w, pg, col, lab, act, vox_p = _sort_by_voxel(
        points_G, weights, colors, labels, active, voxel_size_inv)
    contrib = w > _EPS_WEIGHT
    wc = torch.where(contrib, w, 0.0)
    seg = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32) - 1
    n_bins = (is_first & act).sum(dtype=torch.int32)
    n_dropped = torch.clamp(n_bins - max_bundles, min=0)
    scans = segmented_scan_sums(
        is_first, (wc, wc * pg[:, 0], wc * pg[:, 1], wc * pg[:, 2],
                   wc * col[:, 0], wc * col[:, 1], wc * col[:, 2]))
    is_end = torch.ones_like(is_first)
    is_end[:-1] = is_first[1:]
    bin_ok, order_e = stable_compact_order(is_end & act, max_bundles)
    if order_e.shape[0] < max_bundles:     # fewer points than bundles
        short = max_bundles - order_e.shape[0]
        order_e = torch.nn.functional.pad(order_e, (0, short))
        bin_ok = torch.nn.functional.pad(bin_ok, (0, short))
    sums = common.gather_packed(order_e, *scans)
    wsum = torch.where(bin_ok, sums[0], 0.0)
    valid = wsum > _EPS_WEIGHT
    denom = torch.clamp(wsum[:, None], min=1e-12)
    point = torch.stack(sums[1:4], dim=-1) / denom
    colorb = torch.stack(sums[4:7], dim=-1) / denom
    dest = torch.where(bin_ok[:, None], vox_p[order_e], -(1 << 14))
    return (valid, point, wsum, colorb, seg, lab, act, contrib, dest,
            n_dropped)


def _projective_carve(cfg: FusionConfig) -> bool:
    """Whether free space is carved densely (models/fast.py
    _maybe_projective_carve). Anti-grazing masks the destination voxels of
    each traversal, which the dense carve cannot honour: it keeps the
    decimated carve jobs."""
    return (cfg.tsdf.carve_mode == "projective"
            and cfg.tsdf.voxel_carving_enabled
            and not cfg.tsdf.enable_anti_grazing)


def _bundle_votes(inputs, cfg: FusionConfig):
    """Pass-1 bundling of a frame's normal points and its sparse (bundle,
    label) votes: each nonzero pair votes its count along the merged ray
    (the histogram of _merged.cpp:254-285 in sparse form). Reads nothing
    of the grid. Returns (bvalid, bpoint, bweight, bcolor, bdest, sem_pts,
    n_dropped): bundles beyond max_rays and pairs beyond 2 max_rays are
    counted in n_dropped."""
    pts_G, colors, labels, weights, valid, is_clearing = inputs
    R = cfg.pipeline.max_rays
    L = cfg.grid.num_labels
    (bvalid, bpoint, bweight, bcolor, seg_s, lab_s, act_s, contrib_s,
     bdest, bin_drop) = _bundle_scan(
        pts_G, weights, colors, labels, valid & ~is_clearing,
        voxel_size_inv=1.0 / cfg.grid.voxel_size, max_bundles=R)
    n_pts = pts_G.shape[0]
    p_ray = torch.clamp(seg_s, max=R - 1)
    p_valid = (act_s & contrib_s & (seg_s < R) & bvalid[p_ray.long()]
               & semantic.informative(lab_s))
    lab_shift = max(1, (L - 1).bit_length())
    lab_c = torch.clamp(lab_s, 0, (1 << lab_shift) - 1)
    pair_key = torch.where(p_valid, (p_ray << lab_shift) | lab_c, TRASH_KEY)
    pk, (pcounts,), pair_drop = segment_compact_reduce(
        pair_key, (torch.where(p_valid, 1.0, 0.0),), 2 * R, max_run=n_pts)
    sp_valid = pk != TRASH_KEY
    sp_ray = torch.where(sp_valid, pk >> lab_shift, 0)
    sp_lab = torch.where(sp_valid, pk & ((1 << lab_shift) - 1), 0)
    return (bvalid, bpoint, bweight, bcolor, bdest,
            (sp_ray, sp_lab, sp_valid, pcounts), bin_drop + pair_drop)


def _band(origin, bvalid, bpoint, bweight, bcolor, cfg: FusionConfig):
    """The bundles' truncation-band jobs (labels ride the votes)."""
    R = cfg.pipeline.max_rays
    dev = bpoint.device
    return carve_ops.band_jobs(
        origin[None, :], bpoint, bweight,
        torch.zeros((R,), dtype=torch.int32, device=dev), bcolor,
        torch.zeros((R,), dtype=torch.bool, device=dev), bvalid, cfg)


def _bundle_prepare(frame, cfg: FusionConfig, intr: PinholeIntrinsics):
    """The bundled prepare of one frame in carve_mode "projective": the
    bundling, its votes and the band jobs, reading nothing of the grid.
    Returns (band_jobs, sem_pts, n_dropped, origin)."""
    (_, pts_G, origin, colors, labels, weights, valid,
     is_clearing) = common.prepare_points(frame, intr, cfg)
    bvalid, bpoint, bweight, bcolor, _, sem_pts, drop = _bundle_votes(
        (pts_G, colors, labels, weights, valid, is_clearing), cfg)
    return (_band(origin, bvalid, bpoint, bweight, bcolor, cfg), sem_pts,
            drop, origin)


def _frame_parts(grid, frame, cfg: FusionConfig, intr: PinholeIntrinsics,
                 apply_proj_carve: bool = True):
    """Pass-1 bundling, sparse semantic votes and free-space batches for one
    frame. Returns (grid, batches, sem_pts, origin, bdest, full_state):
    `batches` is the integrate_jobs list (band [, carve jobs]), or None in
    carve_mode "full", whose two passes need full_state. Under carve_mode
    "projective" the dense free-space carve is applied to `grid` here,
    unless `apply_proj_carve` is False (integrate_frame carves first under
    its own profiler range; sharded callers run their ownership-filtered
    carve themselves, parallel/sharding.py)."""
    (_, pts_G, origin, colors, labels, weights, valid,
     is_clearing) = common.prepare_points(frame, intr, cfg)
    R = cfg.pipeline.max_rays
    bvalid, bpoint, bweight, bcolor, bdest, sem_pts, drop = _bundle_votes(
        (pts_G, colors, labels, weights, valid, is_clearing), cfg)
    grid.dropped_rays = grid.dropped_rays + drop
    zlab = torch.zeros((R,), dtype=torch.int32, device=pts_G.device)
    full_state = (pts_G, origin, colors, labels, weights, valid, is_clearing,
                  bvalid, bpoint, bweight, bcolor, zlab)

    decimate = (cfg.tsdf.carve_mode in ("decimated", "projective")
                and cfg.tsdf.voxel_carving_enabled)
    if not decimate:
        return grid, None, sem_pts, origin, bdest, full_state

    band = _band(origin, bvalid, bpoint, bweight, bcolor, cfg)
    s_band = cfg.pipeline.resolved_band_steps(cfg.grid, cfg.tsdf)
    if _projective_carve(cfg):
        if apply_proj_carve:
            grid = _maybe_projective_carve(grid, frame, cfg, intr)
        return grid, [(band, s_band)], sem_pts, origin, bdest, full_state
    cjobs, dropped = carve_ops.decimated_jobs(frame.depth, frame.labels,
                                              frame.T_G_C, intr, cfg)
    grid.dropped_rays = grid.dropped_rays + dropped
    return (grid, [(band, s_band), (cjobs, cfg.pipeline.carve_steps)],
            sem_pts, origin, bdest, full_state)


def integrate_frame(grid: VoxelGrid, frame: common.Frame, cfg: FusionConfig,
                    intr: PinholeIntrinsics, device="cuda") -> VoxelGrid:
    """One full frame update, in place. `device` defaults to the card and
    must be where the grid and frame lie; it raises when it names CUDA and
    no card is present."""
    dev = resolve(device)
    check_on(dev, grid=grid.wsum, depth=frame.depth, T_G_C=frame.T_G_C)
    ag = cfg.tsdf.enable_anti_grazing
    with common.stage("carve"):
        if _projective_carve(cfg):
            grid = _maybe_projective_carve(grid, frame, cfg, intr)
    with common.stage("band"):
        grid, batches, sem_pts, origin, bdest, full_state = _frame_parts(
            grid, frame, cfg, intr, apply_proj_carve=False)
    (pts_G, origin, colors, labels, weights, valid, is_clearing,
     bvalid, bpoint, bweight, bcolor, zlab) = full_state
    R = cfg.pipeline.max_rays
    dest = bdest if ag else None
    if batches is not None:
        return integrate_jobs(grid, cfg, batches, sem_points=sem_pts,
                              cube_origin=origin, ag_dest_voxels=dest,
                              ag_own_bundle=True)

    zeros = torch.zeros((R,), dtype=torch.bool, device=dev)
    grid = integrate_ray_batch(grid, cfg, origin, bpoint, bweight, bcolor,
                               zlab, zeros, bvalid, sem_points=sem_pts,
                               ag_dest_voxels=dest, ag_own_bundle=True)
    # Pass 2: clearing bundles, the first point of each bin only.
    (cvalid, _, _, _, _, cfirst, _, _, cbin_drop) = _bundle(
        pts_G, weights, colors, labels, valid & is_clearing,
        voxel_size_inv=1.0 / cfg.grid.voxel_size,
        num_labels=cfg.grid.num_labels, max_bundles=R)
    grid.dropped_rays = grid.dropped_rays + cbin_drop
    n = pts_G.shape[0]
    first = torch.clamp(cfirst, max=n - 1).long()
    cpts, cweights, ccolors, clabels = common.gather_packed(
        first, pts_G, weights, colors, labels)
    cvalid = cvalid & (cfirst < n) & (cweights > _EPS_WEIGHT)
    return integrate_ray_batch(grid, cfg, origin, cpts, cweights, ccolors,
                               clabels, ~zeros, cvalid, ag_dest_voxels=dest,
                               ag_own_bundle=False)


def batchable(cfg: FusionConfig) -> bool:
    """Whether integrate_frames takes this configuration in one stream."""
    return (not cfg.tsdf.enable_anti_grazing
            and cfg.tsdf.carve_mode in ("decimated", "projective")
            and cfg.tsdf.voxel_carving_enabled)


def integrate_frames(grid: VoxelGrid, frames: common.Frame,
                     cfg: FusionConfig, intr: PinholeIntrinsics,
                     device="cuda") -> VoxelGrid:
    """Batched update, in place: B frames' band (+ carve) batches
    concatenated per kind and integrated in one integrate_jobs call. Each
    frame's (bundle, label) votes ride batch 0 with their ray indices
    offset by b * max_rays, the frame's place in the concatenation, so the
    per-frame histogram semantics hold; bundling stays per frame.

    Needs a banded carve mode and no anti-grazing (whose dest sets are per
    frame): callers integrate frame by frame otherwise (batchable)."""
    if not batchable(cfg):
        raise ValueError("batched merged integration needs a banded carve "
                         "mode and no anti-grazing")
    dev = resolve(device)
    check_on(dev, grid=grid.wsum, depth=frames.depth, T_G_C=frames.T_G_C)
    B = frames.depth.shape[0]
    R = cfg.pipeline.max_rays
    parts = []     # per frame: (its [(jobs, step budget), ...], votes, origin)
    if _projective_carve(cfg):
        with common.stage("carve"):
            grid = _projective_carve_batched(grid, frames, cfg, intr)
        s_band = cfg.pipeline.resolved_band_steps(cfg.grid, cfg.tsdf)
        with common.stage("band"):
            for b in range(B):
                band, sem, drop, origin = _bundle_prepare(frames.at(b), cfg,
                                                          intr)
                grid.dropped_rays = grid.dropped_rays + drop
                parts.append(([(band, s_band)], sem, origin))
    else:
        with common.stage("band"):
            for b in range(B):
                grid, batches, sem, origin, _, _ = _frame_parts(
                    grid, frames.at(b), cfg, intr)
                parts.append((batches, sem, origin))
    batches = [_cat_jobs([p[0][k] for p in parts])
               for k in range(len(parts[0][0]))]
    sem_cat = tuple(torch.cat([
        p[1][i] + b * R if i == 0 else p[1][i] for b, p in enumerate(parts)])
        for i in range(4))
    return integrate_jobs(grid, cfg, batches, sem_points=sem_cat,
                          cube_origin=torch.stack([p[2] for p in parts]))


class MergedSemanticTsdfIntegrator:
    """Object-style API mirroring the reference class."""

    def __init__(self, cfg: FusionConfig, intr: PinholeIntrinsics,
                 device="cuda"):
        self.cfg = cfg
        self.intr = intr
        self.device = resolve(device)

    def integrate(self, grid: VoxelGrid, frame: common.Frame) -> VoxelGrid:
        return integrate_frame(grid, frame, self.cfg, self.intr,
                               device=self.device)
