"""Fast semantic TSDF integrator: the system's default integrator.

Counterpart: kimera_semantics_tpu/models/fast.py (_dedup_and_compact,
_band_prepare, _frame_batches, integrate_frame, _maybe_projective_carve,
_projective_carve_batched, FastSemanticTsdfIntegrator, integrate_frames),
the capability of
`kimera::FastSemanticTsdfIntegrator`
(kimera_semantics/src/semantic_tsdf_integrator_fast.cpp): speed first,
with start-voxel subsampling. Per frame, by TsdfConfig.carve_mode:

  "projective"  free space before the truncation band is carved by the
                dense projective kernels (K1 at block granularity, K2, K3
                with region "carve"); full-resolution rays chosen by
                band_octave_keep walk only their band (K1, K6, K5)
  "decimated"   the band jobs plus octave-decimated carve jobs
  "full"        start-voxel dedup (ops/dedup.py) and full-length rays

The grid is updated IN PLACE (the JAX counterpart donates it) and returned.
"""

from __future__ import annotations

import torch

from ..config import FusionConfig
from ..core.camera import PinholeIntrinsics
from ..device import check_on, resolve
from ..grid.blocks import VoxelGrid
from ..grid.hash import mul_i32, wrap_i32
from ..ops import carve as carve_ops
from ..ops import dedup as dedup_ops
from ..ops import mip as mip_ops
from ..ops import integrate
from ..ops.integrate import integrate_jobs
from . import common
from . import projective as proj_model

# Spans of integrate_frame in order: the dense carve (with the projective
# path's own spans nested in it), the band prepare (with its parts
# band/points, band/keep, band/jobs and band/carve_jobs nested in it),
# then the ray path's.
STAGES = ("carve", "band") + integrate.STAGES


def _dedup_and_compact(grid, cfg, pts_G, colors, labels, weights, valid,
                       is_clearing):
    """Periodic approx-set reset + start-voxel subsampling + ray compaction
    (reference _fast.cpp:87-91, 165-170). Returns (grid, kept, pts_G,
    colors, labels, weights, is_clearing)."""
    counter = grid.frame_counter + 1
    do_reset = counter >= cfg.tsdf.clear_checks_every_n_frames
    start_set = torch.where(do_reset, torch.full_like(grid.start_set, -1),
                            grid.start_set)
    counter = torch.where(do_reset, torch.zeros_like(counter), counter)
    keep, start_set = dedup_ops.start_voxel_dedup(
        start_set, pts_G, valid, voxel_size_inv=1.0 / cfg.grid.voxel_size,
        subsampling_factor=cfg.tsdf.start_voxel_subsampling_factor)
    n_dropped = torch.clamp(keep.sum(dtype=torch.int32)
                            - cfg.pipeline.max_rays, min=0)
    kept, pts_G, colors, labels, weights, is_clearing = common.compact(
        keep, cfg.pipeline.max_rays, pts_G, colors, labels, weights,
        is_clearing)
    grid.start_set = start_set
    grid.frame_counter = counter
    grid.dropped_rays = grid.dropped_rays + n_dropped
    return grid, kept, pts_G, colors, labels, weights, is_clearing


def _band_prepare(frame, cfg, intr, frame_idx=None):
    """Banded prepare for one frame: backproject, octave band keep,
    compact, band jobs. Returns (band_jobs, origin, n_dropped); keeps beyond
    the ray budget are counted, not silently lost."""
    with common.stage("band/points"):
        (pts_C, pts_G, origin, colors, labels, weights, valid,
         is_clearing) = common.prepare_points(frame, intr, cfg)
    with common.stage("band/keep"):
        # Thinning salt: the origin's float bits, and the frame counter so
        # a camera that does not move still dithers (models/fast.py
        # reference).
        ob = origin.contiguous().view(torch.int32).to(torch.int64)
        salt = wrap_i32(ob[0] ^ (ob[1] << 1) ^ (ob[2] << 2))
        if frame_idx is not None:
            salt = salt ^ mul_i32(torch.as_tensor(frame_idx), -1640531527)
        keep = carve_ops.band_octave_keep(pts_C, valid & ~is_clearing, cfg,
                                          intr, salt=salt)
        n_dropped = torch.clamp(keep.sum(dtype=torch.int32)
                                - cfg.pipeline.max_rays, min=0)
        kept, pts_G, colors, labels, weights, is_clearing = common.compact(
            keep, cfg.pipeline.max_rays, pts_G, colors, labels, weights,
            is_clearing)
    with common.stage("band/jobs"):
        band = carve_ops.band_jobs(origin[None, :], pts_G, weights, labels,
                                   colors, is_clearing, kept, cfg)
    return band, origin, n_dropped


def _frame_batches(grid, frame, cfg, intr):
    """This frame's job batches, with the dedup set state threaded through
    the grid. Returns (grid, [(jobs, step budget), ...], origin)."""
    banded = (cfg.tsdf.carve_mode in ("decimated", "projective")
              and cfg.tsdf.voxel_carving_enabled)
    if not banded:
        (pts_C, pts_G, origin, colors, labels, weights, valid,
         is_clearing) = common.prepare_points(frame, intr, cfg)
        (grid, kept, pts_G, colors, labels, weights,
         is_clearing) = _dedup_and_compact(grid, cfg, pts_G, colors, labels,
                                           weights, valid, is_clearing)
        jobs = carve_ops.full_jobs(origin[None, :], pts_G, weights, labels,
                                   colors, is_clearing, kept, cfg)
        return grid, [(jobs, cfg.resolved_max_steps())], origin

    band, origin, band_drop = _band_prepare(frame, cfg, intr,
                                            frame_idx=grid.frame_counter)
    grid.dropped_rays = grid.dropped_rays + band_drop
    grid.frame_counter = grid.frame_counter + 1
    s_band = cfg.pipeline.resolved_band_steps(cfg.grid, cfg.tsdf)
    if cfg.tsdf.carve_mode == "projective":
        return grid, [(band, s_band)], origin
    with common.stage("band/carve_jobs"):
        cjobs, dropped = carve_ops.decimated_jobs(
            frame.depth, frame.labels, frame.T_G_C, intr, cfg)
    grid.dropped_rays = grid.dropped_rays + dropped
    return grid, [(band, s_band), (cjobs, cfg.pipeline.carve_steps)], origin


def _maybe_projective_carve(grid: VoxelGrid, frame: common.Frame,
                            cfg: FusionConfig,
                            intr: PinholeIntrinsics) -> VoxelGrid:
    """carve_mode "projective": carve the free space strictly before the
    truncation band with the dense projective path (models/projective.py
    apply_frame, region "carve"), each frustum voxel once per frame; the
    band stays ray-exact (band jobs)."""
    if not (cfg.tsdf.carve_mode == "projective"
            and cfg.tsdf.voxel_carving_enabled):
        return grid
    plan = proj_model.make_plan(cfg, intr)
    atlas = mip_ops.build_atlas(frame.depth, frame.labels, frame.colors,
                                plan)
    grid, fc, fs, fr = proj_model.allocate_from_atlas(grid, atlas,
                                                      frame.T_G_C, cfg, intr,
                                                      plan)
    return proj_model.apply_frame(grid, atlas, frame.T_G_C, fc, fs, fr, cfg,
                                  intr, plan, region="carve")


def integrate_frame(grid: VoxelGrid, frame: common.Frame, cfg: FusionConfig,
                    intr: PinholeIntrinsics, device="cuda") -> VoxelGrid:
    """One full frame update, in place. `device` defaults to the card and
    must be where the grid and frame lie; it raises when it names CUDA and
    no card is present."""
    dev = resolve(device)
    check_on(dev, grid=grid.wsum, depth=frame.depth, T_G_C=frame.T_G_C)
    with common.stage("carve"):
        grid = _maybe_projective_carve(grid, frame, cfg, intr)
    with common.stage("band"):
        grid, batches, origin = _frame_batches(grid, frame, cfg, intr)
    return integrate_jobs(grid, cfg, batches, cube_origin=origin)


def _projective_carve_batched(grid: VoxelGrid, frames: common.Frame,
                              cfg: FusionConfig,
                              intr: PinholeIntrinsics) -> VoxelGrid:
    """B frames' dense free-space carves, one frame after another (the
    hash allocation chains through)."""
    for b in range(frames.depth.shape[0]):
        grid = _maybe_projective_carve(grid, frames.at(b), cfg, intr)
    return grid


def _cat_jobs(batches):
    """Per-frame (jobs, step budget) pairs of one kind -> one pair whose
    jobs concatenate the frames' along the job axis."""
    return carve_ops.JobBatch(*(
        torch.cat([getattr(j, f) for j, _ in batches])
        for f in carve_ops.JOB_FIELDS)), batches[0][1]


def integrate_frames(grid: VoxelGrid, frames: common.Frame,
                     cfg: FusionConfig, intr: PinholeIntrinsics,
                     device="cuda") -> VoxelGrid:
    """Batched update, in place: B frames in one update stream. `frames`
    is a Frame whose tensors carry a leading batch axis (B, ...).

    The B frames' job batches are concatenated per kind (band [, carve],
    or full) and integrated in one integrate_jobs call, each frame's chunk
    of the job axis resolving against its own camera cube. Under carve_mode
    "projective" the dense carves run frame by frame first, then the band
    prepare of each frame (salt index frame_counter + b). Start-voxel dedup
    (carve_mode "full") runs per frame in order, threading the approx set
    as B integrate_frame calls would."""
    dev = resolve(device)
    check_on(dev, grid=grid.wsum, depth=frames.depth, T_G_C=frames.T_G_C)
    B = frames.depth.shape[0]
    if (cfg.tsdf.carve_mode == "projective"
            and cfg.tsdf.voxel_carving_enabled):
        with common.stage("carve"):
            grid = _projective_carve_batched(grid, frames, cfg, intr)
        s_band = cfg.pipeline.resolved_band_steps(cfg.grid, cfg.tsdf)
        with common.stage("band"):
            bands, origins = [], []
            for b in range(B):
                band, origin, drop = _band_prepare(
                    frames.at(b), cfg, intr, frame_idx=grid.frame_counter + b)
                grid.dropped_rays = grid.dropped_rays + drop
                bands.append((band, s_band))
                origins.append(origin)
            grid.frame_counter = grid.frame_counter + B
        return integrate_jobs(grid, cfg, [_cat_jobs(bands)],
                              cube_origin=torch.stack(origins))

    per_kind, origins = None, []
    with common.stage("band"):
        for b in range(B):
            grid, batches, origin = _frame_batches(grid, frames.at(b), cfg,
                                                   intr)
            origins.append(origin)
            if per_kind is None:
                per_kind = [[] for _ in batches]
            for kind, bt in zip(per_kind, batches):
                kind.append(bt)
    return integrate_jobs(grid, cfg, [_cat_jobs(k) for k in per_kind],
                          cube_origin=torch.stack(origins))


class FastSemanticTsdfIntegrator:
    """Object-style API mirroring the reference class."""

    def __init__(self, cfg: FusionConfig, intr: PinholeIntrinsics,
                 device="cuda"):
        self.cfg = cfg
        self.intr = intr
        self.device = resolve(device)

    def integrate(self, grid: VoxelGrid, frame: common.Frame) -> VoxelGrid:
        return integrate_frame(grid, frame, self.cfg, self.intr,
                               device=self.device)
