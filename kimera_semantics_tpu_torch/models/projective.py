"""Projective semantic TSDF integrator, the main path.

Counterpart: kimera_semantics_tpu/models/projective.py (integrate_frame,
integrate_frames, candidates_from_atlas, allocate_from_depth,
_allocate_rays, allocate_from_atlas, insert_candidates, apply_frame,
apply_rows_multi, ProjectiveSemanticTsdfIntegrator). Per frame:

  1. mip atlas of the depth/label/color images      (ops/mip.py)
  2. allocation: a block-granularity DDA over the atlas level
     log2(alloc_stride) finds every block a ray corridor crosses
     (K1, ops/kernels.py dda_job_stream), and a batch hash insert yields the
     frame's group-aligned touched-block list (grid/hash.py)
  3. per-block mip level and patch origin            (K2, block_meta)
  4. per-voxel sample + update, added in place: K3 (projective_apply_fused)
     when `fused_apply` is set and vps^3 <= 8192, else K4
     (projective_sample_update) writes delta planes that K5 (block_rmw_add,
     onehot votes) adds, as the JAX package routes it

On CUDA tensors K1-K5 are the hand-written kernels; on CPU tensors their
plain versions. The JAX integrator takes the grid as a donated buffer and
returns a new one; this one updates the grid's channel tensors IN PLACE and
returns the same VoxelGrid object with its hash-table fields replaced.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..config import ColorMode, FusionConfig
from ..core import camera as cam
from ..core import transforms
from ..core.camera import PinholeIntrinsics
from ..device import check_on, resolve
from ..grid import hash as bhash
from ..grid.blocks import VoxelGrid
from ..ops import kernels
from ..ops import mip as mip_ops
from ..ops import projective as proj_ops
from ..ops import raycast
from ..ops import semantic as sem_ops
from ..ops import tsdf as tsdf_ops
from ..ops.integrate import owned
from . import common

# Largest vps^3 the fused apply takes, as in the JAX package; larger blocks
# (vps = 32 literal storage) and fused_apply=False take the unfused
# sample (K4) + block-add (K5) kernels.
FUSED_MAX_V3 = 8192

# Profiler ranges around the stages of integrate_frame, named
# "integrate_frame/<stage>"; a torch.profiler trace of the frame loop reads
# each stage's time from them (chip_smoke.py).
STAGES = ("atlas", "candidates", "insert", "meta", "apply")


def make_plan(cfg: FusionConfig, intr: PinholeIntrinsics) -> mip_ops.MipPlan:
    return mip_ops.make_plan(intr.height, intr.width,
                             cfg.pipeline.patch_rows, cfg.pipeline.patch_cols)


def alloc_steps(cfg: FusionConfig) -> int:
    """Static step budget of the block-granularity DDA."""
    g, t = cfg.grid, cfg.tsdf
    return int(math.ceil(1.7321 * (t.max_ray_length_m + t.truncation_distance)
                         / g.block_size)) + 3


def candidates_from_atlas(atlas: torch.Tensor, T_G_C: torch.Tensor,
                          cfg: FusionConfig, intr: PinholeIntrinsics, plan):
    """Candidate block keys for one frame from its mip atlas: (keys (S, R)
    int32, -1 where invalid; valid (S, R) bool). Runs K1 at block
    granularity, keys only."""
    keys, _, _, _, _, valid, _, _ = kernels.dda_job_stream(
        *candidate_jobs(atlas, T_G_C, cfg, intr, plan), keys_only=True)
    return keys, valid


def candidate_jobs(atlas: torch.Tensor, T_G_C: torch.Tensor,
                   cfg: FusionConfig, intr: PinholeIntrinsics, plan):
    """The arguments of K1 (ops/kernels.py dda_job_stream) for the frame's
    block-granularity allocation walk: one ray per pixel of the atlas level
    log2(alloc_stride), over world-unit extents, with a config view of
    voxel_size = block_size and vps = 1."""
    stride = cfg.pipeline.alloc_stride
    lvl = int(math.log2(stride)) if stride > 1 else 0
    if (1 << lvl) != stride:
        raise ValueError("alloc_stride must be a power of two")
    lvl = min(lvl, plan.num_levels - 1)
    H, W, off = plan.heights[lvl], plan.widths[lvl], plan.offsets[lvl]
    depth = atlas[0, :H, off:off + W]
    labels = torch.round(atlas[1, :H, off:off + W]).to(torch.int32).reshape(-1)
    px_ok = depth < mip_ops.DEPTH_SENTINEL * 0.5
    depth = torch.where(px_ok, depth, 0.0)
    pts_C, px_valid = cam.backproject(depth, intr.scaled(W, H))
    return ray_jobs(pts_C, labels, px_valid, T_G_C, cfg)


def ray_jobs(pts_C: torch.Tensor, labels: torch.Tensor,
             px_valid: torch.Tensor, T_G_C: torch.Tensor,
             cfg: FusionConfig):
    """The arguments of K1 for a frame's subsampled camera-frame points
    pts_C (R, 3) with their labels and pixel validity (R,): the rays'
    world-unit extents and validity (the reference's _candidate_keys
    before its walk)."""
    g, t = cfg.grid, cfg.tsdf
    valid, is_clearing = tsdf_ops.point_validity(pts_C, t)
    valid = valid & px_valid & sem_ops.dynamic_label_mask(labels, cfg.semantic)
    pts_G = transforms.apply(T_G_C, pts_C)
    origin = transforms.translation(T_G_C)
    start_w, end_w = raycast.setup_rays(
        origin[None, :], pts_G, is_clearing, voxel_size=1.0,
        truncation_distance=t.truncation_distance,
        max_ray_length_m=t.max_ray_length_m,
        voxel_carving_enabled=t.voxel_carving_enabled)
    cfg_b = dataclasses.replace(cfg, grid=dataclasses.replace(
        g, voxel_size=g.block_size, voxels_per_side=1))
    R = pts_G.shape[0]
    soa = lambda a: a.T.contiguous()  # noqa: E731
    return (cfg_b, alloc_steps(cfg), soa(origin.expand(R, 3)), soa(pts_G),
            soa(start_w), soa(end_w),
            torch.ones((R,), dtype=torch.float32, device=pts_G.device), valid)


def insert_candidates(grid: VoxelGrid, keys, active, cfg: FusionConfig,
                      shard=None):
    """Frame-list insert of candidate keys; replaces the grid's hash-table
    fields. `keys`/`active` may be the raw (S, R) DDA planes or a compact
    list (bhash.unique_keys). With `shard` = (my, num) only the keys that
    shard `my` of `num` owns are inserted (the ownership rule of
    ops/integrate.py, so the sharded ray and projective paths agree on
    owners). Returns (grid, fcoords, fslots, freal)."""
    g = cfg.grid
    if shard is not None:
        my, num = shard
        active = active & owned(keys, my, num)
    tk, ts, bc, nb, ov, fcoords, fslots, freal = bhash.insert_frame_list(
        grid.table_keys, grid.table_slots, grid.block_coords, grid.n_blocks,
        keys.reshape(-1), active.reshape(-1), g.table_size, g.block_capacity,
        g.world_extent_blocks, cfg.pipeline.block_budget)
    grid.table_keys, grid.table_slots, grid.block_coords = tk, ts, bc
    grid.n_blocks = nb
    grid.overflow = grid.overflow + ov
    return grid, fcoords, fslots, freal


def allocate_from_depth(grid: VoxelGrid, depth, labels, T_G_C,
                        cfg: FusionConfig, intr: PinholeIntrinsics,
                        shard=None):
    """Allocation from the raw images: every alloc_stride-th pixel's ray,
    with exact 1/stride intrinsics sized to the strided image (the
    reference's raw-image entry; integrate_frame reads the atlas instead,
    allocate_from_atlas). Returns (grid, fcoords, fslots, freal)."""
    stride = cfg.pipeline.alloc_stride
    depth = depth[::stride, ::stride]
    labels = labels[::stride, ::stride].reshape(-1)
    sub = PinholeIntrinsics(
        fx=intr.fx / stride, fy=intr.fy / stride, cx=intr.cx / stride,
        cy=intr.cy / stride, width=int(math.ceil(intr.width / stride)),
        height=int(math.ceil(intr.height / stride)))
    pts_C, px_valid = cam.backproject(depth, sub)
    return _allocate_rays(grid, pts_C, labels, px_valid, T_G_C, cfg, shard)


def _allocate_rays(grid: VoxelGrid, pts_C, labels, px_valid, T_G_C,
                   cfg: FusionConfig, shard=None):
    keys, _, _, _, _, valid, _, _ = kernels.dda_job_stream(
        *ray_jobs(pts_C, labels, px_valid, T_G_C, cfg), keys_only=True)
    return insert_candidates(grid, keys, valid, cfg, shard=shard)


def allocate_from_atlas(grid: VoxelGrid, atlas, T_G_C, cfg: FusionConfig,
                        intr: PinholeIntrinsics, plan, shard=None):
    with common.stage("candidates"):
        keys, valid = candidates_from_atlas(atlas, T_G_C, cfg, intr, plan)
    with common.stage("insert"):
        return insert_candidates(grid, keys, valid, cfg, shard=shard)


def apply_frame(grid: VoxelGrid, atlas, T_G_C, fcoords, fslots, freal,
                cfg: FusionConfig, intr: PinholeIntrinsics, plan,
                region: str = "all") -> VoxelGrid:
    """Sample + update the listed blocks from one frame's atlas, in place:
    K2 (block_meta), then K3 (projective_apply_fused) on the fused route,
    or K4 (projective_sample_update) and K5 (block_rmw_add) otherwise."""
    g = cfg.grid
    with common.stage("meta"):
        T_C_G = transforms.inverse(T_G_C)
        meta = kernels.block_meta(fcoords, freal, T_C_G, intr, plan,
                                  g.block_size)
    lk = sem_ops.make_likelihood_cached(cfg).delta
    with_color = cfg.semantic.color_mode == ColorMode.COLOR
    channels = (grid.wsum, grid.wsdf, grid.sem_count, grid.sem_delta,
                grid.wcolor)
    with common.stage("apply"):
        if cfg.pipeline.fused_apply and g.vps3 <= FUSED_MAX_V3:
            kernels.projective_apply_fused(
                *channels, fslots, meta, T_C_G, atlas, cfg, intr, plan,
                lk_delta=lk, with_color=with_color, region=region)
        else:
            d_w, d_wsdf, d_cnt, d_lab, d_wc = kernels.projective_sample_update(
                meta, fslots, T_C_G, atlas, cfg, intr, plan,
                with_color=with_color, region=region)
            kernels.block_rmw_add(*channels, fslots, d_w, d_wsdf, d_cnt,
                                  d_lab, d_wc, lk_delta=lk)
        # OR the frame's real rows into the flags: padding rows and trash
        # tiles OR in False, so no flag set by an earlier frame is cleared
        # and no boolean-mask index waits on the host.
        rows = fslots.long()
        grid.updated[rows] = grid.updated[rows] | freal
    return grid


def apply_rows_multi(grid: VoxelGrid, atlases, T_G_C_all, frame_idx,
                     fcoords, fslots, freal, cfg: FusionConfig,
                     intr: PinholeIntrinsics, plan,
                     region: str = "all") -> VoxelGrid:
    """Sample + update a mixed-frame row list, in place: row j samples
    frame frame_idx[j]'s atlas and pose (ops/projective.py
    voxel_deltas_multi) and its deltas are added by indexed adds. The
    counterpart of the reference's plain branch of the sharded dense
    apply, which packs the owned rows of all frames into one row budget;
    the port's sharded step takes the reference's kernel branch instead
    (apply_frame once per frame)."""
    g = cfg.grid
    d = proj_ops.voxel_deltas_multi(frame_idx, fcoords, freal, atlases,
                                    T_G_C_all, intr, plan, cfg,
                                    region=region)
    rows = fslots[freal].long()
    for name, key in (("wsum", "w"), ("wsdf", "wsdf"),
                      ("sem_count", "cnt")):
        getattr(grid, name).index_add_(0, rows, d[key][freal])
    grid.sem_delta.index_add_(1, rows, d["sem"][freal].permute(1, 0, 2))
    grid.wcolor.index_add_(1, rows, d["wcolor"][freal].permute(1, 0, 2))
    grid.updated[rows] = True
    return grid


def integrate_frame(grid: VoxelGrid, frame: common.Frame, cfg: FusionConfig,
                    intr: PinholeIntrinsics, device="cuda",
                    wire_sim: bool = False) -> VoxelGrid:
    """One full projective frame update. The grid is updated IN PLACE (the
    JAX counterpart donates it) and returned.

    `device` defaults to the card and must be where the grid and frame
    lie; it raises when it names CUDA and no card is present. `wire_sim`
    passes the atlas through the u16 wire codec (ops/mip.py
    wire_roundtrip_atlas) first: on one device, what every shard sees
    under the wire protocol."""
    dev = resolve(device)
    check_on(dev, grid=grid.wsum, depth=frame.depth, T_G_C=frame.T_G_C)
    plan = make_plan(cfg, intr)
    with common.stage("atlas"):
        atlas = mip_ops.build_atlas(frame.depth, frame.labels, frame.colors,
                                    plan)
        if wire_sim:
            atlas = mip_ops.wire_roundtrip_atlas(atlas, cfg)
    grid, fcoords, fslots, freal = allocate_from_atlas(
        grid, atlas, frame.T_G_C, cfg, intr, plan)
    return apply_frame(grid, atlas, frame.T_G_C, fcoords, fslots, freal, cfg,
                       intr, plan)


def integrate_frames(grid: VoxelGrid, frames: common.Frame,
                     cfg: FusionConfig, intr: PinholeIntrinsics,
                     device="cuda") -> VoxelGrid:
    """Integrate B frames in order, in place. `frames` is a Frame whose
    tensors carry a leading batch axis (B, ...), as in the JAX package;
    here the frames run one after another in a Python loop."""
    for b in range(frames.depth.shape[0]):
        grid = integrate_frame(
            grid, common.Frame(frames.depth[b], frames.labels[b],
                               frames.colors[b], frames.T_G_C[b]),
            cfg, intr, device=device)
    return grid


class ProjectiveSemanticTsdfIntegrator:
    """Object-style API."""

    def __init__(self, cfg: FusionConfig, intr: PinholeIntrinsics,
                 device="cuda"):
        self.cfg = cfg
        self.intr = intr
        self.device = resolve(device)

    def integrate(self, grid: VoxelGrid, frame: common.Frame) -> VoxelGrid:
        return integrate_frame(grid, frame, self.cfg, self.intr,
                               device=self.device)
