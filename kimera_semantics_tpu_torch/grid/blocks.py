"""VoxelGrid: the block-hashed TSDF + semantic voxel state.

Counterpart: kimera_semantics_tpu/grid/blocks.py (VoxelGrid, create,
voxel_to_block_local, point_to_voxel, voxel_center, lookup_slots,
allocate_blocks and the readouts). The channels keep the JAX package's layout
and its 8-row trash tile (`GridConfig.padded_rows` = capacity + 8 rows):

  wsum      (R, V3)     sum of measurement weights
  wsdf      (R, V3)     sum of weight * truncated sdf
  wcolor    (3, R, V3)  sum of weight * RGB
  sem_count (R, V3)     count of informative label measurements
  sem_delta (L, R, V3)  (log p - log(1-p)) * per-label counts

Where the JAX integrator takes the grid as a donated buffer and returns a
new one, the port's integrator updates these tensors IN PLACE (the hash
table fields are replaced by new tensors each frame).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import DEFAULT_UNIFORM_LOG_PRIOR, FusionConfig, GridConfig
from ..core.fp import fma
from ..device import resolve
from . import hash as bhash


@dataclasses.dataclass
class VoxelGrid:
    # Block hash table (grid/hash.py).
    table_keys: torch.Tensor    # (H,) int32
    table_slots: torch.Tensor   # (H,) int32
    block_coords: torch.Tensor  # (B, 3) int32
    n_blocks: torch.Tensor      # () int32
    overflow: torch.Tensor      # () int32 state-completeness violations
    dropped_rays: torch.Tensor  # () int32 policy-budget input truncation
    # Voxel channels, rows B..B+7 the trash tile.
    wsum: torch.Tensor
    wsdf: torch.Tensor
    wcolor: torch.Tensor
    sem_count: torch.Tensor
    sem_delta: torch.Tensor
    updated: torch.Tensor       # (R,) bool, blocks touched since last mesh
    # Approx-set state of the ray integrators (ops/dedup.py).
    start_set: torch.Tensor     # (D,) int32
    observed_set: torch.Tensor  # (D,) int32
    frame_counter: torch.Tensor  # () int32

    def channel_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.wsum, self.wsdf, self.wcolor, self.sem_count,
            self.sem_delta))


FIELDS = [f.name for f in dataclasses.fields(VoxelGrid)]


def create(cfg: FusionConfig, device="cuda") -> VoxelGrid:
    dev = resolve(device)
    g = cfg.grid
    B, V3, L, H, D = (g.block_capacity, g.vps3, g.num_labels, g.table_size,
                      cfg.pipeline.dedup_table_size)
    R = g.padded_rows
    i32, f32 = torch.int32, torch.float32

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(n, v):
        return torch.full((n,), v, dtype=i32, device=dev)

    return VoxelGrid(
        table_keys=full(H, bhash.EMPTY_KEY), table_slots=full(H, -1),
        block_coords=z(B, 3, dtype=i32), n_blocks=z(dtype=i32),
        overflow=z(dtype=i32), dropped_rays=z(dtype=i32),
        wsum=z(R, V3), wsdf=z(R, V3), wcolor=z(3, R, V3),
        sem_count=z(R, V3), sem_delta=z(L, R, V3),
        updated=z(R, dtype=torch.bool),
        start_set=full(D, -1), observed_set=full(D, -1),
        frame_counter=z(dtype=i32))


def voxel_to_block_local(voxel_coords: torch.Tensor, vps: int):
    """(..., 3) int32 global voxel coords -> (block (..., 3), local linear
    index (...,)), with floor division."""
    block = torch.div(voxel_coords, vps, rounding_mode="floor")
    local = voxel_coords - block * vps
    lin = (local[..., 0] * vps + local[..., 1]) * vps + local[..., 2]
    return block, lin


def point_to_voxel(points: torch.Tensor, voxel_size_inv: float):
    """World point -> global voxel coord, floor(p * voxel_size_inv + 1e-6)
    (voxblox getGridIndexFromPoint)."""
    return torch.floor(points * voxel_size_inv + 1e-6).to(torch.int32)


def voxel_center(voxel_coords: torch.Tensor, voxel_size: float):
    """Global voxel coord -> world-space voxel center (voxblox
    getCenterPointFromGridIndex)."""
    return (voxel_coords.to(torch.float32) + 0.5) * voxel_size


def lookup_slots(grid: VoxelGrid, block_coords: torch.Tensor,
                 cfg: GridConfig, rounds: int = 0):
    """Block coords (..., 3) -> slot ids; unknown/out-of-range -> capacity
    (trash). With `rounds` > 0 the probe takes exactly that many rounds and
    no host sync, and returns (slots, complete): `complete` a device bool
    that every probe ended."""
    ok = bhash.in_bounds(block_coords, cfg.world_extent_blocks)
    keys = bhash.pack_block_coords(block_coords, cfg.world_extent_blocks)
    args = (grid.table_keys, grid.table_slots, keys.reshape(-1),
            cfg.table_size)
    if rounds:
        slots, complete = bhash.lookup_bounded(*args, rounds)
    else:
        slots = bhash.lookup(*args)
    slots = slots.reshape(keys.shape)
    slots = torch.where(ok & (slots >= 0), slots,
                        torch.full_like(slots, cfg.block_capacity))
    return (slots, complete) if rounds else slots


def allocate_blocks(grid: VoxelGrid, block_coords: torch.Tensor,
                    active: torch.Tensor, cfg: GridConfig) -> VoxelGrid:
    """Allocate the active in-range blocks of `block_coords` (..., 3);
    replaces the grid's hash-table fields and adds to its overflow."""
    ok = bhash.in_bounds(block_coords, cfg.world_extent_blocks)
    keys = bhash.pack_block_coords(block_coords, cfg.world_extent_blocks)
    tk, ts, bc, nb, ov = bhash.insert(
        grid.table_keys, grid.table_slots, grid.block_coords, grid.n_blocks,
        keys.reshape(-1), (active & ok).reshape(-1), cfg.table_size,
        cfg.block_capacity, cfg.world_extent_blocks)
    grid.table_keys, grid.table_slots, grid.block_coords = tk, ts, bc
    grid.n_blocks = nb
    grid.overflow = grid.overflow + ov
    return grid


def tsdf_distance(grid: VoxelGrid, truncation: float) -> torch.Tensor:
    w = torch.clamp(grid.wsum, min=1e-12)
    return torch.clamp(grid.wsdf / w, -truncation, truncation)


def tsdf_weight(grid: VoxelGrid, max_weight: float) -> torch.Tensor:
    return torch.clamp(grid.wsum, max=max_weight)


def voxel_color(grid: VoxelGrid) -> torch.Tensor:
    """Blended measured color, (3, R, V3) uint8."""
    w = torch.clamp(grid.wsum, min=1e-12)[None]
    return torch.clamp(grid.wcolor / w, 0.0, 255.0).to(torch.uint8)


def mle_labels(grid: VoxelGrid) -> torch.Tensor:
    """Per-voxel MLE label (R, V3): argmax over the label axis, ties to the
    lowest index, so untouched voxels report label 0 (unknown)."""
    d = grid.sem_delta
    best = d[0].clone()
    lab = torch.zeros(best.shape, dtype=torch.int32, device=d.device)
    for l in range(1, d.shape[0]):
        better = d[l] > best
        best = torch.where(better, d[l], best)
        lab = torch.where(better, l, lab)
    return lab


def label_logodds(grid: VoxelGrid, log_match: float,
                  log_nonmatch: float) -> torch.Tensor:
    """Full unnormalized log-odds (L, R, V3)."""
    return (fma(grid.sem_count[None], log_nonmatch, DEFAULT_UNIFORM_LOG_PRIOR)
            + grid.sem_delta)
