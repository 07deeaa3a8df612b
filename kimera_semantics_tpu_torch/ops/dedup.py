"""Approximate start-voxel dedup: the fast integrator's ray subsampler
(carve_mode "full").

Counterpart: kimera_semantics_tpu/ops/dedup.py (_mix3, start_voxel_dedup).
Rays whose start points fall into the same (subsampling_factor x finer)
voxel are integrated once (voxblox ApproxHashSet at
semantic_tsdf_integrator_fast.cpp:87-91); hash collisions may
over-suppress, as in the reference. Of the rays contending for one bucket in
a batch, the one with the highest index wins: the reference's scatter keeps
its last write on the CPU, and `scatter_reduce_(amax)` picks the same winner
on any device. The set lives in VoxelGrid.start_set across frames.
"""

from __future__ import annotations

import torch

from ..grid.hash import mix, mul_i32


def _mix3(coords: torch.Tensor, salt: int) -> torch.Tensor:
    x = mul_i32(coords[..., 0], 73856093)
    y = mul_i32(coords[..., 1], 19349669)
    z = mul_i32(coords[..., 2], 83492791)
    return mix(x ^ y ^ z ^ salt)


def start_voxel_dedup(start_set: torch.Tensor, points_G: torch.Tensor,
                      active: torch.Tensor, *, voxel_size_inv: float,
                      subsampling_factor: float):
    """Returns (keep (N,) bool, new start_set); start_set (D,) int32 tags is
    not modified."""
    d = start_set.shape[0]
    coords = torch.floor(
        points_G * (subsampling_factor * voxel_size_inv)).to(torch.int32)
    bucket = (_mix3(coords, 0x1E3779B9) & (d - 1)).long()
    tag = _mix3(coords, 0x5BD1E995)
    fresh = start_set[bucket] != tag
    n = points_G.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=points_G.device)
    contend = active & fresh
    winner = torch.full((d + 1,), -1, dtype=torch.int32,
                        device=points_G.device)
    winner.scatter_reduce_(0, torch.where(contend, bucket, d), idx,
                           reduce="amax")
    keep = contend & (winner[bucket] == idx)
    start_set = start_set.clone()
    start_set[bucket[keep]] = tag[keep]
    return keep, start_set
