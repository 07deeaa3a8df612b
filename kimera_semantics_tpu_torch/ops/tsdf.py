"""Projective TSDF update math.

Counterpart: kimera_semantics_tpu/ops/tsdf.py (point_validity,
voxel_weight, projective_sdf_soa, update_terms): voxblox isPointValid and updateTsdfVoxel's weight drop-off
and color gate, as batched tensor functions. Rounding follows the
reference's compiled form (core/fp.py): the norm is a fused-multiply-add
chain, and the drop-off division by a constant is a reciprocal multiply.
"""

from __future__ import annotations

import torch

from ..config import TsdfConfig
from ..core.fp import fma, recip


def norm3(x, y, z):
    """|(x, y, z)| as the reference's 3-term reduction computes it."""
    return torch.sqrt(fma(z, z, fma(y, y, x * x)))


def point_validity(points_C: torch.Tensor, cfg: TsdfConfig):
    """voxblox `isPointValid`: returns (valid, is_clearing).

    - |p| < min_ray_length  -> invalid
    - |p| > max_ray_length  -> clearing ray if allow_clear, else invalid
    - non-finite            -> invalid
    """
    norm = norm3(points_C[..., 0], points_C[..., 1], points_C[..., 2])
    finite = torch.isfinite(points_C).all(dim=-1)
    too_close = norm < cfg.min_ray_length_m
    beyond = norm > cfg.max_ray_length_m
    is_clearing = beyond & cfg.allow_clear
    valid = finite & ~too_close & (~beyond | cfg.allow_clear)
    return valid, is_clearing


def voxel_weight(points_C: torch.Tensor, cfg: TsdfConfig) -> torch.Tensor:
    """voxblox `getVoxelWeight`: 1 if const-weight else 1/z^2 (camera-frame
    z)."""
    if cfg.use_const_weight:
        return torch.ones(points_C.shape[:-1], dtype=torch.float32,
                          device=points_C.device)
    z = points_C[..., 2].abs()
    return torch.where(z > 1e-6, 1.0 / torch.clamp(z * z, min=1e-12), 0.0)


def projective_sdf_soa(origin: torch.Tensor, points_G: torch.Tensor, vx, vy,
                       vz, voxel_size: float) -> torch.Tensor:
    """voxblox `computeDistance` over (S, R) voxel-coordinate planes: the
    signed distance of each voxel centre to its ray's surface point along
    the ray, |p - o| - (c - o).(p - o) / |p - o|; origin (3,) or (R, 3),
    points_G (R, 3). Each product is fused into the add that follows, as
    in the reference's compiled form and the DDA kernel (K1's plain
    version computes its sdf here)."""
    origin = origin.expand(points_G.shape)
    vec = points_G - origin
    dist = norm3(vec[:, 0], vec[:, 1], vec[:, 2])
    A = [fma(c.float() + 0.5, voxel_size, -origin[None, :, a])
         for a, c in enumerate((vx, vy, vz))]
    num = fma(A[2], vec[None, :, 2], fma(A[0], vec[None, :, 0],
                                         A[1] * vec[None, :, 1]))
    return dist[None, :] - num / torch.clamp(dist, min=1e-12)[None, :]


def dropoff_scale(cfg: TsdfConfig, voxel_size: float) -> float:
    """float32 reciprocal of the drop-off span max(trunc - eps, 1e-12)."""
    return recip(max(cfg.truncation_distance - voxel_size, 1e-12))


def update_terms(sdf: torch.Tensor, weight: torch.Tensor, cfg: TsdfConfig,
                 voxel_size: float):
    """Per-measurement accumulator contributions (w, w * clamped sdf,
    color gate). Behind-surface measurements fade linearly to zero over
    [-voxel_size, -truncation]; the sdf is clamped to the truncation band
    before accumulation."""
    trunc = cfg.truncation_distance
    if cfg.use_weight_dropoff:
        scale = (trunc + sdf) * dropoff_scale(cfg, voxel_size)
        w = torch.where(sdf < -voxel_size,
                        torch.clamp(weight * scale, min=0.0), weight)
    else:
        w = weight
    clamped = torch.clamp(sdf, -trunc, trunc)
    color_gate = sdf.abs() < trunc
    return w, w * clamped, color_gate
