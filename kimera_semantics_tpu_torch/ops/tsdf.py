"""Projective TSDF update math.

Counterpart: kimera_semantics_tpu/ops/tsdf.py (point_validity,
update_terms): voxblox isPointValid and updateTsdfVoxel's weight drop-off
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
