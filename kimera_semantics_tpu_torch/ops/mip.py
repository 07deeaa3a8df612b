"""Mip-pyramid image atlas for the projective integrator.

Counterpart: kimera_semantics_tpu/ops/mip.py (MipPlan, make_plan,
level_tables, build_atlas, unpack_color). Depth is MIN-pooled (the nearest
surface wins); label and color follow the winning pixel, and a tie keeps
the even pixel. All levels sit side by side at 128-aligned column offsets
of one (4, atlas_height, atlas_width) float32 atlas, channels
[depth, label, rg = r*256+g, b]; invalid depth is DEPTH_SENTINEL.

The JAX package selects even and odd pixels with one-hot matmuls because
strided slices are slow on a TPU; here they are strided slices, which are
exact and keep every value out of any matmul.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

DEPTH_SENTINEL = 1.0e6


@dataclasses.dataclass(frozen=True)
class MipPlan:
    """Static geometry of the atlas."""

    height: int
    width: int
    row_window: int
    col_window: int
    num_levels: int
    widths: Tuple[int, ...]
    heights: Tuple[int, ...]
    offsets: Tuple[int, ...]
    atlas_width: int
    atlas_height: int
    full_level: int

    @property
    def row_threshold(self) -> int:
        return self.row_window - 9

    @property
    def col_threshold(self) -> int:
        return self.col_window - 130


def make_plan(height: int, width: int, row_window: int = 128,
              col_window: int = 256) -> MipPlan:
    """Choose the level count so the coarsest level's full image fits the
    window even after the origin-alignment slack."""
    full_level = 0
    while (width >> full_level) > col_window - 127 or \
            (height >> full_level) > row_window - 7:
        full_level += 1
    num_levels = full_level + 1
    if (width % (1 << full_level)) or (height % (1 << full_level)):
        raise ValueError(
            f"image {width}x{height} not divisible by 2^{full_level}; "
            "pad the input or choose different windows")
    widths = tuple(width >> l for l in range(num_levels))
    heights = tuple(height >> l for l in range(num_levels))
    offsets = []
    off = 0
    for l in range(num_levels):
        offsets.append(off)
        off += ((widths[l] + 127) // 128) * 128
    atlas_width = ((max(off, col_window) + 127) // 128) * 128
    atlas_height = ((max(height, row_window) + 7) // 8) * 8
    return MipPlan(height=height, width=width, row_window=row_window,
                   col_window=col_window, num_levels=num_levels,
                   widths=widths, heights=heights, offsets=tuple(offsets),
                   atlas_width=atlas_width, atlas_height=atlas_height,
                   full_level=full_level)


def _min_pool_with_payload(chans: torch.Tensor) -> torch.Tensor:
    """(C, h, w) -> (C, h/2, w/2): channel 0 (depth) min-pooled, the other
    channels follow the winning pixel; ties keep the even pixel."""
    a, b = chans[:, :, 0::2], chans[:, :, 1::2]
    x = torch.where((a[0] <= b[0])[None], a, b)
    a, b = x[:, 0::2], x[:, 1::2]
    return torch.where((a[0] <= b[0])[None], a, b)


def build_atlas(depth: torch.Tensor, labels: torch.Tensor,
                colors: torch.Tensor, plan: MipPlan) -> torch.Tensor:
    """(H, W) depth/labels + (H, W, 3) colors -> (4, AH, AW) float32."""
    d = torch.where(torch.isfinite(depth) & (depth > 0.0), depth.float(),
                    torch.full_like(depth, DEPTH_SENTINEL, dtype=torch.float32))
    c = torch.round(colors.float())
    rg = c[..., 0] * 256.0 + c[..., 1]
    level = torch.stack([d, labels.float(), rg, c[..., 2]])
    atlas = torch.zeros((4, plan.atlas_height, plan.atlas_width),
                        dtype=torch.float32, device=depth.device)
    atlas[0] = DEPTH_SENTINEL
    for l in range(plan.num_levels):
        if l > 0:
            level = _min_pool_with_payload(level)
        off = plan.offsets[l]
        atlas[:, :plan.heights[l], off:off + plan.widths[l]] = level
    return atlas


def level_tables(plan: MipPlan, device="cpu"):
    """Per-level (width, height, offset) as int32 tensors."""
    def t(v):
        return torch.tensor(v, dtype=torch.int32, device=device)
    return t(plan.widths), t(plan.heights), t(plan.offsets)


def unpack_color(rg: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inverse of the rg/b channel packing -> (..., 3) float32 in [0, 255]."""
    rg = torch.round(rg)
    r = torch.floor(rg / 256.0)
    g = rg - r * 256.0
    return torch.stack([r, g, torch.round(b)], dim=-1)
