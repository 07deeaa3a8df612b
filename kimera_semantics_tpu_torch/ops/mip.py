"""Mip-pyramid image atlas for the projective integrator.

Counterpart: kimera_semantics_tpu/ops/mip.py (MipPlan, make_plan,
level_tables, build_atlas, unpack_color, and the u16 wire codec
wire_depth_max, wire_encode, atlas_from_wire, wire_roundtrip_atlas).
Depth is MIN-pooled (the nearest surface wins); label and color follow
the winning pixel, and a tie keeps the even pixel. All levels sit side by
side at 128-aligned column offsets of one (4, atlas_height, atlas_width)
float32 atlas, channels [depth, label, rg = r*256+g, b]; invalid depth is
DEPTH_SENTINEL.

The JAX package selects even and odd pixels with one-hot matmuls because
strided slices are slow on a TPU; here they are strided slices, which are
exact and keep every value out of any matmul.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core import fp

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


# ---------------------------------------------------------------------------
# The u16 wire codec of the sharded atlas exchange
# ---------------------------------------------------------------------------

def wire_depth_max(cfg) -> float:
    """Bound of the fine depth range: max_ray + 2 x truncation. A depth at
    or past it gives sdf >= truncation for every voxel a frame may update;
    only the observation weight (1/depth^2) still depends on it, so the
    codec keeps a coarse far range instead of clipping."""
    return cfg.tsdf.max_ray_length_m + 2.0 * cfg.tsdf.truncation_distance


# Wire depth codes: [0, _WIRE_FINE_CODES) span [0, dmax] linearly (about
# 0.09 mm a step at 5.2 m); [_WIRE_FINE_CODES, 65534] span (dmax,
# max(_WIRE_FAR_MAX, 2 dmax)] linearly (about 17 mm, read only by the
# 1/depth^2 carve weight); 65535 marks an invalid depth. Farther depths
# take the last code.
_WIRE_FINE_CODES = 60000.0
_WIRE_FAR_MAX = 100.0


def _wire_far_lo(cfg) -> float:
    return wire_depth_max(cfg)


def wire_encode(atlas: torch.Tensor, cfg) -> Tuple[torch.Tensor, ...]:
    """The built (4, AH, AW) float32 atlas as compact wire planes: (d16,
    lab) and, in ColorMode.COLOR only, (rg16, b8). d16 is uint16; lab is
    uint8, or uint16 where num_labels > 256; the semantic modes never read
    the measured colours, so they ship none. Labels and colours encode
    losslessly inside their type's range; depth quantizes as the codes
    above say, the invalid sentinel kept.

    Each value is clamped to its type's range before the cast: the JAX
    package's cast saturates there (a label of 300 becomes 255 in uint8),
    where torch's float-to-integer cast would wrap."""
    from ..config import ColorMode
    dmax = wire_depth_max(cfg)
    d = atlas[0]
    valid = d < DEPTH_SENTINEL
    far_hi = max(_WIRE_FAR_MAX, dmax * 2.0)
    q_fine = torch.round(torch.clamp(d, 0.0, dmax)
                         * ((_WIRE_FINE_CODES - 1.0) / dmax))
    q_far = torch.round((torch.clamp(d, dmax, far_hi) - dmax)
                        * ((65534.0 - _WIRE_FINE_CODES) / (far_hi - dmax))
                        ) + _WIRE_FINE_CODES
    q = torch.where(d <= dmax, q_fine, q_far)
    d16 = torch.where(valid, q, 65535.0).to(torch.uint16)

    def cast(x, dtype, top):
        return torch.clamp(torch.round(x), 0, top).to(dtype)
    wide = cfg.grid.num_labels > 256
    planes = [d16, cast(atlas[1], torch.uint16 if wide else torch.uint8,
                        65535 if wide else 255)]
    if cfg.semantic.color_mode == ColorMode.COLOR:
        planes.append(cast(atlas[2], torch.uint16, 65535))
        planes.append(cast(atlas[3], torch.uint8, 255))
    return tuple(planes)


def atlas_from_wire(planes, cfg) -> torch.Tensor:
    """The wire planes decoded to the (4, AH, AW) float32 atlas, element
    by element (no pyramid rebuilt): every shard that decodes one encoded
    atlas gets the same atlas. The planes widen to float32 first (torch's
    uint16 has casts but no comparisons)."""
    dmax = wire_depth_max(cfg)
    far_hi = max(_WIRE_FAR_MAX, dmax * 2.0)
    d16 = planes[0].to(torch.float32)
    d_fine = d16 * (dmax / (_WIRE_FINE_CODES - 1.0))
    # dmax + (d16 - fine codes) * step, rounded once as XLA:CPU's fused
    # multiply-add rounds it inside the JAX package's jit (core/fp.py).
    d_far = fp.fma(d16 - _WIRE_FINE_CODES,
                   fp.f32((far_hi - dmax) / (65534.0 - _WIRE_FINE_CODES)),
                   fp.f32(dmax))
    d = torch.where(d16 >= 65535.0, DEPTH_SENTINEL,
                    torch.where(d16 < _WIRE_FINE_CODES, d_fine, d_far))
    lab = planes[1].to(torch.float32)
    if len(planes) > 2:
        rg, b = planes[2].to(torch.float32), planes[3].to(torch.float32)
    else:
        rg, b = torch.zeros_like(d), torch.zeros_like(d)
    return torch.stack([d, lab, rg, b])


def wire_roundtrip_atlas(atlas: torch.Tensor, cfg) -> torch.Tensor:
    """decode(encode(atlas)): the atlas every shard sees under the u16
    wire."""
    return atlas_from_wire(wire_encode(atlas, cfg), cfg)


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
