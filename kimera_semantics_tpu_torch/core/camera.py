"""Pinhole camera back-projection: depth images -> camera-frame points.

Counterpart: kimera_semantics_tpu/core/camera.py (the reference's
`PointCloudFromDepth::convert`, depth_map_to_pointcloud.h:213-275):
x = (u - cx) * z / fx, y = (v - cy) * z / fy; invalid depth is masked.
"""

from __future__ import annotations

import dataclasses

import torch

from .fp import recip


@dataclasses.dataclass(frozen=True)
class PinholeIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def scaled(self, width: int, height: int) -> "PinholeIntrinsics":
        """Rescale intrinsics when image resolution differs from calibration
        (reference rescales rgb + intrinsics, depth_map_to_pointcloud.h:91-137)."""
        sx = width / self.width
        sy = height / self.height
        return PinholeIntrinsics(
            fx=self.fx * sx, fy=self.fy * sy, cx=self.cx * sx, cy=self.cy * sy,
            width=width, height=height,
        )


def backproject(depth_m: torch.Tensor, intr: PinholeIntrinsics):
    """Back-project a (H, W) metric depth image into camera-frame points.

    Returns (points_C (H*W, 3) float32, valid (H*W,) bool). Invalid =
    nonpositive or non-finite depth."""
    h, w = depth_m.shape
    z = depth_m.float()
    dev = z.device
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    # `/ fx` is a multiply by float32(1/fx), as the reference compiles it.
    x = (u - intr.cx) * z * recip(intr.fx)
    y = (v - intr.cy) * z * recip(intr.fy)
    pts = torch.stack([x, y, z.expand(h, w)], dim=-1).reshape(-1, 3)
    valid = (torch.isfinite(z) & (z > 0.0)).reshape(-1)
    pts = torch.where(valid[:, None], pts, torch.zeros((), device=dev))
    return pts, valid
