"""Simple semantic TSDF integrator: every valid point casts its own ray.

Counterpart: kimera_semantics_tpu/models/simple.py (integrate_frame,
SimpleSemanticTsdfIntegrator), voxblox's `SimpleTsdfIntegrator`: no
start-voxel subsampling, no bundling, no early termination; every valid
point walks origin -> point (+ truncation band) and updates every voxel it
crosses, with the same semantic fusion as the other integrators. The grid
is updated IN PLACE.
"""

from __future__ import annotations

from ..config import FusionConfig
from ..core.camera import PinholeIntrinsics
from ..device import check_on, resolve
from ..grid.blocks import VoxelGrid
from ..ops.integrate import integrate_ray_batch
from . import common


def integrate_frame(grid: VoxelGrid, frame: common.Frame, cfg: FusionConfig,
                    intr: PinholeIntrinsics, device="cuda") -> VoxelGrid:
    """One full frame update, in place. `device` defaults to the card and
    must be where the grid and frame lie; it raises when it names CUDA and
    no card is present."""
    dev = resolve(device)
    check_on(dev, grid=grid.wsum, depth=frame.depth, T_G_C=frame.T_G_C)
    (_, pts_G, origin, colors, labels, weights, valid,
     is_clearing) = common.prepare_points(frame, intr, cfg)
    kept, pts_G, colors, labels, weights, is_clearing = common.compact(
        valid, cfg.pipeline.max_rays, pts_G, colors, labels, weights,
        is_clearing)
    return integrate_ray_batch(grid, cfg, origin, pts_G, weights, colors,
                               labels, is_clearing, kept)


class SimpleSemanticTsdfIntegrator:
    """Object-style API (factory-compatible, models/factory.py)."""

    def __init__(self, cfg: FusionConfig, intr: PinholeIntrinsics,
                 device="cuda"):
        self.cfg = cfg
        self.intr = intr
        self.device = resolve(device)

    def integrate(self, grid: VoxelGrid, frame: common.Frame) -> VoxelGrid:
        return integrate_frame(grid, frame, self.cfg, self.intr,
                               device=self.device)
