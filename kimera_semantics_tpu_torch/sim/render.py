"""Synthetic camera rendering from the analytic world via sphere tracing.

Counterpart: kimera_semantics_tpu/sim/render.py (render_depth_labels,
orbit_pose). Renders (depth, label) images with a pinhole model: +z
forward, x right, y down.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import PinholeIntrinsics
from . import world as sim_world

MAX_MARCH_STEPS = 96
HIT_EPS = 1e-3
# Steps between checks of the early exit (one host sync each). Steps past
# the reference's exit change only rays already beyond max_depth, which
# render as no-hit either way.
_EXIT_CHECK_EVERY = 8


def render_depth_labels(world: sim_world.World, T_G_C: torch.Tensor,
                        intr: PinholeIntrinsics, max_depth: float = 20.0):
    """Sphere-trace a (H, W) depth image + label image from pose T_G_C, on
    T_G_C's device. Returns (depth (H, W) float32, 0 where no hit;
    labels (H, W) int32)."""
    dev = T_G_C.device
    h, w = intr.height, intr.width
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    dc = [((u - intr.cx) / intr.fx).expand(h, w),
          ((v - intr.cy) / intr.fy).expand(h, w),
          torch.ones((h, w), dtype=torch.float32, device=dev)]
    R = T_G_C[:3, :3]
    dirs_g = torch.stack([dc[0] * R[i, 0] + dc[1] * R[i, 1] + dc[2] * R[i, 2]
                          for i in range(3)], dim=-1)
    origin = T_G_C[:3, 3]
    norm = torch.linalg.vector_norm(dirs_g, dim=-1)

    t = torch.full((h, w), 1e-3, dtype=torch.float32, device=dev)
    hit = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for it in range(MAX_MARCH_STEPS):
        if it % _EXIT_CHECK_EVERY == 0 and not bool((~hit & (t < max_depth))
                                                    .any()):
            break
        sdf, _ = sim_world.world_sdf(world, origin + dirs_g * t[..., None])
        hit = hit | (sdf < HIT_EPS)
        t = torch.where(hit, t, t + sdf / norm)

    _, labels = sim_world.world_sdf(world, origin + dirs_g * t[..., None])
    ok = hit & (t < max_depth)
    return torch.where(ok, t, 0.0), torch.where(ok, labels, 0)


def orbit_pose(angle: float, radius: float = 3.2, height: float = 2.2,
               target=(0.0, 0.0, 1.5)) -> np.ndarray:
    """Camera on a circle looking at `target`, as a (4, 4) float32 numpy
    array (the eval harness's viewpoint sweep)."""
    eye = np.array([radius * np.cos(angle), radius * np.sin(angle), height])
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, eye
    return T
