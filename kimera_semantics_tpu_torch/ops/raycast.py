"""Batched Amanatides-Woo voxel traversal (DDA).

Counterpart: kimera_semantics_tpu/ops/raycast.py (setup_rays,
traverse_soa, traverse). Every ray is expanded into a fixed number of steps; steps
past the ray's end are masked. This is the plain version of the DDA kernel
(ops/kernels.py dda_job_stream), which shares `dda_init` and `dda_advance`
with it.
"""

from __future__ import annotations

import torch

from ..core.fp import fma
from .tsdf import norm3

GRID_EPS = 1e-6


def setup_rays(origin: torch.Tensor, points_G: torch.Tensor,
               is_clearing: torch.Tensor, *, voxel_size: float,
               truncation_distance: float, max_ray_length_m: float,
               voxel_carving_enabled: bool):
    """Scaled (voxel-unit) start/end points per ray, (R, 3) each.

      clearing ray:  end = o + u * clip(|p-o| - trunc, 0, max_ray)
      normal ray:    end = p + u * trunc
      start = origin if carving, else the clearing end / p - u * trunc
    """
    origin = origin.expand(points_G.shape)
    vec = points_G - origin
    norm = norm3(vec[:, 0], vec[:, 1], vec[:, 2])[:, None]
    unit = vec / torch.clamp(norm, min=1e-12)
    trunc = truncation_distance
    clear_len = torch.clamp(norm - trunc, 0.0, max_ray_length_m)
    clear_end = fma(unit, clear_len, origin)
    norm_end = fma(unit, trunc, points_G)
    end = torch.where(is_clearing[:, None], clear_end, norm_end)
    if voxel_carving_enabled:
        start = origin
    else:
        band_start = fma(-unit, trunc, points_G)
        start = torch.where(is_clearing[:, None], clear_end, band_start)
    if voxel_size == 1.0:
        return start, end
    inv = 1.0 / voxel_size
    return start * inv, end * inv


def dda_init(start3: torch.Tensor, end3: torch.Tensor, inv=None):
    """DDA set-up over (3, R) voxel-unit extents: (curr, n_steps, sign,
    t_next, t_step). Given `inv` (1 / voxel size), start3 and end3 are in
    world units and scaled here, and the ray's extent is end3 * inv -
    start3 * inv with the first product fused into the subtraction, the
    form XLA:CPU compiles the reference's DDA kernel to."""
    end_w = end3
    if inv is not None:
        start3, end3 = start3 * inv, end3 * inv
    curr = torch.floor(start3 + GRID_EPS).to(torch.int32)
    end_i = torch.floor(end3 + GRID_EPS).to(torch.int32)
    n_steps = (end_i - curr).abs().sum(dim=0)
    ray = end3 - start3 if inv is None else fma(end_w, inv, -start3)
    sign = torch.sign(ray).to(torch.int32)
    corrected = torch.clamp(sign, min=0).float()
    zero = ray == 0.0
    safe_ray = torch.where(zero, torch.ones_like(ray), ray)
    t_next = torch.where(zero, torch.full_like(ray, float("inf")),
                         (corrected - (start3 - curr.float())) / safe_ray)
    t_step = torch.where(zero, torch.zeros_like(ray), sign.float() / safe_ray)
    return curr, n_steps, sign, t_next, t_step


def dda_advance(curr, t_next, sign, t_step):
    """One DDA step along the axis of least crossing time (first-min
    tie-break)."""
    min01 = torch.minimum(t_next[0], t_next[1])
    a = torch.where(t_next[1] < t_next[0], 1, 0)
    axis = torch.where(t_next[2] < min01, 2, a)
    onehot = torch.arange(3, device=axis.device)[:, None] == axis[None, :]
    curr = curr + torch.where(onehot, sign, torch.zeros_like(sign))
    t_next = t_next + torch.where(onehot, t_step, torch.zeros_like(t_step))
    return curr, t_next


def traverse_soa(start3: torch.Tensor, end3: torch.Tensor, max_steps: int):
    """Run the DDA for all rays, (3, R) float32 voxel-unit extents.

    Returns voxels (S, 3, R) int32 global voxel coords per step and
    valid (S, R) bool (step within the ray's true length)."""
    curr, n_steps, sign, t_next, t_step = dda_init(start3, end3)
    voxels, valid = [], []
    for s in range(max_steps):
        voxels.append(curr)
        valid.append(s <= n_steps)
        curr, t_next = dda_advance(curr, t_next, sign, t_step)
    return torch.stack(voxels), torch.stack(valid)


def traverse(start_scaled: torch.Tensor, end_scaled: torch.Tensor,
             max_steps: int):
    """(R, 3)-layout wrapper around traverse_soa (tests, oracle
    comparisons): voxels (R, S, 3) and valid (R, S)."""
    voxels, valid = traverse_soa(start_scaled.T, end_scaled.T, max_steps)
    return voxels.permute(2, 0, 1), valid.T
