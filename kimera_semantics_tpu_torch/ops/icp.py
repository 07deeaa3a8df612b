"""Scan-to-map pose refinement, the `enable_icp` capability.

Counterpart: kimera_semantics_tpu/ops/icp.py (sample_tsdf, _exp_se3,
align_to_map). Voxblox's TsdfServer can align each incoming cloud to the
map before integration (`enable_icp`, kimera_semantics.launch:111). The
reference re-derives it against the TSDF itself: minimise
    E(xi) = sum_i phi(exp(xi) * T0 * p_i)^2
over the twist xi, with phi the trilinearly interpolated map TSDF, by damped
Gauss-Newton steps.

The reference takes the Jacobian with `jax.jacfwd` through the sampler.
Here the port's hash lookup ends probe rounds in data-dependent control
flow, which forward-mode autodiff cannot trace; but the slots depend only
on floor() of the points, whose derivative is zero. So each iteration
resolves the 8 corner slots once, outside any derivative, and writes the
trilinear gradient g = d phi / d p analytically; the Jacobian row of a
left-applied twist (w, v) at xi = 0 is [q x g, g], q the point in the
world frame. The lookups take a fixed number of probe rounds with no host
sync; one check after the last iteration redoes the alignment with
complete lookups in the rare case a probe ran longer. The iterations are
a Python loop (the reference's lax.scan) with no host sync.
"""

from __future__ import annotations

import torch

from ..config import FusionConfig
from ..grid import blocks as gblocks
from ..grid.blocks import VoxelGrid

# Probe rounds of the corner lookups before the completeness check.
LOOKUP_ROUNDS = 16
_CORNERS = [(dx, dy, dz) for dx in range(2) for dy in range(2)
            for dz in range(2)]


def _corner_samples(grid: VoxelGrid, cfg: FusionConfig, points, rounds):
    """The trilinear support of world points (N, 3): (frac (N, 3), per
    corner in the reference's order a list of (dist (N,), weight (N,)),
    complete). Corners in missing blocks read dist 0 and weight 0: the
    reference reads its trash tile as unobserved, and so does the port."""
    g = cfg.grid
    vps, v3, cap = g.voxels_per_side, g.vps3, g.block_capacity
    x = points / g.voxel_size - 0.5          # voxel-centre lattice coords
    base = torch.floor(x).to(torch.int32)
    frac = x - base
    # The corner offsets in _CORNERS order, made on the device (a copy from
    # the host would wait for the stream).
    c = torch.arange(8, dtype=torch.int32, device=points.device)
    off = torch.stack([c >> 2, (c >> 1) & 1, c & 1], dim=-1)
    corner = base[:, None, :] + off[None]                      # (N, 8, 3)
    block, lin = gblocks.voxel_to_block_local(corner, vps)
    if rounds:
        slots, complete = gblocks.lookup_slots(grid, block, g,
                                               rounds=rounds)
    else:
        slots, complete = gblocks.lookup_slots(grid, block, g), None
    ok = slots < cap
    keys = (torch.where(ok, slots, 0).long() * v3 + lin).reshape(-1)
    ws = grid.wsum.view(-1)[keys].reshape(ok.shape)
    wsdf = grid.wsdf.view(-1)[keys].reshape(ok.shape)
    t = cfg.tsdf.truncation_distance
    dist = torch.clamp(wsdf / torch.clamp(ws, min=1e-12), -t, t)
    dist = torch.where(ok, dist, 0.0)
    w = torch.where(ok, ws, 0.0)
    return frac, [(dist[:, c], w[:, c]) for c in range(8)], complete


def _weights(frac):
    """Per corner, the trilinear weight's three factors, in the reference's
    form dx + (1 - 2 dx) (1 - f)."""
    one = 1.0 - frac
    return [tuple(d + (1 - 2 * d) * one[:, a] for a, d in enumerate(c))
            for c in _CORNERS]


def _sample(frac, samples, with_grad=False, voxel_size=1.0):
    out_d = torch.zeros(frac.shape[:-1], dtype=torch.float32,
                        device=frac.device)
    out_w = torch.full_like(out_d, float("inf"))
    grad = torch.zeros_like(frac) if with_grad else None
    for c, ((fx, fy, fz), (d, w)) in zip(_CORNERS, zip(_weights(frac),
                                                       samples)):
        out_d = out_d + fx * fy * fz * d
        out_w = torch.minimum(out_w, w)
        if with_grad:
            # d(weight)/d(frac_a) = (2 d_a - 1) times the other factors.
            sx, sy, sz = (2 * c[0] - 1, 2 * c[1] - 1, 2 * c[2] - 1)
            grad = grad + torch.stack([sx * fy * fz, fx * sy * fz,
                                       fx * fy * sz], dim=-1) * d[:, None]
    out_w = torch.where(torch.isfinite(out_w), out_w, 0.0)
    if with_grad:
        grad = grad / voxel_size
    return out_d, out_w, grad


def sample_tsdf(grid: VoxelGrid, cfg: FusionConfig, points: torch.Tensor):
    """Trilinear TSDF sample at world points (N, 3) -> (dist (N,), wmin
    (N,)); wmin is the least accumulated weight of the 8 support voxels,
    zero where the sample touches unobserved space."""
    frac, samples, _ = _corner_samples(grid, cfg, points, 0)
    d, w, _ = _sample(frac, samples)
    return d, w


def _skew(w):
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def _exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """Twist (6,) = (rot_vec, trans) -> (4, 4), Rodrigues with the
    reference's Taylor-safe coefficients at small angles."""
    w, v = xi[:3], xi[3:]
    t2 = (w * w).sum()
    small = t2 < 1e-8
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2_safe)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2_safe)
    wx = _skew(w)
    rot = torch.eye(3, dtype=xi.dtype, device=xi.device) + a * wx + b * (
        wx @ wx)
    out = torch.eye(4, dtype=xi.dtype, device=xi.device)
    out[:3, :3] = rot
    out[:3, 3] = v
    return out


def residual_jacobian(grid: VoxelGrid, cfg: FusionConfig, points_C, valid,
                      T: torch.Tensor, rounds: int = 0):
    """The scan-to-map residuals at pose T and their Jacobian in the
    left-applied world twist (w, v) at zero: (r (N,), m (N,) bool, J (N,
    6), complete). The reference takes J with jax.jacfwd; here row i is
    [q_i x g_i, g_i] with q_i the world point and g_i the trilinear
    gradient, zero where the point is gated out."""
    trunc = cfg.tsdf.truncation_distance
    q = points_C @ T[:3, :3].T + T[:3, 3]
    frac, samples, complete = _corner_samples(grid, cfg, q, rounds)
    d, w, g = _sample(frac, samples, with_grad=True,
                      voxel_size=cfg.grid.voxel_size)
    # Clamped samples sit on the truncation plateau: zero pull, but their
    # trilinear edges give spurious gradients; gate them out.
    m = valid & (w > 1e-3) & (d.abs() < 0.9 * trunc)
    r = torch.where(m, d, 0.0)
    jac = torch.where(m[:, None], torch.cat(
        [torch.linalg.cross(q, g), g], dim=-1), 0.0)
    return r, m, jac, complete


def _align(grid, cfg, points_C, valid, T_G_C, iters, damping,
           refine_roll_pitch, min_match_ratio, rounds):
    vs = cfg.grid.voxel_size
    # The solved columns of the world twist (w, v): all six, or without
    # roll and pitch yaw and translation only, the last four
    # (voxblox icp_refine_roll_pitch).
    k = 6 if refine_roll_pitch else 4
    dev = points_C.device
    sel = torch.arange(6 - k, 6, device=dev)
    eye = torch.eye(k, dtype=torch.float32, device=dev)
    T = T_G_C.float()
    rms = ratio = torch.zeros((), dtype=torch.float32, device=dev)
    complete = torch.ones((), dtype=torch.bool, device=dev)
    n_valid = valid.sum().float().clamp(min=1)
    for _ in range(iters):
        r, m, jac, comp = residual_jacobian(grid, cfg, points_C, valid, T,
                                            rounds)
        if comp is not None:
            complete = complete & comp
        jac = jac[:, sel]
        grad = jac.T @ r
        hess = jac.T @ jac
        hess = hess + damping * eye * (1.0 + torch.trace(hess) / k)
        step_r = -torch.linalg.solve_ex(hess, grad)[0]
        step = torch.zeros(6, dtype=torch.float32, device=dev)
        step[sel] = step_r
        step = torch.where(torch.isfinite(step).all(), step,
                           torch.zeros_like(step))
        # Trust region on the twist magnitude (one voxel).
        norm = torch.linalg.vector_norm(step) + 1e-12
        step = step * torch.clamp(vs / norm, max=1.0)
        ms = m.sum().float()
        rms = torch.sqrt((r * r).sum() / ms.clamp(min=1))
        ratio = ms / n_valid
        T = _exp_se3(step) @ T
    T = torch.where(ratio >= min_match_ratio, T, T_G_C.float())
    return T, rms, ratio, complete


def align_to_map(grid: VoxelGrid, cfg: FusionConfig, points_C: torch.Tensor,
                 valid: torch.Tensor, T_G_C: torch.Tensor, iters: int = 6,
                 damping: float = 1e-3, refine_roll_pitch: bool = True,
                 min_match_ratio: float = 0.0):
    """Refine T_G_C so `points_C` (N, 3) agree with the map TSDF.

    Returns (T_refined (4, 4), rms_residual (), match_ratio ()) as tensors
    on the grid's device; rms and the ratio are those of the last
    iteration, taken before its step, as in the reference. With
    `refine_roll_pitch` False the world-frame twist keeps to yaw and
    translation; if fewer than `min_match_ratio` of the valid points land on
    observed, in-band TSDF, T_G_C comes back unchanged."""
    args = (grid, cfg, points_C.float(), valid, T_G_C, iters, damping,
            refine_roll_pitch, min_match_ratio)
    T, rms, ratio, complete = _align(*args, LOOKUP_ROUNDS)
    if not bool(complete):
        T, rms, ratio, _ = _align(*args, 0)
    return T, rms, ratio
