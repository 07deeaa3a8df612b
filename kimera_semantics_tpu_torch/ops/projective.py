"""Projective (voxel-centric) integration core.

Counterpart: kimera_semantics_tpu/ops/projective.py (block_patch_meta(_rows),
extract_patches(_multi), sample_patches, voxel_deltas(_multi),
update_terms_from_sample).
The per-voxel stage iterates the voxels of the frame's touched blocks and
samples the mip atlas at each voxel's projected pixel, at a per-block mip
level chosen so the block's projected bbox fits a row_window x col_window
patch whose origin is aligned to (8, 128).

`block_patch_meta` is the plain version of the block-meta kernel and
`sample_terms` + `voxel_deltas` of the fused sample-and-apply kernel
(ops/kernels.py). Sampling is the exact `gather` mode: a sample outside the
patch window reads 0, which is an invalid depth. Rounding follows the
reference's compiled form (core/fp.py), so pixels, levels and masks agree
bit for bit.

A camera transform is (4, 4), shared by every block, or per block row
(K, 1, 4, 4): the mixed-frame row path (voxel_deltas_multi), where row j
samples frame frame_idx[j]'s atlas with that frame's pose. Both go through
the same element-wise operations.
"""

from __future__ import annotations

import torch

from ..config import ColorMode, FusionConfig
from ..core import transforms
from ..core.fp import f32, fma, recip
from . import mip as mip_ops
from . import semantic as sem_ops
from . import tsdf as tsdf_ops

_Z_EPS = 1e-3


def _corner_offsets(device):
    return torch.tensor([[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)],
                        dtype=torch.float32, device=device)


def _floor_div(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def block_patch_meta(block_coords: torch.Tensor, T_C_G: torch.Tensor,
                     intr, plan: mip_ops.MipPlan, block_size: float):
    """Per-block mip level + aligned patch origin so every voxel of the
    block samples inside the patch window. Blocks with a corner at or
    behind the camera plane, or whose bbox needs more than the coarsest
    level, take the whole-image fallback (origin 0 at `plan.full_level`).

    Returns (level, u0_level, v0, u0_atlas) int32 tensors of shape (K,)."""
    return block_patch_meta_rows(block_coords, T_C_G[..., :3, :3],
                                 T_C_G[..., :3, 3], intr, plan, block_size)


def block_patch_meta_rows(block_coords: torch.Tensor, Rk: torch.Tensor,
                          tk: torch.Tensor, intr, plan: mip_ops.MipPlan,
                          block_size: float):
    """block_patch_meta with the camera rotation and translation shared
    (Rk (3, 3), tk (3,)) or per block row (Rk (K, 1, 3, 3), tk (K, 1, 3)):
    the mixed-frame row path."""
    corners = ((block_coords.float()[:, None, :]
                + _corner_offsets(block_coords.device)[None]) * block_size)
    c0, c1, c2 = corners[..., 0], corners[..., 1], corners[..., 2]
    cam = [fma(Rk[..., i, 2], c2, fma(Rk[..., i, 1], c1, Rk[..., i, 0] * c0))
           + tk[..., i] for i in range(3)]
    z = cam[2]
    zsafe = torch.clamp(z, min=_Z_EPS)
    u = intr.fx * cam[0] / zsafe + intr.cx
    v = intr.fy * cam[1] / zsafe + intr.cy
    front = z > _Z_EPS
    big = 1e9
    umin = torch.where(front, u, big).amin(dim=1)
    umax = torch.where(front, u, -big).amax(dim=1)
    vmin = torch.where(front, v, big).amin(dim=1)
    vmax = torch.where(front, v, -big).amax(dim=1)
    all_front = front.all(dim=1)

    # Division by the constant thresholds compiles to a multiply by their
    # float32 reciprocals in the reference; the level is a ladder of exact
    # power-of-two compares.
    need = torch.maximum((umax - umin) * recip(plan.col_threshold),
                         (vmax - vmin) * recip(plan.row_threshold))
    lvl = torch.zeros(need.shape, dtype=torch.int32, device=need.device)
    for l in range(plan.full_level):
        lvl = lvl + (need > float(1 << l)).to(torch.int32)
    bbox_ok = all_front & (need <= float(1 << plan.full_level))
    lvl = torch.where(bbox_ok, lvl, plan.full_level)

    offsets = torch.tensor(plan.offsets, dtype=torch.int32,
                           device=need.device)
    off_l = offsets[lvl.long()]
    zero = torch.zeros_like(lvl)
    vmin_l = torch.where(bbox_ok, (torch.floor(vmin).to(torch.int32) >> lvl)
                         - 1, zero)
    umin_l = torch.where(bbox_ok, (torch.floor(umin).to(torch.int32) >> lvl)
                         - 1, zero)
    v0 = torch.clamp(_floor_div(vmin_l, 8) * 8, 0,
                     plan.atlas_height - plan.row_window)
    u0a = torch.clamp(_floor_div(off_l + umin_l, 128) * 128, 0,
                      plan.atlas_width - plan.col_window)
    return lvl, u0a - off_l, v0, u0a


def meta_rows(block_coords, real, T_C_G, intr, plan, block_size):
    """block_patch_meta stacked into the (K, 8) int32 meta rows
    [v0, u0_atlas, real, lvl, u0_level, bx, by, bz] that the sample stage
    reads."""
    lvl, u0l, v0, u0a = block_patch_meta(block_coords, T_C_G, intr, plan,
                                         block_size)
    return torch.stack([v0, u0a, real.to(torch.int32), lvl, u0l,
                        block_coords[:, 0], block_coords[:, 1],
                        block_coords[:, 2]], dim=1)


def extract_patches(atlas: torch.Tensor, u0_atlas: torch.Tensor,
                    v0: torch.Tensor, plan: mip_ops.MipPlan) -> torch.Tensor:
    """(C, AH, AW) atlas -> (K, C, rows, cols) patches."""
    r = v0[:, None].long() + torch.arange(plan.row_window,
                                          device=atlas.device)[None]
    c = u0_atlas[:, None].long() + torch.arange(plan.col_window,
                                                device=atlas.device)[None]
    return atlas[:, r[:, :, None], c[:, None, :]].permute(1, 0, 2, 3)


def extract_patches_multi(atlases: torch.Tensor, frame_idx: torch.Tensor,
                          u0_atlas: torch.Tensor, v0: torch.Tensor,
                          plan: mip_ops.MipPlan) -> torch.Tensor:
    """(D, C, AH, AW) stacked atlases -> (K, C, rows, cols) patches, row j
    slicing atlas frame_idx[j]."""
    dev = atlases.device
    r = v0[:, None].long() + torch.arange(plan.row_window, device=dev)[None]
    c = u0_atlas[:, None].long() + torch.arange(plan.col_window,
                                                device=dev)[None]
    f = frame_idx.long()[:, None, None]
    return atlases[f, :, r[:, :, None], c[:, None, :]].permute(0, 3, 1, 2)


def sample_patches(patches: torch.Tensor, row: torch.Tensor,
                   col: torch.Tensor, mode: str = "gather") -> torch.Tensor:
    """Per-voxel patch sampling: (K, C, rows, cols), (K, V3) -> (K, V3, C).
    Out-of-window samples read 0."""
    if mode != "gather":
        raise ValueError(f"unknown sample mode: {mode} (the port samples "
                         "with 'gather' only)")
    K, C, rows, cols = patches.shape
    inwin = (row >= 0) & (row < rows) & (col >= 0) & (col < cols)
    idx = torch.where(inwin, row * cols + col, 0).long()
    flat = patches.reshape(K, C, rows * cols)
    out = torch.gather(flat, 2, idx[:, None, :].expand(K, C, idx.shape[1]))
    return torch.where(inwin[:, None, :], out, 0.0).permute(0, 2, 1)


def voxel_centers(coords: torch.Tensor, vps: int):
    """Voxel centers of K blocks in voxel units, three (K, V3) planes
    (global voxel index + 0.5)."""
    lin = torch.arange(vps ** 3, dtype=torch.int32, device=coords.device)
    local = (lin // (vps * vps), (lin // vps) % vps, lin % vps)
    return [(coords[:, a:a + 1] * vps + local[a][None]).float() + 0.5
            for a in range(3)]


def centers_to_camera(T_C_G: torch.Tensor, hx, hy, hz, voxel_size: float):
    """Camera-frame coordinates of voxel centers given in voxel units.

    The reference computes T[i, j] * (h_j * voxel_size); its compiler
    reassociates that into h_j * (T[i, j] * voxel_size) and fuses the
    first and third products into the sums, which this mirrors."""
    s = [[T_C_G[..., i, j] * voxel_size for j in range(3)] for i in range(3)]
    return [fma(hz, s[i][2], fma(hx, s[i][0], hy * s[i][1]))
            + T_C_G[..., i, 3] for i in range(3)]


def voxel_pixels(meta: torch.Tensor, T_C_G: torch.Tensor, cfg: FusionConfig,
                 intr, plan: mip_ops.MipPlan):
    """Where each voxel of the K blocks of `meta` samples: its camera
    coordinates (pX, pY, pZ, zsafe), whether its pixel lies in the image at
    the block's level (sample_ok), and its (row, col) in the block's patch
    window. Each (K, V3)."""
    g = cfg.grid
    v0, lvl, u0l = meta[:, 0], meta[:, 3], meta[:, 4]
    hx, hy, hz = voxel_centers(meta[:, 5:8], g.voxels_per_side)
    pX, pY, pZ = centers_to_camera(T_C_G, hx, hy, hz, g.voxel_size)
    zok = pZ > _Z_EPS
    zsafe = torch.clamp(pZ, min=_Z_EPS)
    u = intr.fx * pX / zsafe + intr.cx
    v = intr.fy * pY / zsafe + intr.cy
    ui = torch.floor(u + 0.5).to(torch.int32)
    vi = torch.floor(v + 0.5).to(torch.int32)
    in_img = (zok & (ui >= 0) & (ui < plan.width) & (vi >= 0)
              & (vi < plan.height))
    lv = lvl[:, None]
    ul = torch.clamp(ui, 0, plan.width - 1) >> lv
    vl = torch.clamp(vi, 0, plan.height - 1) >> lv
    lvl_ok = (ul < (plan.width >> lv)) & (vl < (plan.height >> lv))
    return (pX, pY, pZ, zsafe, in_img & lvl_ok, vl - v0[:, None],
            ul - u0l[:, None])


def sample_terms(meta: torch.Tensor, T_C_G: torch.Tensor,
                 atlas: torch.Tensor, cfg: FusionConfig, intr,
                 plan: mip_ops.MipPlan, region: str = "all",
                 frame_idx=None):
    """Sample + per-voxel update terms for the K blocks of `meta`
    (meta_rows layout). With `frame_idx` (K,), `atlas` stacks one atlas
    per frame (D, C, AH, AW) and T_C_G is per row (K, 1, 4, 4). Returns
    (w, w_sdf, cnt, label, upd, color_gate, rgb or None), each (K, V3),
    rgb (K, V3, 3) in COLOR mode."""
    v0, u0a, real = meta[:, 0], meta[:, 1], meta[:, 2]
    pX, pY, pZ, zsafe, sample_ok, row, col = voxel_pixels(meta, T_C_G, cfg,
                                                          intr, plan)
    with_color = cfg.semantic.color_mode == ColorMode.COLOR
    # Color mode samples all four channels, the others depth and label.
    n_ch = 4 if with_color else 2
    patches = (extract_patches(atlas[:n_ch], u0a, v0, plan)
               if frame_idx is None else
               extract_patches_multi(atlas[:, :n_ch], frame_idx, u0a, v0,
                                     plan))
    s = sample_patches(patches, row, col)                       # (K, V3, C)
    label = torch.round(s[..., 1]).to(torch.int32)
    w, w_sdf, cnt, upd, gate = update_terms_from_sample(
        s[..., 0], label, pX, pY, pZ, zsafe, sample_ok,
        real[:, None] > 0, cfg, region=region)
    rgb = mip_ops.unpack_color(s[..., 2], s[..., 3]) if with_color else None
    return w, w_sdf, cnt, label, upd, gate, rgb


def label_planes(label: torch.Tensor, cnt: torch.Tensor, num_labels: int,
                 lk_delta: float) -> torch.Tensor:
    """(K, V3) labels and counts -> (K, L, V3) sem_delta contributions:
    lk_delta on the plane of each counted voxel's label (labels outside
    [0, L) add to no plane), 0 elsewhere."""
    iota = torch.arange(num_labels, device=label.device)[None, :, None]
    return torch.where((label[:, None, :] == iota) & (cnt > 0)[:, None, :],
                       f32(lk_delta), 0.0)


def voxel_deltas(block_coords: torch.Tensor, real_block: torch.Tensor,
                 atlas: torch.Tensor, T_G_C: torch.Tensor, intr,
                 plan: mip_ops.MipPlan, cfg: FusionConfig,
                 sample_mode: str = "gather", region: str = "all"):
    """Dense per-voxel update contributions for K touched blocks.

    Returns a dict keyed like the grid channels: w, wsdf, cnt (K, V3),
    label (K, V3) int32, sem (K, L, V3), wcolor (K, 3, V3) (zeros unless
    ColorMode.COLOR)."""
    K = block_coords.shape[0]
    return voxel_deltas_multi(
        torch.zeros((K,), dtype=torch.int32, device=block_coords.device),
        block_coords, real_block, atlas[None], T_G_C[None], intr, plan, cfg,
        sample_mode, region=region)


def voxel_deltas_multi(frame_idx: torch.Tensor, block_coords: torch.Tensor,
                       real_block: torch.Tensor, atlases: torch.Tensor,
                       T_G_C_all: torch.Tensor, intr, plan: mip_ops.MipPlan,
                       cfg: FusionConfig, sample_mode: str = "gather",
                       region: str = "all"):
    """voxel_deltas over a mixed-frame row list: row j samples frame
    frame_idx[j]'s atlas with that frame's pose. atlases (D, C, AH, AW),
    T_G_C_all (D, 4, 4)."""
    if sample_mode != "gather":
        raise ValueError(f"unknown sample mode: {sample_mode}")
    g = cfg.grid
    T_C_G_all = torch.stack([transforms.inverse(t) for t in T_G_C_all])
    Tk = T_C_G_all[frame_idx.long()][:, None]                 # (K, 1, 4, 4)
    lvl, u0l, v0, u0a = block_patch_meta_rows(
        block_coords, Tk[..., :3, :3], Tk[..., :3, 3], intr, plan,
        g.block_size)
    meta = torch.stack([v0, u0a, real_block.to(torch.int32), lvl, u0l,
                        block_coords[:, 0], block_coords[:, 1],
                        block_coords[:, 2]], dim=1)
    w, w_sdf, cnt, label, upd, gate, rgb = sample_terms(
        meta, Tk, atlases, cfg, intr, plan, region, frame_idx=frame_idx)
    sem = label_planes(label, cnt, g.num_labels,
                       sem_ops.make_likelihood_cached(cfg).delta)
    if rgb is not None:
        wc = torch.where(upd & gate, w, 0.0)
        wcolor = (wc[:, :, None] * rgb).permute(0, 2, 1)
    else:
        wcolor = torch.zeros((w.shape[0], 3, w.shape[1]),
                             dtype=torch.float32, device=w.device)
    return {"w": w, "wsdf": w_sdf, "cnt": cnt, "label": label, "sem": sem,
            "wcolor": wcolor}


def update_terms_from_sample(depth, label, pX, pY, pZ, zsafe, sample_ok,
                             real, cfg: FusionConfig, region: str = "all"):
    """Per-voxel update math given the sampled (depth, label) and the
    voxel's camera coordinates.

    region: "all" updates the full traversal extent; "carve" keeps only
    free space strictly before the truncation band (plus clearing rays).

    Returns (w, w_sdf, cnt, upd, color_gate); w/w_sdf/cnt are 0 outside
    `upd`."""
    t, g = cfg.tsdf, cfg.grid
    depth_ok = (depth > 0.0) & (depth < mip_ops.DEPTH_SENTINEL * 0.5)

    # Surface point along the voxel's own camera ray: |P| = |p_C| * d / z.
    t_v = torch.sqrt(fma(pZ, pZ, fma(pX, pX, pY * pY)))
    ray_norm = t_v * depth / zsafe
    sdf = ray_norm - t_v

    finite = depth_ok & sample_ok
    too_close = ray_norm < t.min_ray_length_m
    beyond = ray_norm > t.max_ray_length_m
    clearing = beyond & t.allow_clear
    pvalid = finite & ~too_close & (~beyond | t.allow_clear)
    pvalid &= sem_ops.dynamic_label_mask(label, cfg.semantic)
    pvalid &= real

    trunc = t.truncation_distance
    if t.voxel_carving_enabled:
        normal_band = sdf >= -trunc
    else:
        normal_band = sdf.abs() <= trunc
    clear_len = torch.clamp(ray_norm - trunc, 0.0, t.max_ray_length_m)
    if t.voxel_carving_enabled:
        clear_band = t_v <= clear_len
    else:
        clear_band = (t_v - clear_len).abs() <= 0.5 * f32(g.voxel_size)
    upd = pvalid & ((clearing & clear_band) | (~clearing & normal_band))
    if region == "carve":
        upd = upd & (clearing | (sdf > trunc))
    elif region != "all":
        raise ValueError(f"unknown update region {region!r}")

    if t.use_const_weight:
        w_point = torch.ones_like(depth)
    else:
        w_point = torch.where(depth > 1e-6,
                              1.0 / torch.clamp(depth * depth, min=1e-12),
                              0.0)
    w, w_sdf, color_gate = tsdf_ops.update_terms(sdf, w_point, t,
                                                 g.voxel_size)
    w = torch.where(upd, w, 0.0)
    w_sdf = torch.where(upd, w_sdf, 0.0)
    sem_upd = upd & color_gate if cfg.semantic.update_near_surface_only \
        else upd
    cnt = torch.where(sem_upd & sem_ops.informative(label), 1.0, 0.0)
    return w, w_sdf, cnt, upd, color_gate
