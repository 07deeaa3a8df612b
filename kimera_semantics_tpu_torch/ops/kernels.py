"""The projective main path's kernels: wrappers, plain versions, launch
counts.

Counterpart: kimera_semantics_tpu/ops/pallas_kernels.py. Each TPU kernel of
the slice is a hand-written CUDA kernel (../csrc/*.cu, built by _build.py):

  dda_job_stream          K1  csrc/dda.cu         (pallas_kernels.dda_job_stream)
  block_meta              K2  csrc/block_meta.cu  (pallas_kernels.block_meta)
  projective_apply_fused  K3  csrc/proj_apply.cu  (pallas_kernels.projective_apply_fused)

Each wrapper takes its plain PyTorch version (`*_plain`, same signature)
only when its tensors lie on the CPU; on CUDA tensors it launches the kernel
or raises. `launches[name]` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import ColorMode, FusionConfig
from ..core.fp import f32, fma, recip
from . import _build
from . import projective as proj_ops
from . import raycast
from . import tsdf as tsdf_ops

launches = {"dda_job_stream": 0, "block_meta": 0,
            "projective_apply_fused": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            not t.is_contiguous() or t.device != device:
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _struct(name, fields):
    return type(name, (ctypes.Structure,), {"_fields_": [
        (f, ctypes.c_float if f.startswith("f_") else ctypes.c_int)
        for f in fields]})


# ---------------------------------------------------------------------------
# K1: DDA job stream
# ---------------------------------------------------------------------------

DdaParams = _struct("DdaParams", [
    "R", "S", "maxr", "vps", "ext", "use_dropoff",
    "f_inv", "f_voxel_size", "f_trunc", "f_dropoff_eps", "f_dropoff_scale"])


def max_runs(cfg: FusionConfig, S: int) -> int:
    """Upper bound on block transitions per job (pallas_kernels.max_runs)."""
    return S // cfg.grid.voxels_per_side + 5


def _dda_consts(cfg: FusionConfig):
    g, t = cfg.grid, cfg.tsdf
    vs = np.float32(g.voxel_size)
    scale = np.float32(1.0) / np.maximum(np.float32(t.truncation_distance)
                                         - vs, np.float32(1e-12))
    return dict(inv=f32(1.0 / g.voxel_size), voxel_size=float(vs),
                trunc=f32(t.truncation_distance), dropoff_eps=float(vs),
                dropoff_scale=float(scale))


def dda_job_stream_plain(cfg: FusionConfig, S: int, origin3, point3, start3,
                         end3, weights, job_valid):
    """Plain version of K1: traverse_soa's walk plus the stream math."""
    g, t = cfg.grid, cfg.tsdf
    vps, ext = g.voxels_per_side, g.world_extent_blocks
    MAXR = max_runs(cfg, S)
    c = _dda_consts(cfg)
    R = point3.shape[1]
    dev = point3.device
    vec = point3 - origin3
    dist_g = tsdf_ops.norm3(vec[0], vec[1], vec[2])
    curr, n_steps, sign, t_next, t_step = raycast.dda_init(
        start3 * c["inv"], end3 * c["inv"])
    ray_valid = job_valid.bool()
    trunc = c["trunc"]
    run_key = torch.full((MAXR, R), -1, dtype=torch.int32, device=dev)
    cols = torch.arange(R, device=dev)
    pos = torch.full((R,), -1, dtype=torch.int32, device=dev)
    prev = torch.full((R,), -2, dtype=torch.int32, device=dev)
    outs = [[] for _ in range(7)]
    for s in range(S):
        vx, vy, vz = curr[0], curr[1], curr[2]
        bx, by, bz = (torch.div(a, vps, rounding_mode="floor")
                      for a in (vx, vy, vz))
        key = ((bx + ext) << 20) | ((by + ext) << 10) | (bz + ext)
        local = ((vx - bx * vps) * vps + (vy - by * vps)) * vps + (vz - bz * vps)
        in_b = ((bx >= -ext) & (bx < ext) & (by >= -ext) & (by < ext)
                & (bz >= -ext) & (bz < ext))
        valid = (s <= n_steps) & ray_valid & in_b
        # (v + 0.5) * vs - origin, dotted with vec: the reference's
        # compiled form fuses each product into the add that follows.
        A = [fma(curr[a].float() + 0.5, c["voxel_size"], -origin3[a])
             for a in range(3)]
        num = fma(A[2], vec[2], fma(A[0], vec[0], A[1] * vec[1]))
        sdf = dist_g - num / torch.clamp(dist_g, min=1e-12)
        if t.use_weight_dropoff:
            scale = (trunc + sdf) * c["dropoff_scale"]
            w = torch.where(sdf < -c["dropoff_eps"],
                            torch.clamp(weights * scale, min=0.0), weights)
        else:
            w = weights
        w = torch.where(valid, w, 0.0)
        w_sdf = w * torch.clamp(sdf, -trunc, trunc)
        wc = torch.where(sdf.abs() < trunc, w, 0.0)
        changed = (key != prev) & valid
        pos = torch.clamp(pos + changed.to(torch.int32), max=MAXR - 1)
        run_key[pos[changed].long(), cols[changed]] = key[changed]
        for lst, val in zip(outs, (torch.where(valid, key, -1), local, w,
                                   w_sdf, wc, valid, pos)):
            lst.append(val)
        prev = torch.where(valid, key, prev)
        curr, t_next = raycast.dda_advance(curr, t_next, sign, t_step)
    key, local, w, w_sdf, wc, valid, run_idx = (torch.stack(o) for o in outs)
    return key, local, w, w_sdf, wc, valid, run_key, run_idx


def dda_job_stream(cfg: FusionConfig, S: int, origin3, point3, start3, end3,
                   weights, job_valid):
    """Expand traversal jobs into the per-(step, job) update stream.

    origin3/point3/start3/end3: (3, R) float32 world frame; weights (R,)
    float32; job_valid (R,) bool. Returns (key, local, w, wsdf, wc_gate,
    valid, run_key, run_idx): (S, R) planes (key -1 where invalid, valid
    bool) and the (MAXR, R) / (S, R) block-run streams."""
    if _on_cpu(point3):
        return dda_job_stream_plain(cfg, S, origin3, point3, start3, end3,
                                    weights, job_valid)
    g, t = cfg.grid, cfg.tsdf
    dev = point3.device
    R = point3.shape[1]
    MAXR = max_runs(cfg, S)
    for name, x in (("origin3", origin3), ("point3", point3),
                    ("start3", start3), ("end3", end3)):
        _check(x, name, torch.float32, (3, R), dev)
    _check(weights, "weights", torch.float32, (R,), dev)
    flags = job_valid.to(torch.int32).contiguous()
    _check(flags, "job_valid", torch.int32, (R,), dev)
    i32, f32_ = torch.int32, torch.float32
    outs = [torch.empty((S, R), dtype=d, device=dev)
            for d in (i32, i32, f32_, f32_, f32_, i32)]
    run_key = torch.empty((MAXR, R), dtype=i32, device=dev)
    run_idx = torch.empty((S, R), dtype=i32, device=dev)
    c = _dda_consts(cfg)
    p = DdaParams(R=R, S=S, maxr=MAXR, vps=g.voxels_per_side,
                  ext=g.world_extent_blocks,
                  use_dropoff=int(t.use_weight_dropoff), f_inv=c["inv"],
                  f_voxel_size=c["voxel_size"], f_trunc=c["trunc"],
                  f_dropoff_eps=c["dropoff_eps"],
                  f_dropoff_scale=c["dropoff_scale"])
    if R > 0:
        fn = _build.bind("dda", "ksd_dda_job_stream",
                         (ctypes.c_void_p,) * 6 + (DdaParams,)
                         + (ctypes.c_void_p,) * 9)
        _raise_on(fn(*(_ptr(x) for x in (origin3, point3, start3, end3,
                                          weights, flags)), p,
                     *(_ptr(x) for x in outs + [run_key, run_idx]),
                     _stream(dev)), "dda_job_stream")
        launches["dda_job_stream"] += 1
    key, local, w, wsdf, wc, valid = outs
    return key, local, w, wsdf, wc, valid.bool(), run_key, run_idx


# ---------------------------------------------------------------------------
# K2: block meta
# ---------------------------------------------------------------------------

MetaParams = _struct("MetaParams", [
    "K", "full_level", "width", "atlas_height", "row_window", "atlas_width",
    "col_window", "f_bs", "f_fx", "f_fy", "f_cx", "f_cy", "f_inv_col",
    "f_inv_row"])


def block_meta_plain(fcoords, freal, T_C_G, intr, plan, block_size):
    """Plain version of K2: block_patch_meta plus the meta stack."""
    return proj_ops.meta_rows(fcoords, freal, T_C_G, intr, plan, block_size)


def block_meta(fcoords, freal, T_C_G, intr, plan, block_size):
    """(K, 8) int32 meta rows [v0, u0_atlas, real, lvl, u0_level, bx, by,
    bz] of the frame list (fcoords (K, 3) int32, freal (K,) bool, T_C_G
    (4, 4) float32)."""
    if _on_cpu(fcoords):
        return block_meta_plain(fcoords, freal, T_C_G, intr, plan,
                                block_size)
    dev = fcoords.device
    K = fcoords.shape[0]
    _check(fcoords, "fcoords", torch.int32, (K, 3), dev)
    real = freal.to(torch.int32).contiguous()
    _check(real, "freal", torch.int32, (K,), dev)
    tcg = T_C_G[:3, :4].contiguous()
    _check(tcg, "T_C_G", torch.float32, (3, 4), dev)
    meta = torch.empty((K, 8), dtype=torch.int32, device=dev)
    p = MetaParams(K=K, full_level=plan.full_level, width=plan.width,
                   atlas_height=plan.atlas_height,
                   row_window=plan.row_window, atlas_width=plan.atlas_width,
                   col_window=plan.col_window, f_bs=f32(block_size),
                   f_fx=f32(intr.fx), f_fy=f32(intr.fy), f_cx=f32(intr.cx),
                   f_cy=f32(intr.cy),
                   f_inv_col=recip(plan.col_threshold),
                   f_inv_row=recip(plan.row_threshold))
    if K > 0:
        fn = _build.bind("block_meta", "ksd_block_meta",
                         (ctypes.c_void_p,) * 3 + (MetaParams,)
                         + (ctypes.c_void_p,) * 2)
        _raise_on(fn(_ptr(fcoords), _ptr(real), _ptr(tcg), p, _ptr(meta),
                     _stream(dev)), "block_meta")
        launches["block_meta"] += 1
    return meta


# ---------------------------------------------------------------------------
# K3: fused projective sample + apply
# ---------------------------------------------------------------------------

MAX_DYNAMIC_LABELS = 8
ProjParams = _struct("ProjParams", [
    "K", "V3", "vps", "L", "rows_total", "trash_group", "width", "height",
    "row_window", "col_window", "atlas_height", "atlas_width", "allow_clear",
    "carving", "region_carve", "use_const_weight", "use_dropoff",
    "near_surface_only", "with_color", "n_dyn",
    *(f"dyn{i}" for i in range(MAX_DYNAMIC_LABELS)),
    "f_voxel_size", "f_fx", "f_fy", "f_cx", "f_cy", "f_trunc", "f_min_ray",
    "f_max_ray", "f_dropoff_eps", "f_dropoff_scale", "f_half_vs",
    "f_lk_delta"])


def _check_channels(wsum, wsdf, sem_count, sem_delta, wcolor, dev):
    R, V3 = wsum.shape
    L = sem_delta.shape[0]
    for name, x, shape in (("wsum", wsum, (R, V3)), ("wsdf", wsdf, (R, V3)),
                           ("sem_count", sem_count, (R, V3)),
                           ("sem_delta", sem_delta, (L, R, V3)),
                           ("wcolor", wcolor, (3, R, V3))):
        _check(x, name, torch.float32, shape, dev)
    return R, V3, L


def projective_apply_fused_plain(wsum, wsdf, sem_count, sem_delta, wcolor,
                                 slots, meta, T_C_G, atlas, cfg, intr, plan,
                                 lk_delta, with_color=False, region="all"):
    """Plain version of K3: the gather-mode sample and update terms
    (ops/projective.py sample_terms) plus an `index_add_` apply. Rows not
    marked real in `meta` carry zero deltas and are skipped."""
    if with_color != (cfg.semantic.color_mode == ColorMode.COLOR):
        raise ValueError("with_color must match cfg.semantic.color_mode")
    w, w_sdf, cnt, label, upd, gate, rgb = proj_ops.sample_terms(
        meta, T_C_G, atlas, cfg, intr, plan, region)
    real = meta[:, 2] > 0
    rows = slots[real].long()
    wsum.index_add_(0, rows, w[real])
    wsdf.index_add_(0, rows, w_sdf[real])
    sem_count.index_add_(0, rows, cnt[real])
    planes = proj_ops.label_planes(label[real], cnt[real],
                                   sem_delta.shape[0], lk_delta)
    sem_delta.index_add_(1, rows, planes.permute(1, 0, 2))
    if with_color:
        wc = torch.where(upd & gate, w, 0.0)[real]
        wcolor.index_add_(1, rows, (wc[..., None] * rgb[real]).permute(2, 0, 1))
    return wsum, wsdf, sem_count, sem_delta, wcolor


def projective_apply_fused(wsum, wsdf, sem_count, sem_delta, wcolor, slots,
                           meta, T_C_G, atlas, cfg, intr, plan, lk_delta,
                           with_color=False, region="all"):
    """grid_channel[slots] += sample(meta, atlas), IN PLACE on the channel
    tensors (the JAX kernel aliases them instead).

    slots: the group-aligned frame list (grid/hash.py insert_frame_list);
    meta: (K, 8) block_meta rows; T_C_G (4, 4); atlas (4, AH, AW). Tile
    groups whose slot group is the grid's trash group are skipped. Returns
    the five channel tensors."""
    if _on_cpu(wsum):
        return projective_apply_fused_plain(
            wsum, wsdf, sem_count, sem_delta, wcolor, slots, meta, T_C_G,
            atlas, cfg, intr, plan, lk_delta, with_color, region)
    if with_color != (cfg.semantic.color_mode == ColorMode.COLOR):
        raise ValueError("with_color must match cfg.semantic.color_mode")
    if region not in ("all", "carve"):
        raise ValueError(f"unknown update region {region!r}")
    g, t, sem = cfg.grid, cfg.tsdf, cfg.semantic
    dev = wsum.device
    R, V3, L = _check_channels(wsum, wsdf, sem_count, sem_delta, wcolor, dev)
    K = meta.shape[0]
    if K % 8 or V3 != g.vps3 or R != g.padded_rows:
        raise ValueError("frame list must be 8-row aligned and the channels "
                         "shaped by cfg.grid")
    _check(slots, "slots", torch.int32, (K,), dev)
    _check(meta, "meta", torch.int32, (K, 8), dev)
    tcg = T_C_G[:3, :4].contiguous()
    _check(tcg, "T_C_G", torch.float32, (3, 4), dev)
    _check(atlas, "atlas", torch.float32,
           (4, plan.atlas_height, plan.atlas_width), dev)
    dyn = tuple(sem.dynamic_labels)
    if len(dyn) > MAX_DYNAMIC_LABELS:
        raise ValueError(f"at most {MAX_DYNAMIC_LABELS} dynamic labels")
    dyn = dyn + (0,) * (MAX_DYNAMIC_LABELS - len(dyn))
    p = ProjParams(
        K=K, V3=V3, vps=g.voxels_per_side, L=L, rows_total=R,
        trash_group=(R - 8) // 8, width=plan.width, height=plan.height,
        row_window=plan.row_window, col_window=plan.col_window,
        atlas_height=plan.atlas_height, atlas_width=plan.atlas_width,
        allow_clear=int(t.allow_clear), carving=int(t.voxel_carving_enabled),
        region_carve=int(region == "carve"),
        use_const_weight=int(t.use_const_weight),
        use_dropoff=int(t.use_weight_dropoff),
        near_surface_only=int(sem.update_near_surface_only),
        with_color=int(with_color), n_dyn=len(sem.dynamic_labels),
        **{f"dyn{i}": d for i, d in enumerate(dyn)},
        f_voxel_size=f32(g.voxel_size), f_fx=f32(intr.fx), f_fy=f32(intr.fy),
        f_cx=f32(intr.cx), f_cy=f32(intr.cy),
        f_trunc=f32(t.truncation_distance), f_min_ray=f32(t.min_ray_length_m),
        f_max_ray=f32(t.max_ray_length_m), f_dropoff_eps=f32(g.voxel_size),
        f_dropoff_scale=tsdf_ops.dropoff_scale(t, g.voxel_size),
        f_half_vs=0.5 * f32(g.voxel_size), f_lk_delta=f32(lk_delta))
    if K > 0:
        fn = _build.bind("proj_apply", "ksd_proj_apply_fused",
                         (ctypes.c_void_p,) * 9 + (ProjParams, ctypes.c_void_p))
        _raise_on(fn(*(_ptr(x) for x in (wsum, wsdf, sem_count, sem_delta,
                                          wcolor, slots, meta, tcg, atlas)),
                     p, _stream(dev)), "projective_apply_fused")
        launches["projective_apply_fused"] += 1
    return wsum, wsdf, sem_count, sem_delta, wcolor
