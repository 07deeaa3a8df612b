"""The port's kernels: wrappers, plain versions, launch counts.

Counterpart: kimera_semantics_tpu/ops/pallas_kernels.py and the `_add`
kernel of scripts/profile_scatter_r4.py. Every TPU kernel of the repo is a
hand-written CUDA kernel here (../csrc/*.cu, built by _build.py):

  dda_job_stream          K1  csrc/dda.cu           (pallas_kernels.dda_job_stream)
  block_meta              K2  csrc/block_meta.cu    (pallas_kernels.block_meta)
  projective_apply_fused  K3  csrc/proj_apply.cu    (pallas_kernels.projective_apply_fused)
  projective_sample_update K4 csrc/proj_sample.cu   (pallas_kernels.projective_sample_update)
  slot_resolve_stream     K6  csrc/slot_resolve.cu  (pallas_kernels.slot_resolve_stream,
                                                     cube_geometry, cube_lut_supported)
  block_rmw_add           K5  csrc/block_rmw.cu     (pallas_kernels.block_rmw_add)
  add_f32                 K7  csrc/add.cu           (scripts/profile_scatter_r4.py _add)

and two kernels with no Pallas counterpart, the block hash table's probe
loops, which the JAX package runs as jax.lax.while_loops inside its jitted
programs (grid/hash.py lookup, insert):

  hash_lookup             H1  csrc/hash.cu          (grid/hash.py lookup, lookup_bounded)
  hash_insert             H2  csrc/hash.cu          (grid/hash.py insert)

and a chain of three with none, the decimated carve jobs and their
compaction, which the JAX package builds with XLA ops:

  carve_jobs_compact      C1  csrc/carve.cu         (ops/carve.py carve_jobs, compact_jobs)

Each wrapper takes its plain PyTorch version (`*_plain`, same signature)
only when its tensors lie on the CPU; on CUDA tensors it launches the kernel
or raises. `launches[name]` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import ColorMode, FusionConfig
from ..core.fp import f32, fma, recip
from ..grid import hash as bhash
from . import _build
from . import carve as carve_ops
from . import projective as proj_ops
from . import raycast
from . import tsdf as tsdf_ops

launches = {"dda_job_stream": 0, "block_meta": 0,
            "projective_apply_fused": 0, "projective_sample_update": 0,
            "slot_resolve_stream": 0, "block_rmw_add": 0, "add_f32": 0,
            "hash_lookup": 0, "hash_insert": 0, "carve_jobs_compact": 0}


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


def _ptr(t):
    """A tensor's device address for ctypes; None (NULL) for None."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


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
                         end3, weights, job_valid, keys_only=False):
    """Plain version of K1: traverse_soa's walk plus the stream math."""
    g, t = cfg.grid, cfg.tsdf
    vps, ext = g.voxels_per_side, g.world_extent_blocks
    MAXR = max_runs(cfg, S)
    c = _dda_consts(cfg)
    R = point3.shape[1]
    dev = point3.device
    curr, n_steps, sign, t_next, t_step = raycast.dda_init(
        start3, end3, c["inv"])
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
        sdf = tsdf_ops.projective_sdf_soa(origin3.T, point3.T, vx[None],
                                          vy[None], vz[None],
                                          c["voxel_size"])[0]
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
    if keys_only:
        return key, None, None, None, None, valid, None, None
    return key, local, w, w_sdf, wc, valid, run_key, run_idx


def dda_job_stream(cfg: FusionConfig, S: int, origin3, point3, start3, end3,
                   weights, job_valid, keys_only=False):
    """Expand traversal jobs into the per-(step, job) update stream.

    origin3/point3/start3/end3: (3, R) float32 world frame; weights (R,)
    float32; job_valid (R,) bool. Returns (key, local, w, wsdf, wc_gate,
    valid, run_key, run_idx): (S, R) planes (key -1 where invalid, valid
    bool) and the (MAXR, R) / (S, R) block-run streams. With `keys_only`
    (the allocation walk) only key and valid are returned, the others are
    None; the kernel then reads only start3, end3 and job_valid."""
    if _on_cpu(point3):
        return dda_job_stream_plain(cfg, S, origin3, point3, start3, end3,
                                    weights, job_valid, keys_only)
    g, t = cfg.grid, cfg.tsdf
    dev = point3.device
    R = point3.shape[1]
    MAXR = max_runs(cfg, S)
    for name, x in (("origin3", origin3), ("point3", point3),
                    ("start3", start3), ("end3", end3)):
        _check(x, name, torch.float32, (3, R), dev)
    _check(weights, "weights", torch.float32, (R,), dev)
    _check(job_valid, "job_valid", torch.bool, (R,), dev)
    plane = lambda d: torch.empty((S, R), dtype=d, device=dev)  # noqa: E731
    key, valid = plane(torch.int32), plane(torch.bool)
    local = w = wsdf = wc = run_key = run_idx = None
    if not keys_only:
        local, run_idx = plane(torch.int32), plane(torch.int32)
        w, wsdf, wc = (plane(torch.float32) for _ in range(3))
        run_key = torch.empty((MAXR, R), dtype=torch.int32, device=dev)
    c = _dda_consts(cfg)
    p = DdaParams(R=R, S=S, maxr=MAXR, vps=g.voxels_per_side,
                  ext=g.world_extent_blocks,
                  use_dropoff=int(t.use_weight_dropoff), f_inv=c["inv"],
                  f_voxel_size=c["voxel_size"], f_trunc=c["trunc"],
                  f_dropoff_eps=c["dropoff_eps"],
                  f_dropoff_scale=c["dropoff_scale"])
    if R > 0:
        fn = _build.bind("dda", "ksd_dda_job_stream",
                         (ctypes.c_void_p,) * 6 + (DdaParams, ctypes.c_int)
                         + (ctypes.c_void_p,) * 9)
        _raise_on(fn(*(_ptr(x) for x in (origin3, point3, start3, end3,
                                          weights, job_valid)), p,
                     int(keys_only),
                     *(_ptr(x) for x in (key, local, w, wsdf, wc, valid,
                                         run_key, run_idx)),
                     _stream(dev)), "dda_job_stream")
        launches["dda_job_stream"] += 1
    return key, local, w, wsdf, wc, valid, run_key, run_idx


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
    _check(freal, "freal", torch.bool, (K,), dev)
    # the kernel reads rows 0-2 of the pose on the card: its first 12 words
    _check(T_C_G, "T_C_G", torch.float32, (4, 4), dev)
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
        _raise_on(fn(_ptr(fcoords), _ptr(freal), _ptr(T_C_G), p, _ptr(meta),
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


def _check_proj_mode(cfg: FusionConfig, with_color: bool, region: str):
    if with_color != (cfg.semantic.color_mode == ColorMode.COLOR):
        raise ValueError("with_color must match cfg.semantic.color_mode")
    if region not in ("all", "carve"):
        raise ValueError(f"unknown update region {region!r}")


def _check_proj_inputs(slots, meta, T_C_G, atlas, plan, K, dev):
    """Check the frame list, meta rows and atlas of K3/K4; returns T_C_G's
    top 3 x 4 rows."""
    _check(slots, "slots", torch.int32, (K,), dev)
    _check(meta, "meta", torch.int32, (K, 8), dev)
    tcg = T_C_G[:3, :4].contiguous()
    _check(tcg, "T_C_G", torch.float32, (3, 4), dev)
    _check(atlas, "atlas", torch.float32,
           (4, plan.atlas_height, plan.atlas_width), dev)
    return tcg


def _proj_params(cfg: FusionConfig, intr, plan, K: int, L: int,
                 with_color: bool, region: str, lk_delta: float):
    """The ProjParams of K3 and K4 (csrc/proj_common.cuh)."""
    g, t, sem = cfg.grid, cfg.tsdf, cfg.semantic
    dyn = tuple(sem.dynamic_labels)
    if len(dyn) > MAX_DYNAMIC_LABELS:
        raise ValueError(f"at most {MAX_DYNAMIC_LABELS} dynamic labels")
    dyn = dyn + (0,) * (MAX_DYNAMIC_LABELS - len(dyn))
    R = g.padded_rows
    return ProjParams(
        K=K, V3=g.vps3, vps=g.voxels_per_side, L=L, rows_total=R,
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
    _check_proj_mode(cfg, with_color, region)
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
    _check_proj_mode(cfg, with_color, region)
    g = cfg.grid
    dev = wsum.device
    R, V3, L = _check_channels(wsum, wsdf, sem_count, sem_delta, wcolor, dev)
    K = meta.shape[0]
    if K % 8 or V3 != g.vps3 or R != g.padded_rows:
        raise ValueError("frame list must be 8-row aligned and the channels "
                         "shaped by cfg.grid")
    tcg = _check_proj_inputs(slots, meta, T_C_G, atlas, plan, K, dev)
    p = _proj_params(cfg, intr, plan, K, L, with_color, region, lk_delta)
    if K > 0:
        fn = _build.bind("proj_apply", "ksd_proj_apply_fused",
                         (ctypes.c_void_p,) * 9 + (ProjParams, ctypes.c_void_p))
        _raise_on(fn(*(_ptr(x) for x in (wsum, wsdf, sem_count, sem_delta,
                                          wcolor, slots, meta, tcg, atlas)),
                     p, _stream(dev)), "projective_apply_fused")
        launches["projective_apply_fused"] += 1
    return wsum, wsdf, sem_count, sem_delta, wcolor


# ---------------------------------------------------------------------------
# K4: projective sample + update terms as delta planes
# ---------------------------------------------------------------------------

def projective_sample_update_plain(meta, slots, T_C_G, atlas, cfg, intr,
                                   plan, with_color=False, region="all"):
    """Plain version of K4: the sample and update terms of K3's plain
    version (ops/projective.py sample_terms) as delta planes, zero wherever
    there is no update (every row, the trash tiles' included)."""
    _check_proj_mode(cfg, with_color, region)
    w, w_sdf, cnt, label, upd, gate, rgb = proj_ops.sample_terms(
        meta, T_C_G, atlas, cfg, intr, plan, region)
    d_lab = torch.where(upd, label, 0)
    d_wc = None
    if with_color:
        wc = torch.where(upd & gate, w, 0.0)[..., None]
        d_wc = torch.where(wc > 0.0, wc * rgb, 0.0).permute(0, 2, 1)
        d_wc = d_wc.contiguous()
    return w, w_sdf, cnt, d_lab, d_wc


def projective_sample_update(meta, slots, T_C_G, atlas, cfg, intr, plan,
                             with_color=False, region="all"):
    """Per-voxel sample + update terms of the K blocks of `meta`, written
    out as deltas for K5 (block_rmw_add, onehot votes) to add.

    meta: (K, 8) block_meta rows; slots: the group-aligned frame list
    (grid/hash.py insert_frame_list), which names the tiles K5 skips (slot
    group outside the live rows); T_C_G (4, 4); atlas (4, AH, AW). Returns
    (d_w, d_wsdf, d_cnt (K, V3) float32, d_lab (K, V3) int32 (0 where not
    updated), d_wc (K, 3, V3) float32 in ColorMode.COLOR, else None). Rows
    of the tiles K5 skips are left unwritten by the kernel."""
    if _on_cpu(meta):
        return projective_sample_update_plain(meta, slots, T_C_G, atlas, cfg,
                                              intr, plan, with_color, region)
    _check_proj_mode(cfg, with_color, region)
    g = cfg.grid
    dev = meta.device
    K, V3 = meta.shape[0], g.vps3
    if K % 8:
        raise ValueError("frame list must be 8-row aligned")
    tcg = _check_proj_inputs(slots, meta, T_C_G, atlas, plan, K, dev)
    p = _proj_params(cfg, intr, plan, K, g.num_labels, with_color, region,
                     0.0)
    outs = [torch.empty((K, V3), dtype=d, device=dev)
            for d in (torch.float32, torch.float32, torch.float32,
                      torch.int32)]
    d_wc = (torch.empty((K, 3, V3), dtype=torch.float32, device=dev)
            if with_color else None)
    if K > 0:
        fn = _build.bind("proj_sample", "ksd_projective_sample_update",
                         (ctypes.c_void_p,) * 9 + (ProjParams, ctypes.c_void_p))
        _raise_on(fn(*(_ptr(x) for x in outs),
                     _ptr(d_wc) if d_wc is not None else None,
                     *(_ptr(x) for x in (slots, meta, tcg, atlas)), p,
                     _stream(dev)), "projective_sample_update")
        launches["projective_sample_update"] += 1
    return (*outs, d_wc)


# ---------------------------------------------------------------------------
# K6: slot resolve against the frame's camera cube
# ---------------------------------------------------------------------------

TRASH_KEY = 0x7FFFFFFF
SlotParams = _struct("SlotParams", [
    "R", "S", "maxr", "per_frame", "side", "E", "ext", "v3", "cap", "pad",
    "lab_shift", "gate_near", "f_trunc"])


def cube_geometry(cfg: FusionConfig):
    """Static cube extent: blocks within max_ray + trunc (+1 slack) of the
    camera block. Returns (E, side, padded cell count)."""
    reach = cfg.tsdf.max_ray_length_m + cfg.tsdf.truncation_distance
    E = int(np.ceil(reach / cfg.grid.block_size)) + 1
    side = 2 * E + 1
    pad = ((side ** 3 + 127) // 128) * 128
    return E, side, pad


def cube_lut_supported(cfg: FusionConfig) -> bool:
    """The same cube-size limit as the reference, so both packages take the
    cube path on the same configurations (a direct load has no limit of
    its own)."""
    return cube_geometry(cfg)[2] <= 8192


def slot_resolve_stream_plain(cfg: FusionConfig, cube_vals, cam_block,
                              run_key, run_idx, local, w, wsdf, wc,
                              step_valid, labels, informative,
                              lab_shift: int, gate_near: bool):
    """Plain version of K6: a gather from the frame cube per run, the run
    slots broadcast to the steps, and the masked segment-reduce inputs."""
    g = cfg.grid
    E, side, _ = cube_geometry(cfg)
    S, R = local.shape
    dev = local.device
    cam_block = cam_block.reshape(-1, 3)
    per_frame = R // cube_vals.shape[0]
    frame = torch.arange(R, device=dev) // per_frame
    cb = cam_block[frame].T                                  # (3, R)
    ext = g.world_extent_blocks
    rk = run_key
    b = [((rk >> sh) & 0x3FF) - ext - cb[a][None, :] + E
         for a, sh in enumerate((20, 10, 0))]
    in_c = rk >= 0
    for c in b:
        in_c = in_c & (c >= 0) & (c < side)
    cidx = torch.where(in_c, (b[0] * side + b[1]) * side + b[2], 0)
    vals = cube_vals[frame[None, :].expand_as(cidx), cidx.long()]
    run_slots = torch.where(in_c, vals.to(torch.int32), -1)
    ok = run_idx >= 0
    slot = torch.where(ok, run_slots.gather(
        0, run_idx.clamp(min=0).long()), -1)
    v = step_valid & (slot >= 0) & (slot < g.block_capacity)
    key = slot * g.vps3 + local
    k2, w_m, wsdf_off, _, cnt = segment_inputs(
        v, key, w, wsdf, wc, labels, informative,
        f32(cfg.tsdf.truncation_distance), lab_shift, gate_near)
    return k2, w_m, wsdf_off, cnt, key, v, run_slots


def segment_inputs(v, key, w, wsdf, wc, labels, informative, trunc,
                   lab_shift: int, gate_near: bool):
    """The masked segment-reduce inputs of one (S, R) update stream, shared
    by K6's plain version and the hash-lookup path of ops/integrate.py:
    k2 = (key << lab_shift) | label (TRASH_KEY where v is false), w and
    wsdf + trunc * w masked by v, the semantic gate (v, and wc > 0 with
    gate_near) and its count where the job is informative. labels (R,)
    int32 must fit lab_shift bits; informative (R,) bool. Returns (k2, w_m,
    wsdf_off, sem_upd, cnt)."""
    k2 = torch.where(v, (key << lab_shift) | labels[None, :], TRASH_KEY)
    w_m = torch.where(v, w, 0.0)
    wsdf_off = torch.where(v, fma(w, trunc, wsdf), 0.0)
    sem_upd = v & (wc > 0.0) if gate_near else v
    cnt = torch.where(sem_upd & informative[None, :], 1.0, 0.0)
    return k2, w_m, wsdf_off, sem_upd, cnt


def slot_resolve_stream(cfg: FusionConfig, cube_vals, cam_block, run_key,
                        run_idx, local, w, wsdf, wc, step_valid, labels,
                        informative, lab_shift: int, gate_near: bool):
    """Resolve the block slots of one expanded stream against the frame
    cube(s) and emit the segment-reduce inputs.

    cube_vals: (B, pad) float32 slot per cube cell (-1 missing), from
    ops/integrate.py frame_cube; B > 1 when the ray axis concatenates B
    frames in equal chunks. cam_block: (B, 3) or (3,) int32. run_key/run_idx
    (MAXR, R)/(S, R) from K1; local/w/wsdf/wc (S, R); step_valid (S, R)
    bool; labels (R,) int32; informative (R,) bool. Returns (k2, w_m,
    wsdf_off, cnt, key, valid_upd, run_slots): k2 (S, R) int32
    (voxel << lab_shift | label, TRASH_KEY where invalid), the masked w,
    wsdf + trunc * w and semantic count, the raw flat voxel key, valid_upd
    (S, R) bool and run_slots (MAXR, R) int32 (-1 where unresolved)."""
    if _on_cpu(local):
        return slot_resolve_stream_plain(
            cfg, cube_vals, cam_block, run_key, run_idx, local, w, wsdf, wc,
            step_valid, labels, informative, lab_shift, gate_near)
    g = cfg.grid
    E, side, pad = cube_geometry(cfg)
    dev = local.device
    S, R = local.shape
    MAXR = run_key.shape[0]
    B = cube_vals.shape[0]
    if R % B:
        raise ValueError(f"slot_resolve_stream: R {R} is not a multiple of "
                         f"the {B} frame cubes")
    cam = cam_block.reshape(-1, 3).to(torch.int32).contiguous()
    _check(cube_vals, "cube_vals", torch.float32, (B, pad), dev)
    _check(cam, "cam_block", torch.int32, (B, 3), dev)
    _check(run_key, "run_key", torch.int32, (MAXR, R), dev)
    for name, x, dt in (("run_idx", run_idx, torch.int32),
                        ("local", local, torch.int32),
                        ("w", w, torch.float32), ("wsdf", wsdf, torch.float32),
                        ("wc", wc, torch.float32)):
        _check(x, name, dt, (S, R), dev)
    valid = step_valid.contiguous()
    labs = labels.to(torch.int32).contiguous()
    inform = informative.contiguous()
    _check(valid, "step_valid", torch.bool, (S, R), dev)
    _check(labs, "labels", torch.int32, (R,), dev)
    _check(inform, "informative", torch.bool, (R,), dev)
    i32, f32_ = torch.int32, torch.float32
    outs = [torch.empty((S, R), dtype=d, device=dev)
            for d in (i32, f32_, f32_, f32_, i32, torch.bool)]
    run_slots = torch.empty((MAXR, R), dtype=i32, device=dev)
    p = SlotParams(R=R, S=S, maxr=MAXR, per_frame=R // B, side=side, E=E,
                   ext=g.world_extent_blocks, v3=g.vps3,
                   cap=g.block_capacity, pad=pad, lab_shift=lab_shift,
                   gate_near=int(gate_near),
                   f_trunc=f32(cfg.tsdf.truncation_distance))
    if R > 0:
        fn = _build.bind("slot_resolve", "ksd_slot_resolve",
                         (ctypes.c_void_p,) * 11 + (SlotParams,)
                         + (ctypes.c_void_p,) * 8)
        _raise_on(fn(*(_ptr(x) for x in (cube_vals, cam, run_key, run_idx,
                                          local, w, wsdf, wc, valid, labs,
                                          inform)), p,
                     *(_ptr(x) for x in outs + [run_slots]), _stream(dev)),
                  "slot_resolve_stream")
        launches["slot_resolve_stream"] += 1
    k2, w_m, wsdf_off, cnt, key, vu = outs
    return k2, w_m, wsdf_off, cnt, key, vu, run_slots


# ---------------------------------------------------------------------------
# K5: block read-modify-write add
# ---------------------------------------------------------------------------

RmwParams = _struct("RmwParams", [
    "K", "V3", "L", "P", "rows_total", "trash_group", "sem_mode", "f_lk"])
SEM_MODES = ("onehot", "dense", "packed")


def _sem_mode(L: int, d_sem, sem_packed_ranks: int) -> str:
    """The semantic delta form, decided as the reference decides it."""
    if d_sem is None:
        return "onehot"
    if d_sem.shape[0] == L and sem_packed_ranks != L:
        return "dense"
    return "packed"


def _tile_rows(slots: torch.Tensor, rows_total: int):
    """(src, dst): the delta rows of live tiles and the channel rows they
    add into. Tile i's 8 rows go to the rows of group slots[8 i] // 8;
    tiles of the trash group (or outside the live rows) are skipped."""
    K = slots.shape[0]
    groups = torch.div(slots[::8], 8, rounding_mode="floor")
    k = torch.arange(K, device=slots.device)
    live = ((groups >= 0) & (groups < (rows_total - 8) // 8))[k // 8]
    dst = groups.long()[k // 8] * 8 + k % 8
    return k[live], dst[live]


def block_rmw_add_plain(wsum, wsdf, sem_count, sem_delta, wcolor, slots,
                        d_w, d_wsdf, d_cnt, d_lab, d_wc, lk_delta,
                        d_sem=None, sem_packed_ranks=0):
    """Plain version of K5: the same adds by row indexing."""
    L = sem_delta.shape[0]
    mode = _sem_mode(L, d_sem, sem_packed_ranks)
    src, dst = _tile_rows(slots, wsum.shape[0])
    for ch, d in ((wsum, d_w), (wsdf, d_wsdf), (sem_count, d_cnt)):
        ch[dst] = ch[dst] + d[src]
    sem = sem_delta[:, dst]
    labs = torch.arange(L, device=sem.device)[:, None, None]
    if mode == "onehot":
        sem = sem + torch.where(labs == d_lab[src][None],
                                d_cnt[src][None] * f32(lk_delta), 0.0)
    elif mode == "dense":
        sem = fma(d_sem[:, src], f32(lk_delta), sem)
    else:
        for r in range(d_sem.shape[0]):
            v = d_sem[r, src]
            cr = torch.floor(v * (1.0 / 32.0))
            lr = (v - 32.0 * cr).to(torch.int32)
            sem = sem + torch.where(labs == lr[None],
                                    cr[None] * f32(lk_delta), 0.0)
    sem_delta[:, dst] = sem
    if d_wc is not None:
        wcolor[:, dst] = wcolor[:, dst] + d_wc[src].permute(1, 0, 2)
    return wsum, wsdf, sem_count, sem_delta, wcolor


def block_rmw_add(wsum, wsdf, sem_count, sem_delta, wcolor, slots, d_w,
                  d_wsdf, d_cnt, d_lab, d_wc, lk_delta, d_sem=None,
                  sem_packed_ranks=0):
    """grid_channel[rows of slots] += delta, IN PLACE on the channels (the
    JAX kernel aliases them instead); returns the five channels.

    `slots` (K,) is group-aligned: 8-row tile i adds into the 8 rows of
    channel tile group slots[8 i] // 8, distinct per tile; tiles of the
    trash group (the last 8 rows) are skipped. Deltas: d_w/d_wsdf/d_cnt
    (K, V3) float32; the semantic votes as one label per voxel (d_lab
    (K, V3) int32, counts d_cnt; onehot), dense counts per label
    (d_sem (L, K, V3)) or packed rank planes (d_sem (P, K, V3) of
    count * 32 + label; exact while count < 2^19); d_wc (K, 3, V3), or None
    when the colour channels take no update (only ColorMode.COLOR blends
    measured colour). Only nonzero deltas are read-modify-written: adding
    +0.0 changes no value the grid holds. On the card, V3 % 8 == 0 with
    every tensor on a 16-byte boundary takes the fast instances (16-byte
    grid words, bulk copies of whole delta rows); any other V3 or
    alignment takes the generic instance (4-byte words)."""
    if _on_cpu(wsum):
        return block_rmw_add_plain(wsum, wsdf, sem_count, sem_delta, wcolor,
                                   slots, d_w, d_wsdf, d_cnt, d_lab, d_wc,
                                   lk_delta, d_sem, sem_packed_ranks)
    dev = wsum.device
    rows, V3, L = _check_channels(wsum, wsdf, sem_count, sem_delta, wcolor,
                                  dev)
    K = d_w.shape[0]
    if K % 8 or rows % 8:
        raise ValueError("block_rmw_add: K and the channel rows must be "
                         "multiples of 8")
    mode = _sem_mode(L, d_sem, sem_packed_ranks)
    _check(slots, "slots", torch.int32, (K,), dev)
    for name, x in (("d_w", d_w), ("d_wsdf", d_wsdf), ("d_cnt", d_cnt)):
        _check(x, name, torch.float32, (K, V3), dev)
    P = 0
    if mode == "onehot":
        _check(d_lab, "d_lab", torch.int32, (K, V3), dev)
        sem_ptr = None
    else:
        P = d_sem.shape[0]
        _check(d_sem, "d_sem", torch.float32, (P, K, V3), dev)
        sem_ptr = d_sem
    if d_wc is not None:
        _check(d_wc, "d_wc", torch.float32, (K, 3, V3), dev)
    p = RmwParams(K=K, V3=V3, L=L, P=P, rows_total=rows,
                  trash_group=(rows - 8) // 8,
                  sem_mode=SEM_MODES.index(mode), f_lk=f32(lk_delta))
    if K > 0:
        fn = _build.bind("block_rmw", "ksd_block_rmw_add",
                         (ctypes.c_void_p,) * 12 + (RmwParams,
                                                    ctypes.c_void_p))
        args = (wsum, wsdf, sem_count, sem_delta, wcolor, slots, d_w, d_wsdf,
                d_cnt, d_lab if mode == "onehot" else None, sem_ptr, d_wc)
        _raise_on(fn(*(_ptr(x) for x in args), p, _stream(dev)),
                  "block_rmw_add")
        launches["block_rmw_add"] += 1
    return wsum, wsdf, sem_count, sem_delta, wcolor


# ---------------------------------------------------------------------------
# K7: elementwise add (the profiling tool's warm-kernel probe)
# ---------------------------------------------------------------------------

def add_f32_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: x + y."""
    return x + y


def add_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """o = x + y for two float32 tensors of one shape (K7,
    tools/profile_scatter.py --warm-kernel)."""
    if _on_cpu(x):
        return add_f32_plain(x, y)
    dev = x.device
    _check(x, "x", torch.float32, x.shape, dev)
    _check(y, "y", torch.float32, x.shape, dev)
    o = torch.empty_like(x)
    if x.numel() > 0:
        fn = _build.bind("add", "ksd_add_f32",
                         (ctypes.c_void_p,) * 3 + (ctypes.c_longlong,
                                                   ctypes.c_void_p))
        _raise_on(fn(_ptr(x), _ptr(y), _ptr(o), x.numel(), _stream(dev)),
                  "add_f32")
        launches["add_f32"] += 1
    return o


# ---------------------------------------------------------------------------
# H1, H2: the block hash table's probe loops
# ---------------------------------------------------------------------------

# H2's instances (csrc/hash.cu), chosen by the table's size: "shared" keeps
# table_keys in shared memory and bids with codes in the key words
# (HASH_SHARED_MIN <= table_size <= HASH_SHARED_MAX, tensors on 16-byte
# boundaries); "generic", the first design, works in place on copies of the
# tables and bids into a bid array (in shared memory up to HASH_SHARED_MAX
# entries, in global scratch beyond).
HASH_INSERT_INSTANCES = ("shared", "generic")
HASH_SHARED_MIN, HASH_SHARED_MAX = 128, 32768
# Past this many keys (16 a thread) the shared-table instance keeps the
# probe state outside registers, in shared memory where it fits beside the
# table, else in a global scratch that the wrapper allocates.
_H2_REGISTER_KEYS = 16 * 1024
_GENERIC_GLOBAL_BID, _GENERIC_SMEM_BID, _SHARED_TABLE = 0, 1, 2
HashInsertParams = _struct("HashInsertParams", [
    "n", "table_size", "capacity", "ext", "max_probes", "instance"])


def hash_lookup_plain(table_keys, table_slots, keys, table_size: int,
                      rounds: int):
    """Plain version of H1: the probe rounds as tensor ops, ending early
    (a host sync per round) once every probe has ended."""
    mask = table_size - 1
    idx = (bhash.mix(keys) & mask).long()
    result = torch.full_like(keys, -1)
    done = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    for _ in range(rounds):
        k = table_keys[idx]
        hit = (k == keys) & ~done
        miss = (k == bhash.EMPTY_KEY) & ~done
        result = torch.where(hit, table_slots[idx], result)
        done = done | hit | miss
        if bool(done.all()):
            break
        idx = torch.where(done, idx, (idx + 1) & mask)
    return result, done.all()


def _check_table(table_keys, table_slots, table_size: int, dev):
    if table_size & (table_size - 1) or not 0 < table_size <= 1 << 30:
        raise ValueError(f"table_size {table_size} must be a power of two "
                         "up to 2^30")
    _check(table_keys, "table_keys", torch.int32, (table_size,), dev)
    _check(table_slots, "table_slots", torch.int32, (table_size,), dev)


def hash_lookup(table_keys, table_slots, keys, table_size: int,
                rounds: int):
    """Key -> slot by at most `rounds` linear probe rounds from
    mix(key) & (table_size - 1); a probe ends at its key or at EMPTY_KEY
    (not at TOMBSTONE_KEY). keys (N,) int32. Returns (slots (N,) int32, -1
    where missing or unfinished; complete, a 0-d bool on the device, false
    if any probe was still running after `rounds`). H1 serves each key with
    16 lanes, each window of 16 positions loaded at once and the first that
    ends the probe picked by a ballot."""
    if _on_cpu(keys):
        return hash_lookup_plain(table_keys, table_slots, keys, table_size,
                                 rounds)
    dev = keys.device
    N = keys.shape[0]
    _check_table(table_keys, table_slots, table_size, dev)
    _check(keys, "keys", torch.int32, (N,), dev)
    slots = torch.empty((N,), dtype=torch.int32, device=dev)
    complete = torch.ones((), dtype=torch.bool, device=dev)
    if N > 0:
        fn = _build.bind("hash", "ksd_hash_lookup",
                         (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3
                         + (ctypes.c_void_p,) * 3)
        _raise_on(fn(_ptr(table_keys), _ptr(table_slots), _ptr(keys), N,
                     table_size, rounds, _ptr(slots), _ptr(complete),
                     _stream(dev)), "hash_lookup")
        launches["hash_lookup"] += 1
    return slots, complete


def hash_insert_plain(table_keys, table_slots, block_coords, n_blocks, keys,
                      active, table_size: int, capacity: int, extent: int):
    """Plain version of H2: claim_plain's rounds, then assign_slots_plain."""
    tk, pending, _ = claim_plain(table_keys, keys, active, table_size)
    tk, ts, bc, nb, slot_overflow = assign_slots_plain(
        tk, table_slots, block_coords, n_blocks, capacity, extent)
    return tk, ts, bc, nb, slot_overflow + pending.sum(dtype=torch.int32)


def claim_plain(table_keys, keys, active, table_size: int):
    """H2's first phase as tensor ops. Each probe round, of the pending keys
    bidding for one EMPTY or TOMBSTONE position the one of largest batch
    index wins (scatter_reduce "amax"), the rule of XLA:CPU's and torch's
    CPU scatter; the rounds end early (a host sync per round) once no key is
    pending. Scatters go through one trash entry past the table's last,
    which is then cut off. Returns (table_keys, the keys still pending, the
    rounds run)."""
    mask = table_size - 1
    dev = keys.device
    N = keys.shape[0]
    trash = torch.full((1,), bhash.EMPTY_KEY, dtype=torch.int32, device=dev)
    tk = torch.cat([table_keys, trash])
    idx = (bhash.mix(keys) & mask).long()
    pending = active.clone()
    batch = torch.arange(N, device=dev)
    rounds = 0
    for _ in range(bhash.MAX_PROBES):
        if not bool(pending.any()):
            break
        rounds += 1
        k = tk[idx]
        pending = pending & (k != keys)
        bidding = ((k == bhash.EMPTY_KEY) | (k == bhash.TOMBSTONE_KEY)) \
            & pending
        at = torch.where(bidding, idx, table_size)
        bid = torch.full((table_size + 1,), -1, dtype=torch.int64,
                         device=dev)
        bid.scatter_reduce_(0, at, batch, "amax")
        winner = bidding & (bid[idx] == batch)
        tk[torch.where(winner, idx, table_size)] = keys
        pending = pending & (tk[idx] != keys)
        idx = torch.where(pending, (idx + 1) & mask, idx)
    return tk[:table_size], pending, rounds


def assign_slots_plain(table_keys, table_slots, block_coords, n_blocks,
                       capacity: int, extent: int):
    """H2's second phase as tensor ops: the claimed positions with no slot
    yet take slots n_blocks, n_blocks + 1, ... in table order below
    `capacity` and write their block coordinates; the rest roll back to
    TOMBSTONE_KEY. Returns (table_keys, table_slots, block_coords,
    n_blocks, slot overflow)."""
    tk = table_keys
    is_new = ((tk != bhash.EMPTY_KEY) & (tk != bhash.TOMBSTONE_KEY)
              & (table_slots < 0))
    order = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    new_slots = n_blocks + order
    fits = is_new & (new_slots < capacity)
    ts = torch.where(fits, new_slots, table_slots)
    tk = torch.where(is_new & ~fits, bhash.TOMBSTONE_KEY, tk)
    bc = torch.cat([block_coords, block_coords.new_zeros((1, 3))])
    bc[torch.where(fits, ts, capacity).long()] = bhash.unpack_block_key(
        tk, extent)
    return (tk, ts, bc[:capacity], n_blocks + fits.sum(dtype=torch.int32),
            (is_new & ~fits).sum(dtype=torch.int32))


def hash_insert_instance(table_size: int, *tensors) -> str:
    """H2's instance for a table of `table_size` entries: "shared" where
    HASH_SHARED_MIN <= table_size <= HASH_SHARED_MAX (every table of the
    port's configurations) and every tensor given lies on a 16-byte
    boundary, else "generic". Decided on the host, from shapes and
    addresses: no sync."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return ("shared" if aligned and HASH_SHARED_MIN <= table_size
            <= HASH_SHARED_MAX else "generic")


def hash_insert(table_keys, table_slots, block_coords, n_blocks, keys,
                active, table_size: int, capacity: int, extent: int,
                instance: str | None = None):
    """Batch-insert packed block keys and give new blocks slots (H2, one
    CTA). keys (N,) int32, active (N,) bool, the active keys non-negative
    (H2 bids with negative codes in the table's key words); n_blocks a 0-d
    int32 on the device. Returns new (table_keys, table_slots,
    block_coords, n_blocks, overflow), the inputs unmodified: a key claims
    the first EMPTY or TOMBSTONE position of its probe, the largest batch
    index winning a contested one; new positions take slots n_blocks,
    n_blocks + 1, ... in table order below `capacity`, the rest roll back
    to TOMBSTONE_KEY; overflow counts those and the keys still unplaced
    after MAX_PROBES rounds. `instance` (HASH_INSERT_INSTANCES) overrides
    hash_insert_instance's choice. The shared-table instance writes fresh
    outputs itself; the generic one works on copies of the inputs."""
    if _on_cpu(keys):
        return hash_insert_plain(table_keys, table_slots, block_coords,
                                 n_blocks, keys, active, table_size,
                                 capacity, extent)
    dev = keys.device
    N = keys.shape[0]
    _check_table(table_keys, table_slots, table_size, dev)
    _check(block_coords, "block_coords", torch.int32, (capacity, 3), dev)
    _check(n_blocks, "n_blocks", torch.int32, (), dev)
    _check(keys, "keys", torch.int32, (N,), dev)
    _check(active, "active", torch.bool, (N,), dev)
    if instance is None:
        instance = hash_insert_instance(table_size, table_keys, table_slots,
                                        block_coords)
    if instance not in HASH_INSERT_INSTANCES:
        raise ValueError(f"instance {instance!r} not in "
                         f"{HASH_INSERT_INSTANCES}")
    nb = torch.empty((), dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    state = bid = None
    if instance == "generic":
        tk, ts = table_keys.clone(), table_slots.clone()
        bc = block_coords.clone()
        state = torch.empty((max(N, 1),), dtype=torch.int32, device=dev)
        code = _GENERIC_SMEM_BID
        if table_size > HASH_SHARED_MAX:
            code = _GENERIC_GLOBAL_BID
            bid = torch.full((table_size,), -1, dtype=torch.int32,
                             device=dev)
    else:
        code = _SHARED_TABLE
        tk, ts = torch.empty_like(table_keys), torch.empty_like(table_slots)
        bc = torch.empty_like(block_coords)
        if N > _H2_REGISTER_KEYS:
            state = torch.empty((N,), dtype=torch.int32, device=dev)
    p = HashInsertParams(n=N, table_size=table_size, capacity=capacity,
                         ext=extent, max_probes=bhash.MAX_PROBES,
                         instance=code)
    fn = _build.bind("hash", "ksd_hash_insert",
                     (ctypes.c_void_p,) * 11 + (HashInsertParams,)
                     + (ctypes.c_void_p,) * 3)
    _raise_on(fn(*(_ptr(x) for x in (table_keys, table_slots, block_coords,
                                      n_blocks, keys, active, state, bid, tk,
                                      ts, bc)), p, _ptr(nb), _ptr(overflow),
                 _stream(dev)), "hash_insert")
    launches["hash_insert"] += 1
    return tk, ts, bc, nb, overflow


# ---------------------------------------------------------------------------
# The decimated carve jobs, compacted (no Pallas counterpart)
# ---------------------------------------------------------------------------

CarveParams = _struct("CarveParams", [
    "H", "W", "Hp", "Wp", "allow_clear", "use_const_weight", "n_dyn",
    *(f"dyn{i}" for i in range(MAX_DYNAMIC_LABELS)),
    *(f"plane{i}" for i in range(6)), "base_off", "n_chunks", "total",
    "budget", "out_n", "f_cx", "f_cy", "f_ifx", "f_ify", "f_min_ray",
    "f_max_ray", "f_inf", "f_m_clamp", "f_trunc"])
_CARVE_TILE = 512              # job slots a CTA of csrc/carve.cu's slot kernels
CARVE_LAUNCHES = 3             # kernels a carve_jobs_compact call launches


def carve_jobs_compact_plain(depth, labels_img, T_G_C, intr, cfg, plan,
                             budget: int):
    """Plain version: ops/carve.py carve_jobs, then compact_jobs."""
    return carve_ops.compact_jobs(carve_ops.carve_jobs(
        depth, labels_img, T_G_C, intr, cfg, plan), budget)


@functools.lru_cache(maxsize=None)
def _carve_setup(plan, H: int, W: int, device, budget: int, tsdf, dyn,
                 intr):
    """What a call launches with, made once per (plan, image size, device,
    budget, TSDF settings, dynamic labels, camera): the plan's chunk table
    (ops/carve.py carve_table) and its copy on `device`, so that a frame
    uploads nothing, the kernels' parameters, the job count J and the
    slot kernels' CTAs."""
    if len(dyn) > MAX_DYNAMIC_LABELS:
        raise ValueError(f"at most {MAX_DYNAMIC_LABELS} dynamic labels")
    tab = carve_ops.carve_table(plan, H, W)
    J = min(tab.total, budget)
    p = CarveParams(
        H=H, W=W, Hp=tab.Hp, Wp=tab.Wp, allow_clear=int(tsdf.allow_clear),
        use_const_weight=int(tsdf.use_const_weight), n_dyn=len(dyn),
        **{f"dyn{i}": d for i, d in enumerate(
            dyn + (0,) * (MAX_DYNAMIC_LABELS - len(dyn)))},
        **{f"plane{i}": o for i, o in enumerate(tab.planes)},
        base_off=tab.base_off, n_chunks=tab.chunks.shape[0],
        total=tab.total, budget=budget, out_n=J, f_cx=f32(intr.cx),
        f_cy=f32(intr.cy), f_ifx=recip(intr.fx), f_ify=recip(intr.fy),
        f_min_ray=f32(tsdf.min_ray_length_m),
        f_max_ray=f32(tsdf.max_ray_length_m), f_inf=f32(3.0e38),
        f_m_clamp=f32(2.0 * tsdf.max_ray_length_m + 1.0),
        f_trunc=f32(tsdf.truncation_distance))
    return (tab, torch.from_numpy(tab.chunks).to(device), p, J,
            (tab.total + _CARVE_TILE - 1) // _CARVE_TILE)


def carve_jobs_compact(depth, labels_img, T_G_C, intr, cfg: FusionConfig,
                       plan, budget: int):
    """One frame's decimated carve jobs compacted to `budget`: (JobBatch of
    min(slots, budget) jobs, dropped). depth (H, W) float32, labels_img
    (H, W) int32, T_G_C (4, 4) float32, `plan` from ops/carve.py
    plan_carve; dropped is a 0-d int32, max(valid slots - budget, 0).
    Three launches of csrc/carve.cu write the jobs bit for bit as the
    plain version does, the invalid slots that fill past the valid ones
    included; nothing is read back to the host."""
    if _on_cpu(depth):
        return carve_jobs_compact_plain(depth, labels_img, T_G_C, intr, cfg,
                                        plan, budget)
    dev = depth.device
    H, W = depth.shape
    _check(depth, "depth", torch.float32, (H, W), dev)
    _check(labels_img, "labels_img", torch.int32, (H, W), dev)
    _check(T_G_C, "T_G_C", torch.float32, (4, 4), dev)
    tab, table, p, J, n_blocks = _carve_setup(
        plan, H, W, dev, budget, cfg.tsdf,
        tuple(cfg.semantic.dynamic_labels), intr)
    # Few allocations (each a torch op on the host): the five (J, 3) fields
    # as one block, and the kernels' scratch (the planes' minima and
    # labels, the CTAs' counts: 4-byte words) as one buffer.
    origin, point, start, end, color = torch.empty(
        (5, J, 3), dtype=torch.float32, device=dev).unbind(0)
    weight = torch.empty((J,), dtype=torch.float32, device=dev)
    label = torch.empty((J,), dtype=torch.int32, device=dev)
    valid = torch.empty((J,), dtype=torch.bool, device=dev)
    dropped = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty((2 * tab.cells + n_blocks,), dtype=torch.int32,
                          device=dev)
    mplane, lplane, counts = (ctypes.c_void_p(scratch.data_ptr() + 4 * o)
                              for o in (0, tab.cells, 2 * tab.cells))
    fn = _build.bind("carve", "ksd_carve_jobs",
                     (ctypes.c_void_p,) * 4 + (CarveParams,)
                     + (ctypes.c_void_p,) * 13)
    _raise_on(fn(*(_ptr(x) for x in (depth, labels_img, T_G_C, table)), p,
                 mplane, lplane, counts,
                 *(_ptr(x) for x in (origin, point, start, end, weight,
                                     label, color, valid, dropped)),
                 _stream(dev)), "carve_jobs_compact")
    launches["carve_jobs_compact"] += CARVE_LAUNCHES
    return carve_ops.JobBatch(origin=origin, point=point, start=start,
                              end=end, weight=weight, label=label,
                              color=color, valid=valid), dropped
