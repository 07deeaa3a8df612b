"""Traversal jobs of the ray integrators, and octave-decimated carving.

Counterpart: kimera_semantics_tpu/ops/carve.py (JobBatch, full_jobs,
band_jobs, CarvePlan, plan_carve, carve_jobs, band_octave_keep,
compact_jobs); CarveTable, carve_table and decimated_jobs have none (the
plan as csrc/carve.cu reads it, and the call into it). A job walks the
voxels from `start` to `end` and scores each against the surface sample
`point` seen from `origin`. Full-resolution rays walk only their
truncation band; free space is carved by decimated jobs from a min-pooled
mip of the ray reach, at about one ray per voxel at every distance (the
analogue of the reference's early ray termination,
semantic_tsdf_integrator_fast.cpp:110-121), or by the dense projective
carve (models/fast.py).

Rounding follows the reference's compiled form (core/fp.py): a product
added to something is one fused multiply-add, division by a constant is a
multiply by its float32 reciprocal, and the 3x3 rotation is written out
(no matmul).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..config import FusionConfig
from ..core.camera import PinholeIntrinsics
from ..core.fp import f32, fma, recip
from ..grid.hash import mul_i32
from . import raycast
from . import semantic as sem_ops
from .reduce import stable_compact_order
from .tsdf import norm3

JOB_FIELDS = ("origin", "point", "start", "end", "weight", "label", "color",
              "valid")


@dataclasses.dataclass(frozen=True)
class JobBatch:
    """A batch of DDA traversal jobs (the generalized ray)."""

    origin: torch.Tensor   # (J, 3) f32
    point: torch.Tensor    # (J, 3) f32 surface sample (sdf anchor)
    start: torch.Tensor    # (J, 3) f32 traversal start
    end: torch.Tensor      # (J, 3) f32 traversal end
    weight: torch.Tensor   # (J,) f32
    label: torch.Tensor    # (J,) int32
    color: torch.Tensor    # (J, 3) f32
    valid: torch.Tensor    # (J,) bool

    def take(self, idx: torch.Tensor) -> "JobBatch":
        return JobBatch(*(getattr(self, f)[idx] for f in JOB_FIELDS))


def full_jobs(origin, points_G, weights, labels, colors, is_clearing, valid,
              cfg: FusionConfig) -> JobBatch:
    """voxblox ray extents (raycast.setup_rays, world units) as jobs."""
    t = cfg.tsdf
    origin = origin.expand(points_G.shape)
    start, end = raycast.setup_rays(
        origin, points_G, is_clearing, voxel_size=1.0,
        truncation_distance=t.truncation_distance,
        max_ray_length_m=t.max_ray_length_m,
        voxel_carving_enabled=t.voxel_carving_enabled)
    return JobBatch(origin=origin, point=points_G, start=start, end=end,
                    weight=weights, label=labels, color=colors, valid=valid)


def band_jobs(origin, points_G, weights, labels, colors, is_clearing, valid,
              cfg: FusionConfig) -> JobBatch:
    """Truncation-band-only jobs: a normal ray walks [dist - trunc,
    dist + trunc] along itself; clearing rays have no band."""
    t = cfg.tsdf
    trunc = f32(t.truncation_distance)
    origin = origin.expand(points_G.shape)
    vec = points_G - origin
    norm = norm3(vec[:, 0], vec[:, 1], vec[:, 2])[:, None]
    unit = vec / torch.clamp(norm, min=1e-12)
    band = torch.clamp(norm, max=trunc)
    start = fma(-unit, band, points_G)
    end = fma(unit, trunc, points_G)
    return JobBatch(origin=origin, point=points_G, start=start, end=end,
                    weight=weights, label=labels, color=colors,
                    valid=valid & ~is_clearing)


@dataclasses.dataclass(frozen=True)
class CarvePlan:
    """Static decimation plan: levels (k, lo, hi), mip factor k carving ray
    distances (lo, hi]; chunks per level, (t0, t1) boundaries."""
    levels: Tuple[Tuple[int, float, float], ...]
    chunks: Tuple[Tuple[Tuple[float, float], ...], ...]
    k_max: int


def plan_carve(cfg: FusionConfig, intr: PinholeIntrinsics) -> CarvePlan:
    t, p = cfg.tsdf, cfg.pipeline
    T = p.carve_gamma * cfg.grid.voxel_size * min(intr.fx, intr.fy)
    max_carve = t.max_ray_length_m
    k = 1 << max(0, int(math.floor(math.log2(max(T / max_carve, 1.0)))))
    levels = []
    hi = max_carve
    while True:
        lo = T / (2.0 * k)
        last = (k >= p.carve_k_max) or (lo <= max(cfg.grid.voxel_size, 1e-3))
        if last:
            lo = 0.0
        levels.append((k, lo, hi))
        if last:
            break
        hi = lo
        k *= 2
    chunk_len = max((p.carve_steps - 3) * cfg.grid.voxel_size / 1.7321,
                    cfg.grid.voxel_size)
    chunks = []
    for (k, lo, hi) in levels:
        n = max(1, int(math.ceil((hi - lo) / chunk_len)))
        edges = [lo + (hi - lo) * i / n for i in range(n + 1)]
        chunks.append(tuple((edges[i], edges[i + 1]) for i in range(n)))
    return CarvePlan(levels=tuple(levels), chunks=tuple(chunks),
                     k_max=max(k for k, _, _ in levels))


@dataclasses.dataclass(frozen=True)
class CarveTable:
    """A plan as the carve kernels read it (csrc/carve.cu), for an H x W
    image padded to (Hp, Wp), multiples of k_max. Levels k <= 32 have
    (Hp/k, Wp/k) planes of minimum reach and centre label at
    planes[log2 k] (-1 where k is no level); past k = 32 the kernels read
    the 32 x 32 minima at base_off. `chunks` holds one int32 row a chunk
    in slot order: its first slot, k, the level's Hk and Wk, the plane
    offset (-1 past 32), and the float32 bits of t0, t1 and the valid
    threshold t0 + 1e-6 (the comparison torch makes in float32)."""
    Hp: int
    Wp: int
    total: int
    planes: Tuple[int, ...]
    base_off: int
    cells: int
    chunks: np.ndarray


def carve_table(plan: CarvePlan, H: int, W: int) -> CarveTable:
    """The static table of `plan` at an H x W image: one row a chunk, the
    slot offsets of carve_jobs's union, which has `total` slots."""
    km = plan.k_max
    Hp = ((H + km - 1) // km) * km
    Wp = ((W + km - 1) // km) * km
    planes = [-1] * 6
    cells = 0
    for (k, _, _) in plan.levels:
        if k <= 32:
            planes[k.bit_length() - 1] = cells
            cells += (Hp // k) * (Wp // k)
    base_off = -1
    if km > 32:
        base_off = cells
        cells += (Hp // 32) * (Wp // 32)
    rows, slot = [], 0
    for (k, _, _), lchunks in zip(plan.levels, plan.chunks):
        hk, wk = Hp // k, Wp // k
        off = planes[k.bit_length() - 1] if k <= 32 else -1
        for (t0, t1c) in lchunks:
            bounds = np.array([f32(t0), f32(t1c), f32(t0) + f32(1e-6)],
                              dtype=np.float32)
            rows.append([slot, k, hk, wk, off,
                         *bounds.view(np.int32).tolist()])
            slot += hk * wk
    return CarveTable(Hp=Hp, Wp=Wp, total=slot, planes=tuple(planes),
                      base_off=base_off, cells=cells,
                      chunks=np.array(rows, dtype=np.int32).reshape(-1, 8))


def decimated_jobs(depth: torch.Tensor, labels_img: torch.Tensor,
                   T_G_C: torch.Tensor, intr: PinholeIntrinsics,
                   cfg: FusionConfig):
    """The frame's decimated carve jobs compacted to the carve budget,
    (jobs, n_dropped): ops/kernels.py carve_jobs_compact, whose plain
    version on the CPU is carve_jobs then compact_jobs."""
    from . import kernels   # kernels imports this module
    return kernels.carve_jobs_compact(depth, labels_img, T_G_C, intr, cfg,
                                      plan_carve(cfg, intr),
                                      cfg.pipeline.carve_budget)


def _min_pool2(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape
    return x.reshape(h // 2, 2, w // 2, 2).amin(dim=(1, 3))


def _ray_norm(x, y):
    """sqrt(x*x + y*y + 1) as the reference computes it."""
    return torch.sqrt(fma(y, y, x * x) + 1.0)


def carve_jobs(depth: torch.Tensor, labels_img: torch.Tensor,
               T_G_C: torch.Tensor, intr: PinholeIntrinsics,
               cfg: FusionConfig, plan: CarvePlan) -> JobBatch:
    """The decimated carve jobs of one frame, sized to the union of all
    level/chunk slots (callers compact them to the carve budget). A job
    carves to clip(min reach over its pixel group - trunc, 0, max_ray);
    invalid and dynamic-label pixels carve nothing."""
    t = cfg.tsdf
    dev = depth.device
    H, W = depth.shape
    km = plan.k_max
    Hp = ((H + km - 1) // km) * km
    Wp = ((W + km - 1) // km) * km
    ifx, ify = recip(intr.fx), recip(intr.fy)

    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    nrm = _ray_norm((u - intr.cx) * ifx, (v - intr.cy) * ify)
    z = depth.float()
    dist = z * nrm
    ok = torch.isfinite(z) & (z > 0.0) & (dist >= t.min_ray_length_m)
    ok = ok & sem_ops.dynamic_label_mask(labels_img, cfg.semantic)
    if not t.allow_clear:
        ok = ok & (dist <= t.max_ray_length_m)
    INF = f32(3.0e38)
    reach = torch.clamp(torch.where(ok, dist, float("inf")), max=INF)
    pad = (0, Wp - W, 0, Hp - H)
    reach = torch.nn.functional.pad(reach, pad, value=INF)
    lab_p = torch.nn.functional.pad(labels_img.to(torch.int32), pad)
    ok_p = torch.nn.functional.pad(ok, pad)

    R = T_G_C[:3, :3]
    origin = T_G_C[:3, 3]
    pyr = {1: reach}
    k = 2
    while k <= km:
        pyr[k] = _min_pool2(pyr[k // 2])
        k *= 2

    outs = {f: [] for f in JOB_FIELDS}
    for (lk, lo, hi), lchunks in zip(plan.levels, plan.chunks):
        m = pyr[lk].reshape(-1)
        off = lk // 2
        lab_r = lab_p[off::lk, off::lk].reshape(-1)
        ok_r = ok_p[off::lk, off::lk].reshape(-1)
        Hk, Wk = pyr[lk].shape
        ur = (torch.arange(Wk, dtype=torch.float32, device=dev) * lk
              + off)[None, :]
        vr = (torch.arange(Hk, dtype=torch.float32, device=dev) * lk
              + off)[:, None]
        xr = ((ur - intr.cx) * ifx).expand(Hk, Wk).reshape(-1)
        yr = ((vr - intr.cy) * ify).expand(Hk, Wk).reshape(-1)
        nr = _ray_norm(xr, yr)
        dx, dy, dz = xr / nr, yr / nr, 1.0 / nr
        unit = torch.stack([fma(dz, R[a, 2], fma(dy, R[a, 1], dx * R[a, 0]))
                            for a in range(3)], dim=-1)
        m_fin = torch.isfinite(m) & (m < INF)
        m_safe = torch.clamp(m, max=f32(2.0 * t.max_ray_length_m + 1.0))
        m_star = torch.clamp(m_safe - f32(t.truncation_distance), 0.0,
                             f32(t.max_ray_length_m))
        if t.use_const_weight:
            wgt = torch.ones_like(m_safe)
        else:
            zz = torch.clamp(m_safe / nr, min=1e-6)
            wgt = 1.0 / (zz * zz)
        lab_j = torch.where(ok_r, lab_r, 0)
        point = fma(unit, m_safe[:, None], origin[None, :])
        for (t0, t1c) in lchunks:
            t1 = torch.clamp(m_star, max=f32(t1c))
            outs["origin"].append(origin.expand(unit.shape))
            outs["point"].append(point)
            outs["start"].append(fma(unit, f32(t0), origin[None, :]))
            outs["end"].append(fma(unit, t1[:, None], origin[None, :]))
            outs["weight"].append(wgt)
            outs["label"].append(lab_j)
            outs["color"].append(torch.zeros_like(unit))
            outs["valid"].append(m_fin & (t1 > f32(t0) + f32(1e-6)))
    return JobBatch(**{f: torch.cat(vs, dim=0) for f, vs in outs.items()})


def band_octave_keep(pts_C: torch.Tensor, valid: torch.Tensor,
                     cfg: FusionConfig, intr: PinholeIntrinsics, salt=None):
    """Deterministic octave replacement for the start-voxel dedup: each
    pixel belongs to the mip level matched to its surface distance d
    (k(d) = T/d, T = voxel * f / subsampling_factor), and the level's centre
    pixel of each k x k group wins. With band_density "matched" each
    group's candidate is further kept with probability 1/r^2, r = T/(d k),
    by a per-group hash mixed with `salt` (an int32 scalar tensor or int).

    floor(log2(T/d)) is computed as log(x) * float32(1/log 2), the
    reference's compiled form; near an octave boundary a one-ulp difference
    between two `log` implementations may still move a pixel to the next
    level (tests/test_torch_carve.py counts them)."""
    H, W = intr.height, intr.width
    t = cfg.tsdf
    dev = pts_C.device
    T = (cfg.grid.voxel_size * min(intr.fx, intr.fy)
         / max(t.start_voxel_subsampling_factor, 1e-6))
    d = norm3(pts_C[:, 0], pts_C[:, 1], pts_C[:, 2])
    kexact = f32(T) / torch.clamp(d, min=1e-3)
    kl = torch.floor(torch.log(kexact) * recip(np.log(np.float32(2.0))))
    kl = torch.clamp(kl, 0.0, float(int(math.log2(cfg.pipeline.carve_k_max)))
                     ).to(torch.int32)
    k = torch.ones_like(kl) << kl
    u = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(
        H, W).reshape(-1)
    v = torch.arange(H, dtype=torch.int32, device=dev)[:, None].expand(
        H, W).reshape(-1)
    half = k >> 1
    km1 = k - 1
    keep = ((u & km1) == half) & ((v & km1) == half)
    if t.band_density == "matched":
        if salt is None:
            salt = 0
        q = kexact / k.float()
        r2 = torch.clamp(q * q, min=1.0)
        gu = u >> kl
        gv = v >> kl
        h = (mul_i32(gu, -1640531527) ^ mul_i32(gv, -2048144789)
             ^ mul_i32(kl, 0x27D4EB2F) ^ salt)
        h = h ^ (h >> 15)
        h = mul_i32(h, 0x2C1B3C6D)
        h = h ^ (h >> 12)
        u16 = (h & 0xFFFF).float()
        keep = keep & (u16 * r2 < 65536.0)
    return valid & keep


def compact_jobs(jobs: JobBatch, budget: int):
    """Pack the valid jobs into a static budget: (jobs, n_dropped)."""
    kept, order = stable_compact_order(jobs.valid, budget)
    n_valid = jobs.valid.sum(dtype=torch.int32)
    dropped = torch.clamp(n_valid - budget, min=0)
    out = jobs.take(order)
    return dataclasses.replace(out, valid=kept), dropped
