"""The plain reference of the fast integrator's frame, for the output check.

It imports nothing of the port. What it has to agree with the port on bit
for bit, it takes from a frozen copy of the port's plain code: which
pixels cast band rays (the octave keep), the decimated carve jobs, and the
Amanatides-Woo walk with its per-step weight and signed distance, with the
port's rounding (a product added to something is one fused multiply-add,
division by a constant a multiply by its float32 reciprocal). The rest is
straightforward: every valid (step, job) pair adds its weight, its
weighted distance, its colour and one label vote to its voxel, by global
voxel coordinate, in float64 and integer accumulators over a dense box
around the scene. No hash table, camera cube, sort, segmented scan,
staging or kernel takes part.

A frame's updates depend on the frame alone: the port's TSDF and vote
channels are sums, the octave keep takes no frame counter, and the
decimated carve keeps no state. So a run that integrates trajectory frame
f c_f times ends with sum_f c_f * contribution(f), and the reference
computes each of the F frames once.
"""

from __future__ import annotations

import math
import types

import numpy as np
import torch

GRID_EPS = 1e-6


# -- rounding (frozen copy of the port's core/fp.py) ----------------------

def recip(c: float) -> float:
    return float(np.float32(1.0) / np.float32(c))


def f32(c: float) -> float:
    return float(np.float32(c))


def fma(a, b, c):
    """float32 a*b + c rounded once (exact float64 product, then float32)."""
    def d(x):
        return x.double() if torch.is_tensor(x) else float(x)
    return (d(a) * d(b) + d(c)).float()


def norm3(x, y, z):
    return torch.sqrt(fma(z, z, fma(y, y, x * x)))


# -- a frame's points (frozen copy of camera, transforms, tsdf, semantic) --

def backproject(depth, cam):
    h, w = depth.shape
    z = depth.float()
    dev = z.device
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    x = (u - cam["cx"]) * z * recip(cam["fx"])
    y = (v - cam["cy"]) * z * recip(cam["fy"])
    pts = torch.stack([x, y, z.expand(h, w)], dim=-1).reshape(-1, 3)
    valid = (torch.isfinite(z) & (z > 0.0)).reshape(-1)
    pts = torch.where(valid[:, None], pts, torch.zeros((), device=dev))
    return pts, valid


def apply_T(T, pts):
    x, y, z = pts[..., 0:1], pts[..., 1:2], pts[..., 2:3]
    return fma(z, T[:3, 2], fma(y, T[:3, 1], x * T[:3, 0])) + T[:3, 3]


def dynamic_ok(labels, fu):
    ok = torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
    for dyn in fu["dynamic_labels"]:
        ok = ok & (labels != dyn)
    return ok


def prepare_points(depth, labels, colors, T, cam, fu):
    pts_C, px_valid = backproject(depth, cam)
    norm = norm3(pts_C[:, 0], pts_C[:, 1], pts_C[:, 2])
    finite = torch.isfinite(pts_C).all(dim=-1)
    beyond = norm > fu["max_ray_length_m"]
    is_clearing = beyond & fu["allow_clear"]
    valid = finite & ~(norm < fu["min_ray_length_m"]) & (
        ~beyond | fu["allow_clear"])
    labels = labels.reshape(-1)
    valid = valid & px_valid & dynamic_ok(labels, fu)
    if fu["use_const_weight"]:
        weights = torch.ones(norm.shape, dtype=torch.float32,
                             device=depth.device)
    else:
        z = pts_C[:, 2].abs()
        weights = torch.where(z > 1e-6, 1.0 / torch.clamp(z * z, min=1e-12),
                              0.0)
    return (pts_C, apply_T(T, pts_C), T[:3, 3], colors.reshape(-1, 3),
            labels, weights, valid, is_clearing)


def band_octave_keep(pts_C, valid, fu, bu, cam):
    """The port's octave keep (band density "octave"): each pixel's mip
    level k = floor-pow2(T / d), the level's centre pixel of each k x k
    group casts the band ray."""
    H, W = cam["height"], cam["width"]
    dev = pts_C.device
    T = (fu["voxel_size"] * min(cam["fx"], cam["fy"])
         / max(fu["start_voxel_subsampling_factor"], 1e-6))
    d = norm3(pts_C[:, 0], pts_C[:, 1], pts_C[:, 2])
    kexact = f32(T) / torch.clamp(d, min=1e-3)
    kl = torch.floor(torch.log(kexact) * recip(np.log(np.float32(2.0))))
    kl = torch.clamp(kl, 0.0, float(int(math.log2(bu["carve_k_max"])))
                     ).to(torch.int32)
    k = torch.ones_like(kl) << kl
    u = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(
        H, W).reshape(-1)
    v = torch.arange(H, dtype=torch.int32, device=dev)[:, None].expand(
        H, W).reshape(-1)
    half, km1 = k >> 1, k - 1
    keep = ((u & km1) == half) & ((v & km1) == half)
    return valid & keep


def band_jobs(origin, pts_G, weights, labels, colors, is_clearing, valid,
              fu):
    trunc = f32(fu["truncation_distance"])
    origin = origin.expand(pts_G.shape)
    vec = pts_G - origin
    norm = norm3(vec[:, 0], vec[:, 1], vec[:, 2])[:, None]
    unit = vec / torch.clamp(norm, min=1e-12)
    band = torch.clamp(norm, max=trunc)
    return dict(origin=origin, point=pts_G, start=fma(-unit, band, pts_G),
                end=fma(unit, trunc, pts_G), weight=weights, label=labels,
                color=colors, valid=valid & ~is_clearing)


def plan_carve(fu, bu, cam):
    T = bu["carve_gamma"] * fu["voxel_size"] * min(cam["fx"], cam["fy"])
    max_carve = fu["max_ray_length_m"]
    k = 1 << max(0, int(math.floor(math.log2(max(T / max_carve, 1.0)))))
    levels, hi = [], max_carve
    while True:
        lo = T / (2.0 * k)
        last = (k >= bu["carve_k_max"]) or (lo <= max(fu["voxel_size"], 1e-3))
        if last:
            lo = 0.0
        levels.append((k, lo, hi))
        if last:
            break
        hi = lo
        k *= 2
    chunk_len = max((bu["carve_steps"] - 3) * fu["voxel_size"] / 1.7321,
                    fu["voxel_size"])
    chunks = []
    for (k, lo, hi) in levels:
        n = max(1, int(math.ceil((hi - lo) / chunk_len)))
        edges = [lo + (hi - lo) * i / n for i in range(n + 1)]
        chunks.append(tuple((edges[i], edges[i + 1]) for i in range(n)))
    return levels, chunks, max(k for k, _, _ in levels)


def _min_pool2(x):
    h, w = x.shape
    return x.reshape(h // 2, 2, w // 2, 2).amin(dim=(1, 3))


def _ray_norm(x, y):
    return torch.sqrt(fma(y, y, x * x) + 1.0)


def carve_jobs(depth, labels_img, T, cam, fu, plan):
    """The decimated carve jobs of one frame, in the port's slot order."""
    levels, chunks, km = plan
    dev = depth.device
    H, W = depth.shape
    Hp, Wp = ((H + km - 1) // km) * km, ((W + km - 1) // km) * km
    ifx, ify = recip(cam["fx"]), recip(cam["fy"])
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    nrm = _ray_norm((u - cam["cx"]) * ifx, (v - cam["cy"]) * ify)
    z = depth.float()
    dist = z * nrm
    ok = torch.isfinite(z) & (z > 0.0) & (dist >= fu["min_ray_length_m"])
    ok = ok & dynamic_ok(labels_img, fu)
    if not fu["allow_clear"]:
        ok = ok & (dist <= fu["max_ray_length_m"])
    INF = f32(3.0e38)
    reach = torch.clamp(torch.where(ok, dist, float("inf")), max=INF)
    pad = (0, Wp - W, 0, Hp - H)
    reach = torch.nn.functional.pad(reach, pad, value=INF)
    lab_p = torch.nn.functional.pad(labels_img.to(torch.int32), pad)
    ok_p = torch.nn.functional.pad(ok, pad)
    R = T[:3, :3]
    origin = T[:3, 3]
    pyr = {1: reach}
    k = 2
    while k <= km:
        pyr[k] = _min_pool2(pyr[k // 2])
        k *= 2
    fields = ("origin", "point", "start", "end", "weight", "label", "color",
              "valid")
    outs = {f: [] for f in fields}
    trunc, mx = fu["truncation_distance"], fu["max_ray_length_m"]
    for (lk, lo, hi), lchunks in zip(levels, chunks):
        m = pyr[lk].reshape(-1)
        off = lk // 2
        lab_r = lab_p[off::lk, off::lk].reshape(-1)
        ok_r = ok_p[off::lk, off::lk].reshape(-1)
        Hk, Wk = pyr[lk].shape
        ur = (torch.arange(Wk, dtype=torch.float32, device=dev) * lk
              + off)[None, :]
        vr = (torch.arange(Hk, dtype=torch.float32, device=dev) * lk
              + off)[:, None]
        xr = ((ur - cam["cx"]) * ifx).expand(Hk, Wk).reshape(-1)
        yr = ((vr - cam["cy"]) * ify).expand(Hk, Wk).reshape(-1)
        nr = _ray_norm(xr, yr)
        dx, dy, dz = xr / nr, yr / nr, 1.0 / nr
        unit = torch.stack([fma(dz, R[a, 2], fma(dy, R[a, 1], dx * R[a, 0]))
                            for a in range(3)], dim=-1)
        m_fin = torch.isfinite(m) & (m < INF)
        m_safe = torch.clamp(m, max=f32(2.0 * mx + 1.0))
        m_star = torch.clamp(m_safe - f32(trunc), 0.0, f32(mx))
        if fu["use_const_weight"]:
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
    return {f: torch.cat(vs, dim=0) for f, vs in outs.items()}


def first_n(jobs: dict, mask, n: int):
    """The first n jobs where `mask` holds, in order (the port's stable
    compaction to a budget), and how many were left out."""
    idx = torch.nonzero(mask).reshape(-1)
    kept = idx[:n]
    return ({f: v[kept] for f, v in jobs.items()},
            max(0, int(idx.numel()) - n))


# -- the walk (frozen copy of ops/raycast.py and K1's plain version) -------

def dda_init(start3, end3, inv):
    end_w = end3
    start3, end3 = start3 * inv, end3 * inv
    curr = torch.floor(start3 + GRID_EPS).to(torch.int32)
    end_i = torch.floor(end3 + GRID_EPS).to(torch.int32)
    n_steps = (end_i - curr).abs().sum(dim=0)
    ray = fma(end_w, inv, -start3)
    sign = torch.sign(ray).to(torch.int32)
    corrected = torch.clamp(sign, min=0).float()
    zero = ray == 0.0
    safe_ray = torch.where(zero, torch.ones_like(ray), ray)
    t_next = torch.where(zero, torch.full_like(ray, float("inf")),
                         (corrected - (start3 - curr.float())) / safe_ray)
    t_step = torch.where(zero, torch.zeros_like(ray), sign.float() / safe_ray)
    return curr, n_steps, sign, t_next, t_step


def dda_advance(curr, t_next, sign, t_step):
    min01 = torch.minimum(t_next[0], t_next[1])
    a = torch.where(t_next[1] < t_next[0], 1, 0)
    axis = torch.where(t_next[2] < min01, 2, a)
    onehot = torch.arange(3, device=axis.device)[:, None] == axis[None, :]
    curr = curr + torch.where(onehot, sign, torch.zeros_like(sign))
    t_next = t_next + torch.where(onehot, t_step, torch.zeros_like(t_step))
    return curr, t_next


def walk(jobs: dict, S: int, fu, storage_vps: int):
    """Every valid (step, job) pair of the jobs: (voxel (N, 3) int64, job
    index (N,), w (N,), w * clamped sdf (N,), colour gate w (N,))."""
    vs = np.float32(fu["voxel_size"])
    inv = f32(1.0 / fu["voxel_size"])
    trunc = f32(fu["truncation_distance"])
    scale = float(np.float32(1.0) / np.maximum(
        np.float32(fu["truncation_distance"]) - vs, np.float32(1e-12)))
    ext = fu["world_extent_blocks"]
    origin, point = jobs["origin"], jobs["point"]
    R = point.shape[0]
    dev = point.device
    curr, n_steps, sign, t_next, t_step = dda_init(
        jobs["start"].T.contiguous(), jobs["end"].T.contiguous(), inv)
    vec = point - origin
    dist = norm3(vec[:, 0], vec[:, 1], vec[:, 2])
    cols = torch.arange(R, device=dev)
    out = [[] for _ in range(5)]
    for s in range(S):
        b = torch.div(curr, storage_vps, rounding_mode="floor")
        in_b = ((b >= -ext) & (b < ext)).all(dim=0)
        valid = (s <= n_steps) & jobs["valid"] & in_b
        A = [fma(curr[a].float() + 0.5, float(vs), -origin[:, a])
             for a in range(3)]
        num = fma(A[2], vec[:, 2], fma(A[0], vec[:, 0], A[1] * vec[:, 1]))
        sdf = dist - num / torch.clamp(dist, min=1e-12)
        wj = jobs["weight"]
        if fu["use_weight_dropoff"]:
            w = torch.where(sdf < -float(vs),
                            torch.clamp(wj * ((trunc + sdf) * scale),
                                        min=0.0), wj)
        else:
            w = wj
        sel = torch.nonzero(valid).reshape(-1)
        out[0].append(curr[:, sel].T.to(torch.int64))
        out[1].append(cols[sel])
        out[2].append(w[sel])
        out[3].append((w * torch.clamp(sdf, -trunc, trunc))[sel])
        out[4].append(torch.where(sdf.abs() < trunc, w, 0.0)[sel])
        curr, t_next = dda_advance(curr, t_next, sign, t_step)
    return tuple(torch.cat(o) for o in out)


def band_steps(fu, bu) -> int:
    if bu.get("band_steps") is not None:
        return bu["band_steps"]
    return int(math.ceil(1.7321 * 2.0 * fu["truncation_distance"]
                         / fu["voxel_size"])) + 3


def carve_slots(fu, bu, cam) -> int:
    """The decimated carve jobs' slots, before compaction: each level's
    (Hp / k) x (Wp / k) centres, once a chunk (carve_jobs's union)."""
    levels, chunks, km = plan_carve(fu, bu, cam)
    Hp = ((cam["height"] + km - 1) // km) * km
    Wp = ((cam["width"] + km - 1) // km) * km
    return sum((Hp // k) * (Wp // k) * len(c)
               for (k, _, _), c in zip(levels, chunks))


def stream_length(conf: dict) -> int:
    """The update stream as the port sizes it at the configuration's
    budgets: each batch compacted to its budget (or to all its slots, if
    fewer), times its step budget."""
    fu, bu, cam = conf["fusion"], conf["budgets"], conf["camera"]
    return (band_steps(fu, bu) * min(cam["height"] * cam["width"],
                                     bu["max_rays"])
            + bu["carve_steps"] * min(carve_slots(fu, bu, cam),
                                      bu["carve_budget"]))


class Box:
    """A dense box of voxels: global voxel coordinate -> linear index."""

    def __init__(self, bounds, voxel_size, device):
        lo = np.floor(np.asarray(bounds[0]) / voxel_size).astype(np.int64)
        hi = np.floor(np.asarray(bounds[1]) / voxel_size).astype(np.int64)
        self.lo = torch.as_tensor(lo, device=device)
        self.shape = tuple(int(x) for x in (hi - lo + 1))
        self.n = int(np.prod(self.shape))

    def index(self, vox):
        """(linear index (N,), inside (N,) bool) of voxels (N, 3)."""
        rel = vox - self.lo
        shp = torch.as_tensor(self.shape, device=vox.device)
        inside = ((rel >= 0) & (rel < shp)).all(dim=1)
        rel = torch.where(inside[:, None], rel, 0)
        return (rel[:, 0] * self.shape[1] + rel[:, 1]) * self.shape[2] \
            + rel[:, 2], inside


def frame_update(frame: dict, conf: dict, box: Box, device):
    """The reference's update of one frame (host arrays in, as delivered
    to both sides): its unique voxels (box indices, ascending) with their
    float64 sums, its (voxel, label) votes, its blocks, and the counts the
    port's budgets bound."""
    fu, bu, cam = conf["fusion"], conf["budgets"], conf["camera"]
    if fu["method"] != "fast" or fu["carve_mode"] != "decimated" or \
            fu["band_density"] != "octave":
        raise ValueError("the reference covers the fast integrator with "
                         "carve_mode decimated and band density octave")
    svps = fu["storage_voxels_per_side"]
    L = fu["num_labels"]
    depth = torch.as_tensor(frame["depth"], device=device)
    labels_img = torch.as_tensor(frame["labels"], device=device)
    colors = torch.as_tensor(frame["colors"], device=device).float()
    T = torch.as_tensor(frame["T_G_C"], device=device)
    (pts_C, pts_G, origin, cols, labels, weights, valid,
     is_clearing) = prepare_points(depth, labels_img, colors, T, cam, fu)
    keep = band_octave_keep(pts_C, valid & ~is_clearing, fu, bu, cam)
    n_rays = int(keep.sum())
    allj = band_jobs(origin[None, :], pts_G, weights, labels, cols,
                     is_clearing, keep, fu)
    band, drop_band = first_n(allj, keep, bu["max_rays"])
    cj = carve_jobs(depth, labels_img, T, cam, fu, plan_carve(fu, bu, cam))
    n_carve = int(cj["valid"].sum())
    carve, drop_carve = first_n(cj, cj["valid"], bu["carve_budget"])
    streams = [(band, band_steps(fu, bu)), (carve, bu["carve_steps"])]
    n_stream = stream_length(conf)
    vox, wv, wsdf, wc, lab, colw = [], [], [], [], [], []
    for jobs, S in streams:
        v, j, w, ws, g = walk(jobs, S, fu, svps)
        vox.append(v)
        wv.append(w)
        wsdf.append(ws)
        wc.append(g)
        lab.append(jobs["label"][j].long())
        colw.append(g[:, None] * jobs["color"][j])
    vox, w, wsdf, wc = (torch.cat(x) for x in (vox, wv, wsdf, wc))
    lab, colw = torch.cat(lab), torch.cat(colw)
    idx, inside = box.index(vox)
    n_entries = int(vox.shape[0])
    uniq, inv = torch.unique(idx, return_inverse=True)
    # Votes: informative labels (not the unknown label 0), per (voxel,
    # label).
    inform = lab != 0
    # Rows: w, w * sdf, colour gate w, the three colour sums, the votes.
    sums = torch.zeros((7, uniq.numel()), dtype=torch.float64,
                       device=device)
    sums.index_add_(1, inv, torch.stack([w, wsdf, wc, *colw.T,
                                         inform.float()]).double())
    vkey = inv[inform] * L + lab[inform]
    vuniq, vcount = torch.unique(vkey, return_counts=True)
    # Distinct informative labels a voxel receives in this frame (the
    # port's packed staging holds sem_stage_ranks of them).
    per_vox = torch.bincount(vuniq // L, minlength=uniq.numel())
    blocks = torch.unique(torch.div(vox, svps, rounding_mode="floor"), dim=0)
    seg = torch.unique(idx * 32 + (lab & 31)).numel()
    return types.SimpleNamespace(
        idx=uniq, sums=sums, vote_voxel=uniq[vuniq // L], vote_label=vuniq % L,
        vote_count=vcount, blocks=blocks, outside=int((~inside).sum()),
        rays=n_rays, carve_jobs=n_carve, entries=n_entries, segments=seg,
        touched_blocks=int(blocks.shape[0]),
        dropped_rays=drop_band + drop_carve,
        segment_overflow=max(0, seg - bu["segment_budget"]) + max(
            0, n_entries - int(math.ceil(bu["stream_active_fraction"]
                                         * n_stream))),
        rank_overflow=int(torch.clamp(per_vox - bu["sem_stage_ranks"],
                                      min=0).sum()))


class Accumulated:
    """sum_f c_f * contribution(f) over a dense box, with its block set."""

    def __init__(self, box: Box, num_labels: int, device, color: bool):
        self.box, self.L = box, num_labels
        self.w = torch.zeros(box.n, dtype=torch.float64, device=device)
        self.wsdf = torch.zeros_like(self.w)
        self.wcolor = (torch.zeros((3, box.n), dtype=torch.float64,
                                   device=device) if color else None)
        self.votes = torch.zeros((num_labels, box.n), dtype=torch.int64,
                                 device=device)
        self.blocks = None

    def add(self, upd, count: int):
        if count == 0:
            return
        self.w.index_add_(0, upd.idx, upd.sums[0] * count)
        self.wsdf.index_add_(0, upd.idx, upd.sums[1] * count)
        if self.wcolor is not None:
            self.wcolor.index_add_(1, upd.idx, upd.sums[3:6] * count)
        self.votes.view(-1).index_put_(
            (upd.vote_label * self.box.n + upd.vote_voxel,),
            upd.vote_count * count, accumulate=True)
        self.blocks = (upd.blocks if self.blocks is None else torch.unique(
            torch.cat([self.blocks, upd.blocks]), dim=0))
