"""A second witness of the reference's walk: the voxels a segment passes
through, found in float64 from where it crosses the grid's planes.

The reference (kbench/reference.py) walks a job's segment with a frozen
copy of the port's Amanatides-Woo walk in float32, with the port's
rounding, and takes each step's weight, weighted distance and colour gate
from the same frozen code. This module states the same thing another way,
to catch a fault that the port's plain code had when it was copied: each
axis's plane crossings t = (k - p0) / d in float64, merged in order, give
the voxel sequence from the start's voxel; the first S of it are the
walk's steps. Each step's signed distance is the surface point's distance
along the ray less the voxel centre's projection on it, and its weight the
job's, dropped off linearly behind the surface (Voxblox's semantics).

The two agree on every job whose outcome float32 rounding cannot flip. A
job is in doubt where its start or end lies within TAU (voxel units) of a
face, or where two of its plane crossings lie within TAU of each other
along the ray (which voxel comes first is then rounding's choice); a step
is in doubt for the colour gate where |sdf| lies within 1e-5 m of the
truncation distance. Jobs in doubt are counted and left out.
"""

from __future__ import annotations

import numpy as np
import torch

TAU = 1e-4           # voxel units: 5e-6 m at 0.05 m voxels
GATE_EPS_M = 1e-5


def exact_walk(start, end, S: int, voxel_size: float):
    """start, end (R, 3) float64 metres. Returns the voxel sequence
    (R, S, 3) int64, the steps the walk takes (R,), each at most S, and
    the jobs in doubt (R,) bool."""
    p0, p1 = start / voxel_size, end / voxel_size
    v0, v1 = torch.floor(p0), torch.floor(p1)
    n_a = (v1 - v0).abs()                                   # (R, 3)
    n = n_a.sum(dim=1).long()
    d = p1 - p0
    sgn = torch.sign(d)
    ks = torch.arange(1, S + 1, dtype=torch.float64, device=start.device)
    # The k-th crossing of an axis leaves voxel v0 + (k - 1) s through the
    # plane v0 + k (s > 0) or v0 - k + 1 (s < 0).
    plane = torch.where(sgn[..., None] > 0, v0[..., None] + ks,
                        v0[..., None] - ks + 1.0)           # (R, 3, S)
    safe = torch.where(d == 0, torch.ones_like(d), d)
    t = (plane - p0[..., None]) / safe[..., None]
    t = torch.where(ks <= n_a[..., None], t, torch.inf)
    R = start.shape[0]
    t, order = torch.sort(t.reshape(R, 3 * S), dim=1)
    axis = order[:, :S] // S                                # (R, S)
    step = torch.zeros((R, S, 3), dtype=torch.int64, device=start.device)
    step.scatter_(2, axis[..., None],
                  sgn.long().gather(1, axis)[..., None])
    vox = v0.long()[:, None, :] + torch.cumsum(step, dim=1) - step
    # Voxel i is v0 plus the first i crossings' steps.
    count = torch.clamp(n + 1, max=S)
    length = torch.linalg.vector_norm(d, dim=1)
    near_face = ((p0 - torch.round(p0)).abs() < TAU).any(dim=1) | \
        ((p1 - torch.round(p1)).abs() < TAU).any(dim=1)
    gaps = (t[:, 1:S] - t[:, :S - 1]) * length[:, None]
    used = torch.arange(1, S, device=start.device)[None, :] < \
        torch.clamp(n, max=S)[:, None]
    tied = ((gaps < TAU) & used).any(dim=1)
    return vox, count, near_face | tied


def exact_updates(jobs: dict, vox, voxel_size: float, trunc: float,
                  dropoff: bool):
    """Each step's weight, weighted clamped distance and colour-gated
    weight (R, S) in float64, and the steps in doubt for the gate."""
    o = jobs["origin"].double()
    q = jobs["point"].double()
    vec = q - o
    dist = torch.linalg.vector_norm(vec, dim=1)
    centre = (vox.double() + 0.5) * voxel_size
    proj = ((centre - o[:, None, :]) * vec[:, None, :]).sum(dim=2) \
        / dist[:, None]
    sdf = dist[:, None] - proj
    wj = jobs["weight"].double()[:, None]
    if dropoff:
        w = torch.where(sdf < -voxel_size,
                        torch.clamp(wj * (trunc + sdf) / (trunc - voxel_size),
                                    min=0.0), wj.expand_as(sdf))
    else:
        w = wj.expand_as(sdf)
    wsdf = w * torch.clamp(sdf, -trunc, trunc)
    gate = torch.where(sdf.abs() < trunc, w, torch.zeros_like(w))
    gate_doubt = (sdf.abs() - trunc).abs() < GATE_EPS_M
    return w, wsdf, gate, gate_doubt


def compare(jobs: dict, walked, S: int, fu: dict, chunk: int = 1 << 17):
    """The reference's walk of `jobs` (`walked`: reference.walk's voxels,
    job indices, w, w*sdf, gate) against the exact walk. Returns counts:
    jobs, jobs in doubt, jobs whose step count or voxels differ, and the
    largest gaps of w and w*sdf (over the job's weight, and its weight
    times the truncation distance) and of the gate, over the steps not in
    doubt."""
    vs = float(fu["voxel_size"])
    trunc = float(np.float32(fu["truncation_distance"]))
    v_ref, j_ref, w_ref, ws_ref, g_ref = walked
    R = jobs["point"].shape[0]
    dev = jobs["point"].device
    valid = jobs["valid"]
    order = torch.argsort(j_ref, stable=True)
    j_sorted = j_ref[order]
    cnt_ref = torch.bincount(j_ref, minlength=R)
    first = torch.cumsum(cnt_ref, 0) - cnt_ref
    pos = torch.arange(j_sorted.numel(), device=dev) - first[j_sorted]
    out = dict(jobs=int(valid.sum()), doubt=0, count_differs=0,
               voxel_differs=0, w=0.0, wsdf=0.0, gate=0.0)
    for a in range(0, R, chunk):
        b = min(R, a + chunk)
        sl = slice(a, b)
        vox, count, doubt = exact_walk(jobs["start"][sl].double(),
                                       jobs["end"][sl].double(), S, vs)
        count = torch.where(valid[sl], count, 0)
        doubt = doubt & valid[sl]
        sel = (j_sorted >= a) & (j_sorted < b)
        jj, pp = j_sorted[sel] - a, pos[sel]
        ref_vox = torch.full((b - a, S, 3), -(1 << 40), dtype=torch.int64,
                             device=dev)
        ref_vox[jj, pp] = v_ref[order[sel]]
        vals = torch.full((3, b - a, S), torch.nan, dtype=torch.float64,
                          device=dev)
        for i, x in enumerate((w_ref, ws_ref, g_ref)):
            vals[i][jj, pp] = x[order[sel]].double()
        steps = torch.arange(S, device=dev)[None, :] < count[:, None]
        count_ok = cnt_ref[sl] == count
        vox_ok = ((ref_vox == vox).all(dim=2) | ~steps).all(dim=1)
        judged = valid[sl] & ~doubt
        out["doubt"] += int(doubt.sum())
        out["count_differs"] += int((judged & ~count_ok).sum())
        out["voxel_differs"] += int((judged & count_ok & ~vox_ok).sum())
        w, wsdf, gate, gate_doubt = exact_updates(
            {k: jobs[k][sl] for k in ("origin", "point", "weight")}, vox,
            vs, trunc, fu["use_weight_dropoff"])
        ok = steps & (judged & count_ok & vox_ok)[:, None]
        wj = jobs["weight"][sl].double()[:, None].clamp(min=1e-30)
        for key, i, ref_x, norm, m in (
                ("w", 0, w, wj, ok), ("wsdf", 1, wsdf, wj * trunc, ok),
                ("gate", 2, gate, wj, ok & ~gate_doubt)):
            if bool(m.any()):
                gap = ((vals[i] - ref_x).abs() / norm)[m].max()
                out[key] = max(out[key], float(gap))
    return out


def frame_report(frame: dict, conf: dict, device) -> dict:
    """The exact walk against the reference's over every band ray and
    carve job of one frame (host arrays as delivered), by stream."""
    from . import reference as ref
    fu, bu, cam = conf["fusion"], conf["budgets"], conf["camera"]
    depth = torch.as_tensor(frame["depth"], device=device)
    labels_img = torch.as_tensor(frame["labels"], device=device)
    colors = torch.as_tensor(frame["colors"], device=device).float()
    T = torch.as_tensor(frame["T_G_C"], device=device)
    (pts_C, pts_G, origin, cols, labels, weights, valid,
     is_clearing) = ref.prepare_points(depth, labels_img, colors, T, cam, fu)
    keep = ref.band_octave_keep(pts_C, valid & ~is_clearing, fu, bu, cam)
    allj = ref.band_jobs(origin[None, :], pts_G, weights, labels, cols,
                         is_clearing, keep, fu)
    band, _ = ref.first_n(allj, keep, bu["max_rays"])
    cj = ref.carve_jobs(depth, labels_img, T, cam, fu,
                        ref.plan_carve(fu, bu, cam))
    carve, _ = ref.first_n(cj, cj["valid"], bu["carve_budget"])
    out = {}
    for name, jobs, S in (("band", band, ref.band_steps(fu, bu)),
                          ("carve", carve, bu["carve_steps"])):
        walked = ref.walk(jobs, S, fu, fu["storage_voxels_per_side"])
        v, j, w, ws, g = walked
        out[name] = compare(jobs, (v, j, w, ws, g), S, fu)
    return out
