"""The plain reference of the merged integrator's frame, for the output check.

It covers Kimera-Semantics' `MergedSemanticTsdfIntegrator`
(kimera_semantics/src/semantic_tsdf_integrator_merged.cpp, "_merged.cpp"
below) as the port runs it in `models/merged.py integrate_frame` with
method "merged", carve_mode "full", voxel carving on and anti-grazing off
(voxblox's default), and raises ValueError for anything else. It imports
nothing of the port.

What it has to agree with the port on bit for bit, it takes from a frozen
copy of the port's plain code, because it decides the walk:
  - the point preparation (kbench/reference.py prepare_points);
  - each bundle's float32 point, weight and colour, summed in the port's
    order: the bin's points in pixel order, through the port's segmented
    Hillis-Steele scan (`segmented_scan_sums`, ops/reduce.py), then
    divided by the weight (models/merged.py _bundle_scan);
  - the ray extents (`setup_rays`, ops/raycast.py) and the walk with its
    per-step weight and signed distance (kbench/reference.py walk).
The destination voxel of a point is voxblox's getGridIndexFromPoint on
its float32 world point, floor(p * (1 / voxel) + 1e-6), the formula the
port evaluates (grid/blocks.py point_to_voxel).

The rest it computes its own, straightforward way, with no sort-and-scan,
staging or kernel:
  - bundleRays (_merged.cpp:110-124; models/merged.py _sort_by_voxel):
    the points binned by destination voxel, normal points in one map and
    clearing points (beyond max_ray_length_m) in another;
  - the contributing-weight gate: a point adds to its bundle where its
    weight exceeds voxblox's kEpsilon 1e-6 (_merged.cpp:254-285;
    `_EPS_WEIGHT`), and a bundle exists where its weight sum does;
  - the label histogram of a normal bundle: its contributing points'
    informative labels (not the unknown label 0) counted (_merged.cpp:
    254-285; models/merged.py _bundle_votes), and cast with their counts
    at every voxel its ray walks (:288-328);
  - a clearing bin's ray from its first point alone, the one of least
    pixel index (:282-284; models/merged.py _bundle's first_idx), which
    votes its own label as a fast ray does;
  - the two passes, normal bundles first, clearing bundles second
    (:126-146), each walking its whole extent (no early termination);
  - every sum over the walk, in float64 and integers over a dense box.

Departures of the port from upstream that the reference shares:
  - a bundle's point and colour are weighted sums over the weight sum in
    the world frame, not voxblox's running mean in the camera frame
    (rounding only);
  - the bins are kept in ascending (x, y, z) order of their voxel, and
    those past max_rays are dropped and counted, in each pass; of the
    normal bundles' (bundle, label) pairs, in (bundle, label) order, those
    past 2 max_rays are dropped and counted (upstream keeps every bin);
  - the weights are not capped at voxblox's max_weight (the grid holds
    sums; so does the fast reference);
  - each pass is one update of the grid: its segments, staging rows and
    label ranks are bounded by the port's budgets per pass.

A frame's update depends on the frame alone: with anti-grazing off the
merged integrator reads nothing of the grid, the channels are sums, and
bundling keeps no state. So kbench/reference.py Accumulated sums it as it
sums the fast integrator's.
"""

from __future__ import annotations

import math
import types

import torch

from kbench import reference as ref

_EPS_WEIGHT = 1e-6   # voxblox kEpsilon on point weights
_KEY_OFF = 1 << 20   # voxel coordinate offset of the linear keys


def _require(conf: dict):
    fu = conf["fusion"]
    if fu["method"] != "merged" or fu["carve_mode"] != "full" or \
            not fu["voxel_carving_enabled"] or \
            fu.get("enable_anti_grazing", False):
        raise ValueError("the merged reference covers method merged with "
                         "carve_mode full, carving on and anti-grazing off")


def full_steps(fu) -> int:
    """The walk's step budget (config.py resolved_max_steps, carving on):
    the Amanatides-Woo axis sum over the whole ray and its band."""
    reach = fu["max_ray_length_m"] + fu["truncation_distance"]
    return int(math.ceil(1.7321 * reach / fu["voxel_size"])) + 3


def stream_length(conf: dict) -> int:
    """The slots of the three update streams the port sizes a frame: the
    normal and the clearing pass max_rays jobs each, the votes of
    min(2 max_rays, pixels) (bundle, label) pairs, each S steps."""
    _require(conf)
    fu, bu, cam = conf["fusion"], conf["budgets"], conf["camera"]
    S, R = full_steps(fu), bu["max_rays"]
    return S * (2 * R + min(2 * R, cam["height"] * cam["width"]))


# -- frozen copies of the port's plain code -------------------------------

def segmented_scan_sums(is_start, channels):
    """Inclusive segmented prefix sums, Hillis-Steele with flags (frozen
    copy of ops/reduce.py segmented_scan_sums, no max_run)."""
    n = int(is_start.shape[0])
    s_list = list(channels)
    f = is_start
    d = 1
    while d < n:
        f_shift = torch.cat([torch.ones((d,), dtype=torch.bool,
                                        device=f.device), f[:-d]])
        for j, s in enumerate(s_list):
            s_shift = torch.cat([torch.zeros((d,), dtype=s.dtype,
                                             device=s.device), s[:-d]])
            s_list[j] = torch.where(f, s, s + s_shift)
        f = f | f_shift
        d *= 2
    return tuple(s_list)


def setup_rays(origin, points_G, is_clearing, fu):
    """World-unit start and end of each ray (frozen copy of
    ops/raycast.py setup_rays at voxel_size 1, carving on: every ray
    starts at the camera)."""
    origin = origin.expand(points_G.shape)
    vec = points_G - origin
    norm = ref.norm3(vec[:, 0], vec[:, 1], vec[:, 2])[:, None]
    unit = vec / torch.clamp(norm, min=1e-12)
    trunc = fu["truncation_distance"]
    clear_len = torch.clamp(norm - trunc, 0.0, fu["max_ray_length_m"])
    clear_end = ref.fma(unit, clear_len, origin)
    norm_end = ref.fma(unit, trunc, points_G)
    end = torch.where(is_clearing[:, None], clear_end, norm_end)
    return origin, end


def destination_voxels(pts_G, fu):
    """voxblox getGridIndexFromPoint of float32 world points."""
    return torch.floor(pts_G * (1.0 / fu["voxel_size"]) + 1e-6).to(
        torch.int64)


def bundle_sums(bin_of, weights, pts_G, colors):
    """Each bin's float32 weight, point and colour as the port sums them
    (models/merged.py _bundle_scan): the bin's points in pixel order, each
    weighted by its weight where that passes the gate (else 0), through
    the segmented scan, then over the weight. `bin_of` (N,) the bin of
    each point, -1 for none; bins 0..B-1. Returns (wsum, point, colour)
    by bin."""
    pts = torch.nonzero(bin_of >= 0).reshape(-1)
    pts = pts[torch.argsort(bin_of[pts], stable=True)]
    b = bin_of[pts]
    w = weights[pts]
    wc = torch.where(w > _EPS_WEIGHT, w, 0.0)
    pg, col = pts_G[pts], colors[pts]
    is_first = torch.ones_like(b, dtype=torch.bool)
    is_first[1:] = b[1:] != b[:-1]
    sums = segmented_scan_sums(
        is_first, (wc, wc * pg[:, 0], wc * pg[:, 1], wc * pg[:, 2],
                   wc * col[:, 0], wc * col[:, 1], wc * col[:, 2]))
    is_end = torch.ones_like(is_first)
    is_end[:-1] = is_first[1:]
    ends = torch.nonzero(is_end).reshape(-1)
    wsum = sums[0][ends]
    denom = torch.clamp(wsum[:, None], min=1e-12)
    point = torch.stack([s[ends] for s in sums[1:4]], dim=-1) / denom
    color = torch.stack([s[ends] for s in sums[4:7]], dim=-1) / denom
    return wsum, point, color


# -- the reference's own rules --------------------------------------------

def bins(vox, active):
    """bundleRays: each active point's bin, the rank of its destination
    voxel among the active points' voxels in ascending (x, y, z) order
    (-1 for other points), and the number of bins."""
    bin_of = torch.full((vox.shape[0],), -1, dtype=torch.int64,
                        device=vox.device)
    if not bool(active.any()):
        return bin_of, 0
    uniq, inv = torch.unique(vox[active], dim=0, return_inverse=True)
    bin_of[active] = inv
    return bin_of, int(uniq.shape[0])


def frame_passes(frame: dict, conf: dict, device):
    """The frame's bundles and the jobs of its two passes (host arrays in,
    as delivered to both sides). Returns a namespace: `normal` and
    `clearing`, each with its jobs (the walk's fields, kept bundles only),
    its bin count and each point's bin; the normal pass's kept (bundle,
    label, count) pairs and its bundles' float32 sums; the step budget S
    and the counts past the budgets."""
    _require(conf)
    fu, bu, cam = conf["fusion"], conf["budgets"], conf["camera"]
    R, L = bu["max_rays"], fu["num_labels"]
    depth = torch.as_tensor(frame["depth"], device=device)
    labels_img = torch.as_tensor(frame["labels"], device=device)
    colors = torch.as_tensor(frame["colors"], device=device).float()
    T = torch.as_tensor(frame["T_G_C"], device=device)
    (_, pts_G, origin, cols, labels, weights, valid,
     is_clearing) = ref.prepare_points(depth, labels_img, colors, T, cam, fu)
    vox = destination_voxels(pts_G, fu)
    contrib = weights > _EPS_WEIGHT
    labels = labels.long()

    # Pass 1: a bundle a bin of normal points, in bin order; those past
    # max_rays dropped.
    nbin, n_normal = bins(vox, valid & ~is_clearing)
    kept = (nbin >= 0) & (nbin < R)
    wsum, bpoint, bcolor = bundle_sums(torch.where(kept, nbin, -1),
                                       weights, pts_G, cols)
    K = wsum.shape[0]
    bvalid = wsum > _EPS_WEIGHT
    # Its histogram: the contributing points' informative labels.
    voter = kept & contrib & (labels != 0)
    voter[voter.clone()] = bvalid[nbin[voter]]     # of valid bundles only
    pkey, pcount = torch.unique(nbin[voter] * L + labels[voter],
                                return_counts=True)
    n_pairs = int(pkey.numel())
    pkey, pcount = pkey[:2 * R], pcount[:2 * R]
    sel = torch.nonzero(bvalid).reshape(-1)
    normal = _jobs(origin, bpoint[sel], wsum[sel], bcolor[sel],
                   torch.zeros_like(sel), torch.zeros_like(sel,
                                                           dtype=torch.bool),
                   fu)
    # The pairs' bundles as indices of the walked jobs.
    job_of = torch.full((K,), -1, dtype=torch.int64, device=device)
    job_of[sel] = torch.arange(sel.numel(), device=device)

    # Pass 2: a clearing bin's ray from its first point.
    cbin, n_clear = bins(vox, valid & is_clearing)
    ckept = (cbin >= 0) & (cbin < R)
    n_ck = min(n_clear, R)
    npix = vox.shape[0]
    first = torch.full((n_ck,), npix, dtype=torch.int64, device=device)
    pix = torch.arange(npix, device=device)
    first.scatter_reduce_(0, cbin[ckept], pix[ckept], reduce="amin")
    chas = torch.zeros(n_ck, dtype=torch.bool, device=device)
    chas[cbin[ckept & contrib]] = True
    cvalid = chas & contrib[first]
    f = first[cvalid]
    clearing = _jobs(origin, pts_G[f], weights[f], cols[f], labels[f],
                     torch.ones_like(f, dtype=torch.bool), fu)
    return types.SimpleNamespace(
        S=full_steps(fu), origin=origin, pts_G=pts_G, weights=weights,
        normal=normal, clearing=clearing,
        normal_bin=nbin, clearing_bin=cbin, n_normal=n_normal,
        n_clear=n_clear, bundle_point=bpoint,
        bundle_valid=bvalid, pair_job=job_of[pkey // L],
        pair_label=pkey % L, pair_count=pcount, n_pairs=n_pairs,
        dropped=max(0, n_normal - R) + max(0, n_pairs - 2 * R)
        + max(0, n_clear - R))


def _jobs(origin, point, weight, color, label, clearing, fu):
    start, end = setup_rays(origin[None, :], point, clearing, fu)
    return dict(origin=start, point=point, start=start, end=end,
                weight=weight, label=label, color=color,
                valid=torch.ones_like(clearing))


def _vkey(vox):
    """A linear int64 key of global voxel coordinates."""
    v = vox + _KEY_OFF
    return (v[:, 0] << 42) | (v[:, 1] << 21) | v[:, 2]


def _ranks_over(key_vox, key_lab, P: int) -> int:
    """Votes past P distinct labels a voxel: (voxel, label) rows given."""
    if key_vox.numel() == 0:
        return 0
    pairs = torch.unique(torch.stack([key_vox, key_lab], dim=1), dim=0)
    _, per_vox = torch.unique(pairs[:, 0], return_counts=True)
    return int(torch.clamp(per_vox - P, min=0).sum())


def frame_update(frame: dict, conf: dict, box: ref.Box, device):
    """The reference's update of one frame, in kbench/spec.py's contract:
    its unique voxels (box indices, ascending) with their float64 sums,
    its (voxel, label) votes, its blocks, and the counts the port's
    budgets bound. `rays` is the least max_rays at which it drops
    nothing: the larger pass's bins, or half its pairs."""
    fu, bu, cam = conf["fusion"], conf["budgets"], conf["camera"]
    svps, L = fu["storage_voxels_per_side"], fu["num_labels"]
    R, B = bu["max_rays"], bu["segment_budget"]
    frac = bu["stream_active_fraction"]
    fp = frame_passes(frame, conf, device)
    S = fp.S
    (v1, j1, w1, ws1, g1), (v2, j2, w2, ws2, g2) = (
        ref.walk(jobs, S, fu, svps) for jobs in (fp.normal, fp.clearing))

    # Pass 1's votes: each kept pair's count at every step of its bundle.
    order = torch.argsort(j1, stable=True)
    n_jobs = fp.normal["point"].shape[0]
    steps = torch.bincount(j1, minlength=n_jobs)
    start = torch.cumsum(steps, 0) - steps
    per_pair = steps[fp.pair_job]
    pair = torch.repeat_interleave(torch.arange(per_pair.numel(),
                                                device=device), per_pair)
    within = torch.arange(pair.numel(), device=device) - (
        torch.cumsum(per_pair, 0) - per_pair)[pair]
    ventry = order[start[fp.pair_job][pair] + within]
    vvox = v1[ventry]
    vlab = fp.pair_label[pair]
    vcnt = fp.pair_count[pair]
    # Pass 2's votes: a clearing ray's informative label, once a step.
    lab2 = fp.clearing["label"][j2]
    inf2 = lab2 != 0

    vox = torch.cat([v1, v2])
    colw = torch.cat([g1[:, None] * fp.normal["color"][j1],
                      g2[:, None] * fp.clearing["color"][j2]])
    idx, inside = box.index(vox)
    uniq, inv = torch.unique(idx, return_inverse=True)
    sums = torch.zeros((7, uniq.numel()), dtype=torch.float64,
                       device=device)
    sums[:6].index_add_(1, inv, torch.stack([
        torch.cat([w1, w2]), torch.cat([ws1, ws2]), torch.cat([g1, g2]),
        *colw.T]).double())
    # Votes by (voxel, label), in integers (their voxels are walked ones).
    vidx, _ = box.index(torch.cat([vvox, v2[inf2]]))
    vl = torch.cat([vlab, lab2[inf2]])
    vc = torch.cat([vcnt, torch.ones_like(lab2[inf2])])
    vkey, vinv = torch.unique(vidx * L + vl, return_inverse=True)
    vcount = torch.zeros(vkey.numel(), dtype=torch.int64, device=device)
    vcount.index_add_(0, vinv, vc)
    pos = torch.searchsorted(uniq, vkey // L)
    sums[6].index_add_(0, pos, vcount.double())

    blocks = torch.unique(torch.div(vox, svps, rounding_mode="floor"),
                          dim=0)
    # The three reduces: pass 1's steps (label 0), its votes, pass 2's
    # steps (their label in the key).
    k1 = _vkey(v1)
    kv = _vkey(vvox)
    k2 = _vkey(v2)
    reduces = (
        (int(k1.numel()), int(torch.unique(k1).numel()), S * R),
        (int(kv.numel()), int(torch.unique(kv * 32 + (vlab & 31)).numel()),
         S * min(2 * R, cam["height"] * cam["width"])),
        (int(k2.numel()), int(torch.unique(k2 * 32 + (lab2 & 31)).numel()),
         S * R))
    seg_over = sum(max(0, s - B) + max(0, e - int(math.ceil(frac * n)))
                   for e, s, n in reduces)
    P = bu["sem_stage_ranks"]
    rank_over = (_ranks_over(kv, vlab, P)
                 + _ranks_over(k2[inf2], lab2[inf2], P))
    return types.SimpleNamespace(
        idx=uniq, sums=sums, vote_voxel=vkey // L, vote_label=vkey % L,
        vote_count=vcount, blocks=blocks,
        outside=int((~inside).sum()),
        rays=max(fp.n_normal, fp.n_clear, (fp.n_pairs + 1) // 2),
        carve_jobs=0, entries=sum(r[0] for r in reduces),
        segments=max(r[1] for r in reduces),
        touched_blocks=int(blocks.shape[0]), dropped_rays=fp.dropped,
        segment_overflow=seg_over, rank_overflow=rank_over)
