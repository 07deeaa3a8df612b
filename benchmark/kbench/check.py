"""The output check: the port's fused grid against the plain reference
(the configuration's reference module, kbench/spec.py reference).

`numbers` compares a fused grid (the port's, or the control's put in its
place) with the reference's sums and returns each compared number;
`LIMITS` holds each number's limit, set in PERF.md from the readings of
sound runs and of the control. A number passes when it is at most its
limit.

The compared numbers:
  blocks      blocks in one block set and not the other (exact)
  weight      largest relative error of a voxel's weight sum
  distance_m  largest error of a voxel's distance wsdf / wsum, metres
  votes       largest error of a voxel's label-vote count (exact)
  log_odds    largest error of a voxel's per-label log-odds sum, over the
              voxel's votes times |log p - log(1-p)|
  color       largest error of a voxel's weighted colour sum, over its
              weight times 255 (0 unless the colour mode is COLOR)
  counters    the port's overflow and dropped_rays, summed (exact)
  budgets     what the reference counts past the configuration's budgets
              and box (exact)
and, where the traffic meshes, of the last mesh the port published
(kbench/meshref.py):
  mesh_cubes     cubes whose triangle count differs, cubes in doubt left
                 out (exact)
  mesh_vertex_m  largest vertex error of the other cubes' triangles, metres
  mesh_colors    share of their vertices (labels not tied) coloured
                 otherwise
"""

from __future__ import annotations

import collections
import math
import types

import torch

from . import reference as ref

# Limits (PERF.md section 2 gives the readings each was set from): the
# float numbers above the geometric mean of the largest sound reading and
# the bfloat16 control's smallest; the exact ones 0, as the configurations'
# guarantees state.
LIMITS = {"blocks": 0, "weight": 1e-3, "distance_m": 1e-4, "votes": 0,
          "log_odds": 1e-3, "color": 1e-3, "counters": 0, "budgets": 0,
          "mesh_cubes": 0, "mesh_vertex_m": 4e-5, "mesh_colors": 0}


def reference_sums(frames, counts, conf, device, keep_updates=False,
                   slot_blocks=None, at_counts=None, reference=ref):
    """The reference's sums of a run that integrated trajectory frame f
    counts[f] times, by the configuration's reference module (`reference`,
    kbench/spec.py reference), and each frame's work counts (and, with
    keep_updates, each frame's update for the control). Given the port's
    block coordinates by slot (`slot_blocks`), the work counts also hold
    the staging rows each frame needs in the port's slot layout: 8 rows
    for each distinct group of 8 slots among the blocks it touches (the
    port's block_budget; the reference itself needs no slots). Given
    `at_counts`, a second sum counts frame f at_counts[f] times (the grid
    as it stood at a mesh cycle's dispatch). Returns (sums, work counts,
    updates, second sums or None)."""
    fu = conf["fusion"]
    box = ref.Box(conf["scene"]["bounds"], fu["voxel_size"], device)

    def new():
        return ref.Accumulated(box, fu["num_labels"], device,
                               color=fu["color_mode"] == "color")
    acc = new()
    acc_at = new() if at_counts is not None else None
    work, updates = [], []
    for f, frame in enumerate(frames):
        upd = reference.frame_update(frame, conf, box, device)
        acc.add(upd, counts[f])
        if acc_at is not None:
            acc_at.add(upd, at_counts[f])
        work.append({k: getattr(upd, k) for k in (
            "rays", "carve_jobs", "entries", "segments", "touched_blocks",
            "dropped_rays", "segment_overflow", "rank_overflow", "outside")})
        work[-1]["blocks"] = upd.blocks
        if slot_blocks is not None:
            work[-1]["staging_rows"] = 8 * _groups(slot_blocks, upd.blocks)
        if keep_updates:
            updates.append(upd)
        else:
            del upd
    return acc, work, updates, acc_at


def _groups(slot_blocks, blocks) -> int:
    """Distinct groups of 8 slots holding `blocks` (K, 3), by the slot
    order of `slot_blocks` (B, 3); blocks without a slot count one each."""
    both = torch.cat([slot_blocks, blocks])
    _, inv = torch.unique(both, dim=0, return_inverse=True)
    pos = torch.full((int(inv.max()) + 1,), -1, dtype=torch.int64,
                     device=blocks.device)
    pos[inv[:slot_blocks.shape[0]]] = torch.arange(
        slot_blocks.shape[0], device=blocks.device)
    slots = pos[inv[slot_blocks.shape[0]:]]
    return int(torch.unique(slots[slots >= 0] // 8).numel()
               + (slots < 0).sum())


def _voxels(blocks, svps):
    """Global voxel coordinates (K * V3, 3) of blocks (K, 3), in the
    grid's row order (local index ((x * V) + y) * V + z)."""
    a = torch.arange(svps, device=blocks.device)
    lx, ly, lz = torch.meshgrid(a, a, a, indexing="ij")
    local = torch.stack([lx, ly, lz], dim=-1).reshape(-1, 3)
    return (blocks[:, None, :] * svps + local[None]).reshape(-1, 3)


def _block_set_diff(a, b) -> int:
    both = torch.cat([torch.unique(a, dim=0), torch.unique(b, dim=0)])
    _, cnt = torch.unique(both, dim=0, return_counts=True)
    return int((cnt == 1).sum())


def numbers(out: dict, acc: ref.Accumulated, work, conf: dict) -> dict:
    """Each compared number of a fused grid `out` (port.output's layout)
    against the reference's sums."""
    fu = conf["fusion"]
    svps = fu["storage_voxels_per_side"]
    delta = abs(math.log(fu["measurement_probability"])
                - math.log(1.0 - fu["measurement_probability"]))
    box = acc.box
    blocks = out["blocks"]
    vox = _voxels(blocks, svps)
    idx, inside = box.index(vox)

    def at(t):
        return torch.where(inside, t[..., idx], torch.zeros((), dtype=t.dtype,
                                                            device=t.device))
    w_r, wsdf_r = at(acc.w), at(acc.wsdf)
    votes_r = at(acc.votes)                                  # (L, N)
    w_p = out["wsum"].reshape(-1).double()
    wsdf_p = out["wsdf"].reshape(-1).double()
    tiny = 1e-300
    weight = float(((w_p - w_r).abs() / w_r.clamp(min=tiny)).max()) \
        if w_p.numel() else 0.0
    obs = w_r > 0
    d_p = wsdf_p / w_p.clamp(min=tiny)
    d_r = wsdf_r / w_r.clamp(min=tiny)
    distance = float((d_p - d_r).abs()[obs].max()) if bool(obs.any()) \
        else 0.0
    total_r = votes_r[1:].sum(dim=0)
    votes = float((out["sem_count"].reshape(-1).double()
                   - total_r.double()).abs().max()) if w_p.numel() else 0.0
    sem_p = out["sem_delta"].reshape(fu["num_labels"], -1).double()
    sem_r = votes_r.double() * delta
    log_odds = float(((sem_p - sem_r).abs()
                      / (total_r.double() * delta).clamp(min=delta)).max()) \
        if w_p.numel() else 0.0
    col_p = out["wcolor"].reshape(3, -1).double()
    col_r = at(acc.wcolor) if acc.wcolor is not None else torch.zeros_like(
        col_p)
    color = float(((col_p - col_r).abs()
                   / (255.0 * w_r.clamp(min=tiny))).max()) \
        if w_p.numel() else 0.0
    ref_blocks = acc.blocks if acc.blocks is not None else blocks[:0]
    budgets = sum(w["dropped_rays"] + w["segment_overflow"]
                  + w["rank_overflow"] + w["outside"] for w in work)
    budgets += max(0, int(ref_blocks.shape[0])
                   - conf["budgets"]["storage_block_capacity"])
    return {"blocks": _block_set_diff(blocks, ref_blocks),
            "weight": weight, "distance_m": distance, "votes": votes,
            "log_odds": log_odds, "color": color,
            "counters": out["overflow"] + out["dropped_rays"],
            "budgets": budgets}


def passes(nums: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in nums.items())


def control_output(updates, order, acc: ref.Accumulated, conf: dict,
                   dtype=torch.bfloat16, snapshot_at=None):
    """The control: the reference put in the port's place and computed in
    bfloat16, the precision below the configuration's float32. Each
    frame's update is rounded to bfloat16 and added, in the run's order,
    into bfloat16 accumulators; the result is laid out as port.output's,
    over the reference's block set. With `snapshot_at` n, also returns
    the sums as they stood after the run's n-th frame (for the control's
    mesh), in reference.Accumulated's fields."""
    box = acc.box
    dev = acc.w.device
    L = acc.L
    w = torch.zeros(box.n, dtype=dtype, device=dev)
    wsdf = torch.zeros_like(w)
    cnt = torch.zeros_like(w)
    sem = torch.zeros((L, box.n), dtype=dtype, device=dev)
    col = torch.zeros((3, box.n), dtype=dtype, device=dev)
    fu = conf["fusion"]
    delta = math.log(fu["measurement_probability"]) - math.log(
        1.0 - fu["measurement_probability"])

    def add(t, i, v):
        t[..., i] = (t[..., i].float() + v.to(dtype).float()).to(dtype)
    snap = None
    for n, f in enumerate(order):
        if n == snapshot_at:
            snap = types.SimpleNamespace(box=box, L=L, w=w.double(),
                                         wsdf=wsdf.double(),
                                         votes=sem.double())
        u = updates[f]
        add(w, u.idx, u.sums[0])
        add(wsdf, u.idx, u.sums[1])
        if acc.wcolor is not None:
            add(col, u.idx, u.sums[3:6])
        add(cnt, u.idx, u.sums[6])
        sem[u.vote_label, u.vote_voxel] = (
            sem[u.vote_label, u.vote_voxel].float()
            + (u.vote_count.double() * delta).to(dtype).float()).to(dtype)
    blocks = acc.blocks
    svps = fu["storage_voxels_per_side"]
    vox = _voxels(blocks, svps)
    idx, inside = box.index(vox)
    K, V3 = blocks.shape[0], svps ** 3

    def rows(t):
        v = torch.where(inside, t[..., idx].float(), 0.0)
        return v.reshape(*t.shape[:-1], K, V3)
    out = dict(blocks=blocks, wsum=rows(w), wsdf=rows(wsdf),
               sem_count=rows(cnt), sem_delta=rows(sem), wcolor=rows(col),
               overflow=0, dropped_rays=0)
    if snapshot_at is not None and snap is None:
        snap = types.SimpleNamespace(box=box, L=L, w=w.double(),
                                     wsdf=wsdf.double(), votes=sem.double())
    return out, snap


def judge(out: dict, mesh, cycles: int, frames, order, conf: dict, colors,
          every: int, device, control: bool, reference=ref):
    """The whole output check of a run, the program's state already freed:
    `out` the port's grid (port.output), `mesh` the last mesh it
    published and `cycles` the mesh cycles it dispatched, `order` the
    trajectory frame of every frame it integrated, `every` the frames
    between mesh cycles (0: none), `reference` the configuration's
    reference module. Returns (compared numbers, the bfloat16 control's
    or None, each trajectory frame's work counts)."""
    from . import meshref
    F = len(frames)
    counts = collections.Counter(order)
    # The last cycle was dispatched after frame n_k and meshed the blocks
    # that the frames since the cycle before touched.
    n_k = every * (len(order) // every) if every else 0
    at = collections.Counter(order[:n_k])
    acc, work, updates, acc_at = reference_sums(
        frames, [counts[f] for f in range(F)], conf, device,
        keep_updates=control, slot_blocks=out["blocks"],
        at_counts=[at[f] for f in range(F)] if every else None,
        reference=reference)
    nums = numbers(out, acc, work, conf)
    cnums = snap = None
    if control:
        cout, snap = control_output(updates, order, acc, conf,
                                    snapshot_at=n_k if every else None)
        cnums = numbers(cout, acc, work, conf)
        del cout, updates
    if every:
        fu = conf["fusion"]
        keys = ("mesh_cubes", "mesh_vertex_m", "mesh_colors")
        blocks = torch.unique(torch.cat(
            [work[f]["blocks"] for f in order[n_k - every:n_k]]), dim=0)
        ref_mesh = meshref.reference_mesh(blocks, acc_at, fu, colors)
        ok = mesh is not None and cycles == n_k // every
        nums.update(zip(keys, meshref.mesh_numbers(
            mesh, ref_mesh, acc.box, fu["voxel_size"]) if ok
            else (1, 1.0, 1.0)))
        if control:
            c = meshref.reference_mesh(blocks, snap, fu, colors)
            cmesh = types.SimpleNamespace(
                vertices=c[2].reshape(-1, 3).float().cpu().numpy(),
                colors=c[3].reshape(-1, 3).cpu().numpy())
            cnums.update(zip(keys, meshref.mesh_numbers(
                cmesh, ref_mesh, acc.box, fu["voxel_size"])))
    return nums, cnums, work
