"""The reference mesh of a mesh cycle, and its comparison with the port's
published mesh.

Marching cubes over the storage blocks a cycle meshes, read from the
reference's dense sums as they stood at the cycle's dispatch: each cube of
voxel centres whose 8 corners are observed (weight above MIN_WEIGHT) and
whose distances change sign gives the triangles of its case, each vertex
on its edge where the distance interpolates to zero, coloured by the
label with the most votes at the nearer corner (the first such label on a
tie). It follows voxblox's MeshIntegrator as the port's ops/mesh.py
describes it; none of that module runs here.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mc_tables

MIN_WEIGHT = 1e-4
# A cube is in doubt where a corner's distance lies within DOUBT_M of zero
# or its weight within a millionth of MIN_WEIGHT: float32 sums (the port)
# and float64 sums (the reference) may then see the corner on different
# sides, and so another case. DOUBT_M is twenty times the largest distance
# error of sound runs (PERF.md section 2).
DOUBT_M = 1e-5


def reference_mesh(blocks, acc, fu, label_colors):
    """Triangles of the blocks (K, 3) from the sums `acc` (a
    reference.Accumulated): (cube (T,) int64 box index of the cube's first
    corner, rank (T,) of the triangle in its cube, vertices (T, 3, 3)
    float64, colours (T, 3, 3) uint8, tie (T, 3) bool where the vertex's
    label had a tie, or its corner is in doubt, and the box indices of
    the cubes in doubt)."""
    V = fu["storage_voxels_per_side"]
    trunc = fu["truncation_distance"]
    vs = fu["voxel_size"]
    box = acc.box
    dev = acc.w.device
    a = torch.arange(V + 1, device=dev)
    lat = torch.stack(torch.meshgrid(a, a, a, indexing="ij"),
                      dim=-1).reshape(-1, 3)
    K = blocks.shape[0]
    vox = (blocks[:, None, :] * V + lat[None]).reshape(-1, 3)
    idx, inside = box.index(vox)
    w = torch.where(inside, acc.w[idx], 0.0)
    sdf = torch.clamp(torch.where(inside, acc.wsdf[idx], 0.0)
                      / torch.clamp(w, min=1e-12), -trunc, trunc)
    votes = torch.where(inside[None], acc.votes[:, idx], 0)
    shape = (K, V + 1, V + 1, V + 1)
    offs = torch.as_tensor(mc_tables.CORNER_OFFSETS, device=dev)
    edges = torch.as_tensor(mc_tables.EDGE_CORNERS, device=dev).long()

    def corners(t):
        t = t.reshape(shape)
        return torch.stack([t[:, o[0]:o[0] + V, o[1]:o[1] + V, o[2]:o[2] + V]
                            for o in mc_tables.CORNER_OFFSETS],
                           dim=-1).reshape(K * V ** 3, 8)
    lin = torch.arange((V + 1) ** 3, device=dev).reshape(1, -1).expand(K, -1)
    cflat = corners(lin + (torch.arange(K, device=dev)
                           * (V + 1) ** 3)[:, None])
    csdf = sdf[cflat]
    doubt = ((csdf.abs() < DOUBT_M)
             | ((w[cflat] - MIN_WEIGHT).abs() < 1e-6 * MIN_WEIGHT)).any(dim=1)
    kd = torch.nonzero(doubt).reshape(-1)
    ld = kd % V ** 3
    doubt_cubes, _ = box.index(blocks[kd // V ** 3] * V + torch.stack(
        [ld // (V * V), (ld // V) % V, ld % V], dim=1))
    observed = (w[cflat] > MIN_WEIGHT).all(dim=1)
    bits = (1 << torch.arange(8, device=dev))
    case = ((csdf < 0.0).long() * bits).sum(dim=1)
    case = torch.where(observed, case, 0)
    active = torch.nonzero((case > 0) & (case < 255)).reshape(-1)
    csdf, case, cflat = csdf[active], case[active], cflat[active]
    k = active // V ** 3
    local = active % V ** 3
    base = torch.stack([local // (V * V), (local // V) % V, local % V], dim=1)
    s0, s1 = csdf[:, edges[:, 0]], csdf[:, edges[:, 1]]
    denom = s0 - s1
    t = torch.clamp(torch.where(denom.abs() > 1e-12, s0 / denom, 0.5),
                    0.0, 1.0)
    pos = offs.double() + 0.5
    p0, dp = pos[edges[:, 0]], pos[edges[:, 1]] - pos[edges[:, 0]]
    origin = (blocks[k] * V + base).double()
    epos = (p0[None] + t[..., None] * dp[None] + origin[:, None]) * vs
    # Corner labels: most votes, the first label on a tie.
    cv = votes[:, cflat]                                    # (L, n, 8)
    top = cv.max(dim=0).values
    lab = torch.argmax((cv == top[None]).to(torch.int8), dim=0)
    tie = (cv == top[None]).sum(dim=0) > 1
    # The nearer corner colours the vertex; where the vertex lies about
    # midway (t within 1e-3 of 0.5) the port's float32 t may pick the
    # other corner: such vertices count as tied.
    near0 = t < 0.5
    elab = torch.where(near0, lab[:, edges[:, 0]], lab[:, edges[:, 1]])
    etie = torch.where(near0, tie[:, edges[:, 0]], tie[:, edges[:, 1]]) | (
        ((t - 0.5).abs() < 1e-3) & (lab[:, edges[:, 0]]
                                     != lab[:, edges[:, 1]]))
    table = torch.as_tensor(label_colors, device=dev)
    tri = torch.as_tensor(mc_tables.TRI_TABLE[:, :15], device=dev).long()[
        case].reshape(-1, 5, 3)
    tvalid = tri[:, :, 0] >= 0
    cube_i, rank = torch.nonzero(tvalid, as_tuple=True)
    e = tri[cube_i, rank]                                   # (T, 3)
    verts = epos[cube_i[:, None], e]                        # (T, 3, 3)
    cols = table[elab[cube_i[:, None], e]]
    ties = etie[cube_i[:, None], e]
    first, _ = box.index(origin[cube_i].long())
    return first, rank, verts, cols, ties, doubt_cubes


def mesh_numbers(mesh, ref, box, voxel_size):
    """Compare the port's published mesh (vertices (3T, 3), colours, a
    triangle soup) with the reference's, leaving out the cubes in doubt:
    (cubes whose triangle count differs, largest vertex error in metres
    over the triangles of the other cubes, share of their untied vertices
    whose colour differs)."""
    first, rank, verts, cols, ties, doubt_cubes = ref
    dev = verts.device
    pv = torch.as_tensor(np.asarray(mesh.vertices), device=dev).double()
    pc = torch.as_tensor(np.asarray(mesh.colors), device=dev)
    pv, pc = pv.reshape(-1, 3, 3), pc.reshape(-1, 3, 3)
    # A triangle lies in the cube of voxel centres that holds its centroid.
    base = torch.floor(pv.mean(dim=1) / voxel_size - 0.5).long()
    pcube, _ = box.index(base)
    # Rank within the cube: the port lists a cube's triangles together, in
    # the case's order.
    new = torch.ones(pcube.shape, dtype=torch.bool, device=dev)
    new[1:] = pcube[1:] != pcube[:-1]
    pos = torch.arange(pcube.numel(), device=dev)
    prank = pos - torch.cummax(torch.where(new, pos, 0), dim=0)[0]
    n_ref = torch.bincount(first, minlength=box.n)
    n_port = torch.bincount(pcube, minlength=box.n)
    cubes = (n_ref > 0) | (n_port > 0)
    cubes[doubt_cubes] = False
    same = cubes & (n_ref == n_port)
    differ = int((cubes & ~same).sum())
    rkey = first * 8 + rank
    pkey = pcube * 8 + prank
    r_ok, p_ok = same[first], same[pcube]
    rs, ri = torch.sort(rkey[r_ok])
    ps, pi = torch.sort(pkey[p_ok])
    if rs.numel() != ps.numel() or not torch.equal(rs, ps):
        return max(differ, 1), 1.0, 1.0
    rv, rc, rt = verts[r_ok][ri], cols[r_ok][ri], ties[r_ok][ri]
    qv, qc = pv[p_ok][pi], pc[p_ok][pi]
    err = float((rv - qv).abs().max()) if rv.numel() else 0.0
    untied = ~rt
    wrong = ((rc != qc).any(dim=-1) & untied).sum()
    colour = float(wrong) / max(1, int(untied.sum()))
    return differ, err, colour
