"""Batched per-block marching cubes -> semantically coloured triangle mesh.

Counterpart: kimera_semantics_tpu/ops/mesh.py (Mesh, connect_mesh,
render_colors, extract_mesh, extract_mesh_cycle, extract_mesh_cycle_async).
The JAX package has no Pallas kernel here; the port's marching cubes is
plain PyTorch on the grid's device, over chunks of blocks:

  1. per block, one gather builds its (V+1)^3 corner lattice of distance and
     weight from the block and its 7 (+x/+y/+z) neighbours (missing
     neighbours and the trash rows read as unobserved);
  2. the 256-case index of every cube, from 8 static slices of the lattice;
  3. the active cubes (all corners observed, case 1..254) are compacted,
     and only they interpolate edges, colour vertices (from the voxel
     nearest each vertex) and assemble triangles.

Triangles come out in the legacy order of the JAX package: ascending block
slot, then voxel, then triangle. Colours are computed per cube corner from
the grid's accumulators by ColorMode, with the values of the JAX package's
render_colors.

`extract_mesh_cycle_async` enqueues every device read of the grid (block
selection, lattices, colours, and the compaction into fixed-budget buffers)
on the current stream before it returns, and starts the copy of the
results to the host; its `collect()` only waits on an event and reads host
memory. The integrators update the grid IN PLACE, so the stream order is
what keeps the dispatched cycle on the grid as it was at dispatch. The
budgets are constants (the JAX package's environment overrides and its u16
fetch wire are TPU transport and are left out).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_UNIFORM_LOG_PRIOR, ColorMode, FusionConfig
from ..core.color import LabelColorMap, rainbow_colormap
from ..core.fp import fma
from ..grid import blocks as gblocks
from ..grid.blocks import VoxelGrid
from . import mc_tables
from . import semantic as sem_ops

MIN_WEIGHT = 1e-4  # voxblox MeshIntegratorConfig::min_weight

# Budgets of the cycle program (the JAX package's defaults).
TRI_BUDGET = 49152       # triangle rows per chunk of blocks in the output
CUBE_BUDGET = 32768      # active cubes per chunk
LOOKUP_ROUNDS = 16       # hash probe rounds of the neighbour lookup


@dataclasses.dataclass
class Mesh:
    """Triangle soup with per-vertex colors (host-side numpy)."""

    vertices: np.ndarray   # (N, 3) float32 world coords
    colors: np.ndarray     # (N, 3) uint8
    triangles: np.ndarray  # (N/3, 3) int32 indices (soup)
    normals: Optional[np.ndarray] = None  # (N, 3) float32 unit outward

    @property
    def num_triangles(self) -> int:
        return self.triangles.shape[0]


def connect_mesh(mesh: Mesh, voxel_size: float) -> Mesh:
    """Triangle soup -> connected (vertex-deduplicated) indexed mesh: an
    exact weld on positions quantized at voxel_size / 1024 (voxblox
    MeshLayer getConnectedMesh). First occurrence keeps its colour and
    normal."""
    if len(mesh.vertices) == 0:
        return mesh
    q = np.round(mesh.vertices / (voxel_size / 1024.0)).astype(np.int64)
    _, first, inv = np.unique(q, axis=0, return_index=True,
                              return_inverse=True)
    order = np.argsort(first)               # keep first-occurrence order
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    keep = np.sort(first)
    return Mesh(vertices=mesh.vertices[keep],
                colors=mesh.colors[keep],
                triangles=rank[inv.reshape(-1)].astype(np.int32)[
                    mesh.triangles.reshape(-1)].reshape(-1, 3),
                normals=(mesh.normals[keep]
                         if mesh.normals is not None else None))


def _label_table(cfg: FusionConfig, label_map: Optional[LabelColorMap],
                 device) -> torch.Tensor:
    if label_map is None:
        if cfg.semantic.color_mode == ColorMode.SEMANTIC:
            raise ValueError("SEMANTIC color mode needs a LabelColorMap")
        return torch.zeros((256, 3), dtype=torch.uint8, device=device)
    return torch.as_tensor(label_map.label_colors, device=device)


def voxel_colors(grid: VoxelGrid, cfg: FusionConfig,
                 label_table: torch.Tensor, flat: torch.Tensor):
    """Mesh colour (..., 3) float32 of the voxels at flat indices `flat`
    (row * V3 + voxel) by ColorMode, the per-voxel values of
    render_colors."""
    mode = cfg.semantic.color_mode
    if mode == ColorMode.COLOR:
        w = torch.clamp(grid.wsum.reshape(-1)[flat], min=1e-12)
        c = grid.wcolor.reshape(3, -1)[:, flat] / w[None]
        rgb = torch.clamp(c, 0.0, 255.0).to(torch.uint8)
        return torch.movedim(rgb, 0, -1).to(torch.float32)
    L = grid.sem_delta.shape[0]
    sem = grid.sem_delta.reshape(L, -1)[:, flat]
    if mode == ColorMode.SEMANTIC:
        labels = torch.argmax(sem, dim=0)        # ties: the first label
        return label_table[labels].to(torch.float32)
    if mode == ColorMode.SEMANTIC_PROBABILITY:
        lk = sem_ops.make_likelihood(cfg.semantic)
        lo = fma(grid.sem_count.reshape(-1)[flat][None], lk.log_nonmatch,
                 DEFAULT_UNIFORM_LOG_PRIOR) + sem
        # rainbowColorMap(exp(max log-odds)), unnormalized as the reference
        return rainbow_colormap(torch.exp(lo.amax(dim=0))).to(torch.float32)
    raise ValueError(f"unknown color mode {mode}")


def render_colors(grid: VoxelGrid, cfg: FusionConfig,
                  label_map: Optional[LabelColorMap]) -> torch.Tensor:
    """Per-voxel mesh colour (3, R, V3) float32 per the ColorMode semantics
    of the reference's updateSemanticVoxel."""
    R, V3 = grid.wsum.shape
    flat = torch.arange(R * V3, device=grid.wsum.device)
    table = _label_table(cfg, label_map, grid.wsum.device)
    rgb = voxel_colors(grid, cfg, table, flat)
    return rgb.T.reshape(3, R, V3)


# ---------------------------------------------------------------------------
# Marching cubes over one chunk of blocks
# ---------------------------------------------------------------------------

_NBR_OFFSETS = np.array([[(n >> 2) & 1, (n >> 1) & 1, n & 1]
                         for n in range(8)], dtype=np.int32)  # self first


@dataclasses.dataclass
class _Tables:
    """Static index tables of one (device, vps)."""
    lat_nbr: torch.Tensor    # ((V+1)^3,) neighbour index of each lattice point
    lat_local: torch.Tensor  # ((V+1)^3,) its voxel index in that block
    corner: torch.Tensor     # (8, 3) cube corner offsets
    edges: torch.Tensor      # (12, 2) edge corners
    p0: torch.Tensor         # (12, 3) edge start, local voxel-centre units
    dp: torch.Tensor         # (12, 3) edge direction (p1 - p0)
    tri: torch.Tensor        # (256, 15) edge ids, -1 padded


_TABLES = {}


def _tables(vps: int, device) -> _Tables:
    key = (vps, str(device))
    if key not in _TABLES:
        V = vps
        a = np.arange(V + 1)
        X, Y, Z = np.meshgrid(a, a, a, indexing="ij")
        nbr = ((X == V) * 4 + (Y == V) * 2 + (Z == V)).reshape(-1)
        local = (((X % V) * V + (Y % V)) * V + (Z % V)).reshape(-1)
        offs = mc_tables.CORNER_OFFSETS
        ec = mc_tables.EDGE_CORNERS
        pos = offs.astype(np.float32) + 0.5
        t = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x), dtype=dt,  # noqa: E731
                                          device=device)
        _TABLES[key] = _Tables(
            lat_nbr=t(nbr, torch.int64), lat_local=t(local, torch.int64),
            corner=t(offs, torch.int64), edges=t(ec, torch.int64),
            p0=t(pos[ec[:, 0]], torch.float32),
            dp=t(pos[ec[:, 1]] - pos[ec[:, 0]], torch.float32),
            tri=t(mc_tables.TRI_TABLE[:, :15], torch.int64))
    return _TABLES[key]


def _neighbour_slots(grid: VoxelGrid, cfg: FusionConfig, slots: torch.Tensor,
                     rounds: int):
    """(K, 8) slots of each block and its 7 +x/+y/+z neighbours (index
    4 dx + 2 dy + dz); capacity for missing blocks and padding entries.
    With `rounds`, no host sync, and a device bool that the lookup is
    complete."""
    g = cfg.grid
    cap = g.block_capacity
    coords = grid.block_coords[torch.clamp(slots, max=cap - 1)]
    offs = torch.as_tensor(_NBR_OFFSETS, device=slots.device)
    out = gblocks.lookup_slots(grid, coords[:, None, :] + offs[None], g,
                               rounds=rounds)
    nbr, complete = out if rounds else (out, None)
    nbr = torch.where((slots < cap)[:, None], nbr, cap)
    return nbr.to(torch.int64), complete


def _mesh_chunk(grid: VoxelGrid, cfg: FusionConfig, label_table,
                slots: torch.Tensor, with_normals: bool,
                cube_budget: Optional[int], rounds: int = 0):
    """Marching cubes over the K blocks of `slots` (int64, capacity for
    padding). Returns per-triangle tensors (verts (T, 9), colors (T, 9),
    normals (T, 9) or None, rows (T,) int32, valid (T,) bool) in legacy
    order, the active-cube count and the lookup-complete flag.

    cube_budget None: complete output (the active cubes are found with a
    host sync). Otherwise the first `cube_budget` active cubes are kept
    without a sync, T = 5 * cube_budget, and a count above the budget
    means the output is incomplete."""
    g = cfg.grid
    V, V3, cap = g.voxels_per_side, g.vps3, g.block_capacity
    dev = slots.device
    tb = _tables(V, dev)
    K = slots.shape[0]
    nbr, complete = _neighbour_slots(grid, cfg, slots, rounds)

    # Corner lattices (K, V+1, V+1, V+1) by one gather each; rows at or
    # past capacity (missing neighbours, the trash tile) read as unobserved.
    lat_slot = nbr[:, tb.lat_nbr]                            # (K, (V+1)^3)
    lat_flat = lat_slot * V3 + tb.lat_local[None]
    w = torch.where(lat_slot < cap, grid.wsum.reshape(-1)[lat_flat], 0.0)
    sdf = torch.clamp(grid.wsdf.reshape(-1)[lat_flat]
                      / torch.clamp(w, min=1e-12),
                      -cfg.tsdf.truncation_distance,
                      cfg.tsdf.truncation_distance)
    shape = (K, V + 1, V + 1, V + 1)
    w, sdf = w.reshape(shape), sdf.reshape(shape)

    def corners(lat):
        return torch.stack([lat[:, o[0]:o[0] + V, o[1]:o[1] + V,
                                o[2]:o[2] + V]
                            for o in mc_tables.CORNER_OFFSETS],
                           dim=-1).reshape(K * V3, 8)
    csdf = corners(sdf)
    observed = (corners(w) > MIN_WEIGHT).all(dim=1)
    bits = torch.tensor([1 << i for i in range(8)], dtype=torch.int32,
                        device=dev)
    case = ((csdf < 0.0).to(torch.int32) * bits).sum(dim=1, dtype=torch.int32)
    case = torch.where(observed, case, 0)
    active = (case > 0) & (case < 255)
    n_active = active.sum(dtype=torch.int32)

    # Active cubes, ascending.
    if cube_budget is None:
        cidx = torch.nonzero(active).reshape(-1)
        cvalid = torch.ones(cidx.shape, dtype=torch.bool, device=dev)
    else:
        rank = torch.cumsum(active.to(torch.int32), 0) - 1
        dst = torch.where(active & (rank < cube_budget), rank,
                          cube_budget).long()
        cidx = torch.zeros(cube_budget + 1, dtype=torch.int64, device=dev)
        cidx[dst] = torch.arange(K * V3, device=dev)
        cidx = cidx[:cube_budget]
        cvalid = torch.arange(cube_budget, device=dev) < n_active
    CB = cidx.shape[0]
    csdf_c = csdf[cidx]                                      # (CB, 8)
    case_c = torch.where(cvalid, case[cidx], 0)
    k = cidx // V3
    lin = cidx % V3
    base = torch.stack([lin // (V * V), (lin // V) % V, lin % V], dim=1)

    # Colours of the cube corners, from the voxel each corner stands on.
    lp = ((base[:, None, :] + tb.corner[None]) * torch.tensor(
        [(V + 1) ** 2, V + 1, 1], device=dev)).sum(dim=2)    # (CB, 8)
    cflat = lat_flat.reshape(K, -1)[k[:, None], lp]
    ccol = voxel_colors(grid, cfg, label_table, cflat)       # (CB, 8, 3)

    # Edge interpolation (the JAX package's float association:
    # (p0 + t (p1 - p0) + base + block origin) * voxel_size).
    s0, s1 = csdf_c[:, tb.edges[:, 0]], csdf_c[:, tb.edges[:, 1]]
    denom = s0 - s1
    t = torch.clamp(torch.where(denom.abs() > 1e-12, s0 / denom, 0.5),
                    0.0, 1.0)                                # (CB, 12)
    world0 = (grid.block_coords[torch.clamp(slots, max=cap - 1)][k]
              * V).to(torch.float32)
    epos = tb.p0[None] + t[..., None] * tb.dp[None]
    epos = epos + base.to(torch.float32)[:, None]
    epos = (epos + world0[:, None]) * g.voxel_size           # (CB, 12, 3)
    near0 = (t < 0.5)[..., None]
    ecol = torch.where(near0, ccol[:, tb.edges[:, 0]],
                       ccol[:, tb.edges[:, 1]])

    enrm = None
    if with_normals:
        # Normalized trilinear TSDF gradient at the edge vertex, local cube
        # coordinates in [0, 1]^3.
        local = (tb.p0 - 0.5)[None] + t[..., None] * tb.dp[None]
        o = tb.corner.to(torch.float32)                      # (8, 3)
        u = local[:, :, None, :]                             # (CB, 12, 1, 3)
        f = torch.where(o[None, None] > 0.5, u, 1.0 - u)     # (CB, 12, 8, 3)
        df = torch.where(o > 0.5, 1.0, -1.0)                 # (8, 3)
        sb = csdf_c[:, None, :]
        grad = torch.stack([
            (sb * df[:, 0] * f[..., 1] * f[..., 2]).sum(dim=-1),
            (sb * df[:, 1] * f[..., 0] * f[..., 2]).sum(dim=-1),
            (sb * df[:, 2] * f[..., 0] * f[..., 1]).sum(dim=-1)], dim=-1)
        norm = torch.sqrt((grad * grad).sum(dim=-1, keepdim=True))
        enrm = grad / torch.clamp(norm, min=1e-12)

    # Triangles: (CB, 5) of 3 edge vertices each.
    tri = tb.tri[case_c]                                     # (CB, 15)
    tvalid = (tri.reshape(CB, 5, 3)[:, :, 0] >= 0) & cvalid[:, None]
    sel = torch.clamp(tri, min=0)[..., None].expand(CB, 15, 3)

    def gather(e):
        return torch.gather(e, 1, sel).reshape(CB * 5, 9)
    rows = torch.where(cvalid, slots[k], -1).to(torch.int32)
    return (gather(epos), gather(ecol),
            gather(enrm) if with_normals else None,
            rows[:, None].expand(CB, 5).reshape(-1), tvalid.reshape(-1),
            n_active,
            complete)


# ---------------------------------------------------------------------------
# The cycle program: one page of blocks, dispatched without host syncs
# ---------------------------------------------------------------------------

def _cycle_geometry(cfg: FusionConfig, page_blocks: int = 256):
    """(chunk, n_chunks): chunk x vps3 bounded at 2^20 cubes (and by the
    page), and at least `page_blocks` blocks per page."""
    chunk = min(256, max(1, (1 << 20) // cfg.grid.vps3), int(page_blocks))
    n_chunks = max(1, -(-int(page_blocks) // chunk))
    return chunk, n_chunks


class _Page:
    """One dispatched page of the cycle: device buffers, their host copies
    (started at dispatch) and the event that marks them done."""

    def __init__(self, grid: VoxelGrid, cfg: FusionConfig, label_table,
                 only_updated: bool, with_normals: bool, start: int,
                 chunk: int, n_chunks: int, hint_rows: int):
        g = cfg.grid
        cap = g.block_capacity
        dev = grid.wsum.device
        kmax = chunk * n_chunks
        total_rows = n_chunks * TRI_BUDGET

        # Block selection: the (updated &) allocated slots, ascending; this
        # page takes ranks [start, start + kmax).
        iota = torch.arange(cap, device=dev)
        sel = iota < grid.n_blocks
        if only_updated:
            sel = sel & grid.updated[:cap]
        n_sel = sel.sum(dtype=torch.int32)
        rank = torch.cumsum(sel.to(torch.int32), 0) - 1 - start
        dst = torch.where(sel & (rank >= 0) & (rank < kmax), rank, kmax)
        page = torch.full((kmax + 1,), cap, dtype=torch.int64, device=dev)
        page[dst.long()] = iota
        page = page[:kmax]

        C = 9
        bufs = [torch.zeros((total_rows + 1, C), dtype=torch.float32,
                            device=dev) for _ in range(3 if with_normals
                                                       else 2)]
        rows = torch.full((total_rows + 1,), -1, dtype=torch.int32,
                          device=dev)
        off = torch.zeros((), dtype=torch.int64, device=dev)
        over = torch.zeros((), dtype=torch.bool, device=dev)
        for c in range(n_chunks):
            tv, tc, tn, tr, tm, nact, complete = _mesh_chunk(
                grid, cfg, label_table, page[c * chunk:(c + 1) * chunk],
                with_normals, CUBE_BUDGET, rounds=LOOKUP_ROUNDS)
            pos = off + torch.cumsum(tm.to(torch.int64), 0) - 1
            dst = torch.where(tm & (pos < total_rows), pos, total_rows)
            for buf, val in zip(bufs, (tv, tc, tn)):
                buf[dst] = val
            rows[dst] = tr
            off = off + tm.sum()
            over = over | (nact > CUBE_BUDGET) | ~complete
        over = over | (off > total_rows)
        self.slots = page
        self.bufs, self.rows = bufs, rows[:total_rows]
        self.total_rows = total_rows
        # Host copies: the scalars, the page's slots and the hinted prefix
        # of the buffers, started now and done at the event.
        b0 = min(total_rows, max(16384, -(-int(hint_rows * 1.3) // 16384)
                                 * 16384))
        self.b0 = b0
        scalars = torch.stack([off, n_sel.to(torch.int64),
                               over.to(torch.int64)])
        self._host = [_to_host(x) for x in
                      [scalars, page] + [b[:b0] for b in bufs]
                      + [self.rows[:b0]]]
        self._event = (torch.cuda.Event() if dev.type == "cuda" else None)
        if self._event is not None:
            self._event.record()

    def fetch(self):
        """(total, n_sel, overflowed, slots, verts, colors, normals, rows)
        on the host, once the page's work is done."""
        if self._event is not None:
            self._event.synchronize()
        scalars, slots, *rest = (h.numpy() for h in self._host)
        total, n_sel, over = (int(x) for x in scalars)
        bufs = rest[:-1]
        rows = rest[-1]
        if total > self.b0 and not over:
            # More triangles than the hint: copy the rest of the finished
            # buffers.
            bufs = [np.concatenate([b, d[self.b0:total].cpu().numpy()])
                    for b, d in zip(bufs, self.bufs)]
            rows = np.concatenate([rows,
                                   self.rows[self.b0:total].cpu().numpy()])
        bufs = [b[:total] for b in bufs]
        if len(bufs) == 2:
            bufs.append(None)
        return (total, n_sel, bool(over), slots, *bufs, rows[:total])


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """An asynchronous copy of `x` into (pinned) host memory."""
    if x.device.type == "cpu":
        return x.clone()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x, non_blocking=True)
    return out


def _assemble(v, c, n, tri_rows, sel, return_blocks: bool):
    verts = v.reshape(-1, 3).astype(np.float32)
    mesh = Mesh(vertices=verts,
                colors=np.clip(c.reshape(-1, 3), 0, 255).astype(np.uint8),
                triangles=np.arange(len(verts), dtype=np.int32).reshape(-1, 3),
                normals=(n.reshape(-1, 3).astype(np.float32)
                         if n is not None else None))
    if return_blocks:
        return mesh, sel.astype(np.int32), tri_rows.astype(np.int32)
    return mesh


def extract_mesh_cycle_async(grid: VoxelGrid, cfg: FusionConfig,
                             label_map: Optional[LabelColorMap] = None,
                             only_updated: bool = False,
                             with_normals: bool = False,
                             return_blocks: bool = False,
                             hint_rows: int = 4096,
                             hold_grid: bool = True,
                             page_blocks: int = 256):
    """Dispatch the cycle program NOW and return a collect() closure.

    Every device read of the grid is enqueued on the current stream before
    this returns, so the caller may clear `updated` and go on integrating
    (the grid is updated in place, after these reads in stream order).
    collect() (typically on a worker thread) waits on the cycle's event and
    returns what extract_mesh returns.

    `hint_rows`: the expected triangle count (e.g. the previous cycle's);
    that prefix of the output is copied to the host at dispatch, a larger
    count copies the rest in collect(). After collect() returns,
    `collect.total_rows` holds the cycle's triangle count.

    `page_blocks`: blocks per page (rounded up to whole chunks). A cycle
    with more selected blocks than a page, or whose chunk overflows a
    budget, is incomplete: with `hold_grid=False` collect() returns None
    and the caller re-marks the blocks and retries; with `hold_grid=True`
    collect() meshes the further pages, or the whole request on the
    complete path, from the grid as it is at collect() time, so the caller
    must not change the grid before then."""
    label_table = _label_table(cfg, label_map, grid.wsum.device)
    chunk, n_chunks = _cycle_geometry(cfg, page_blocks)
    kmax = chunk * n_chunks
    args = (cfg, label_table, only_updated, with_normals)
    first = _Page(grid, *args, 0, chunk, n_chunks, hint_rows)
    grid_ref = grid if hold_grid else None
    del grid

    def collect():
        parts, sel_parts = [], []
        start, n_sel, page = 0, None, first
        while n_sel is None or start < n_sel:
            if page is None:     # further pages: dispatched on demand
                if grid_ref is None:
                    return None
                page = _Page(grid_ref, *args, start, chunk, n_chunks,
                             hint_rows)
            total, n_sel, over, slots, v, c, n, rows = page.fetch()
            page = None
            if over:
                if grid_ref is None:
                    return None
                return extract_mesh(grid_ref, cfg, label_map,
                                    only_updated=only_updated,
                                    with_normals=with_normals,
                                    return_blocks=return_blocks,
                                    _force_legacy=True)
            parts.append((v, c, n, rows))
            collect.total_rows = max(getattr(collect, "total_rows", 0), total)
            sel_parts.append(slots[slots < cfg.grid.block_capacity])
            start += kmax
        v, c, n, rows = (np.concatenate(x) if x[0] is not None else None
                         for x in zip(*parts))
        return _assemble(v, c, n, rows, np.concatenate(sel_parts),
                         return_blocks)

    return collect


def extract_mesh_cycle(grid: VoxelGrid, cfg: FusionConfig,
                       label_map: Optional[LabelColorMap] = None,
                       only_updated: bool = False,
                       with_normals: bool = False,
                       return_blocks: bool = False):
    """extract_mesh through the cycle program, with paging and the
    complete path on a budget overflow."""
    return extract_mesh_cycle_async(grid, cfg, label_map,
                                    only_updated=only_updated,
                                    with_normals=with_normals,
                                    return_blocks=return_blocks)()


def extract_mesh(grid: VoxelGrid, cfg: FusionConfig,
                 label_map: Optional[LabelColorMap] = None,
                 only_updated: bool = False, batch: Optional[int] = None,
                 with_normals: bool = False, return_blocks: bool = False,
                 _force_legacy: bool = False):
    """The mesh of the allocated (or updated) blocks
    (TsdfServer::generateMesh / the periodic mesh update).

    With `return_blocks=True` returns `(Mesh, meshed_rows, tri_rows)`: the
    grid rows meshed by this call (even those with no triangle) and the
    grid row of every triangle, the voxblox MeshLayer update contract.

    The default route is the cycle program (extract_mesh_cycle); an
    explicit `batch` takes the complete per-batch path, which is also the
    cycle's fallback on a budget overflow."""
    if not _force_legacy and batch is None:
        return extract_mesh_cycle(grid, cfg, label_map,
                                  only_updated=only_updated,
                                  with_normals=with_normals,
                                  return_blocks=return_blocks)
    if batch is None:
        batch = max(1, (32 * 4096) // cfg.grid.vps3)
    cap = cfg.grid.block_capacity
    dev = grid.wsum.device
    label_table = _label_table(cfg, label_map, dev)
    sel = torch.arange(cap, device=dev) < grid.n_blocks
    if only_updated:
        sel = sel & grid.updated[:cap]
    sel = torch.nonzero(sel).reshape(-1)
    parts = []
    for i in range(0, sel.shape[0], batch):
        slots = torch.full((batch,), cap, dtype=torch.int64, device=dev)
        chunk = sel[i:i + batch]
        slots[:chunk.shape[0]] = chunk
        tv, tc, tn, tr, tm, _, _ = _mesh_chunk(grid, cfg, label_table, slots,
                                               with_normals, None)
        parts.append([x[tm].cpu().numpy() if x is not None else None
                      for x in (tv, tc, tn, tr)])
    if parts:
        v, c, n, rows = (np.concatenate(x) if x[0] is not None else None
                         for x in zip(*parts))
    else:
        v = c = np.zeros((0, 9), np.float32)
        n = np.zeros((0, 9), np.float32) if with_normals else None
        rows = np.zeros(0, np.int32)
    return _assemble(v, c, n, rows, sel.cpu().numpy(), return_blocks)
