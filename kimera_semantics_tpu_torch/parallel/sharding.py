"""Spatial sharding of the voxel grid over D shards.

Counterpart: kimera_semantics_tpu/parallel/sharding.py (make_mesh,
create_sharded, integrate_frames_sharded,
integrate_frames_sharded_projective, _sharded_dense_apply, merge_shards,
ShardMirror). The block hash table is sharded by block-key hash: every
shard owns the blocks whose key hashes to it (ops/integrate.py owned), so
ownership is disjoint and balanced. Frames are data-parallel, one per shard
and step: each shard prepares its own frame, the prepared streams (ray
jobs, semantic votes, mip atlases and candidate keys) are gathered to every
shard, and each shard applies the updates that land in blocks it owns.
Updates are the single-device scatter-adds, so no block contents are ever
exchanged.

A mesh (ShardMesh) is this process's shards, each on a device (one device
may hold several shards, as the reference's virtual CPU devices do), and a
torch.distributed process group joining the processes. Global shard
rank * n_local + i is local shard i of process `rank`. The local shards
run one after another; a step runs each phase (own-frame work, gather,
owned integrate) for every local shard before the next phase, which is the
order of the reference's per-device body. Times of D shards on one card
are sequential work, not a multi-card number.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..config import FusionConfig
from ..core.camera import PinholeIntrinsics
from ..grid import blocks as gblocks
from ..grid import hash as bhash
from ..grid.blocks import VoxelGrid
from ..models import common
from ..ops import carve as carve_ops
from ..ops import mip as mip_ops
from ..ops.integrate import integrate_jobs
from ..ops.reduce import TRASH_KEY

# Dtypes every collective backend carries as they are; others (bool,
# uint16, int16, ...) travel as their bytes: NCCL has no 16-bit integer
# type and gloo no int16.
_WIRE_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64,
                torch.uint8)


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """This process's shards and the group joining the processes."""
    devices: tuple               # torch.device of each local shard
    group: Optional[object]      # torch.distributed process group, or None
    rank: int
    world: int

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """D, the global shard count."""
        return self.world * self.n_local

    def shard_index(self, i: int) -> int:
        return self.rank * self.n_local + i


def make_mesh(n_devices: Optional[int] = None, devices=None,
              group=None) -> ShardMesh:
    """The shard mesh. By default one shard per visible CUDA card
    (n_devices of them; raises when fewer are visible, as the reference's
    mesh needs n devices); an explicit `devices` list places the local
    shards, e.g. [torch.device("cpu")] * 4 or [cuda:0] * 4, several shards
    sharing one device. Across processes (a process group given, or the
    default group initialized) each process brings its own local shards;
    give each process its cards with `devices` or CUDA_VISIBLE_DEVICES."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    world = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_devices is None else n_devices
        if n < 1 or n > have:
            raise RuntimeError(
                f"a mesh of {n} shards needs {n} CUDA cards; {have} visible "
                "(pass devices=[...] to place several shards on one device)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(_canonical(torch.device(d)) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one shard")
    return ShardMesh(devices=devices, group=group, rank=rank, world=world)


def _canonical(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass
class ShardedGrid:
    """One VoxelGrid per local shard (the reference's stacked grid, whose
    leading axis is the shard)."""
    shards: List[VoxelGrid]

    def __len__(self):
        return len(self.shards)

    def __getitem__(self, i) -> VoxelGrid:
        return self.shards[i]

    def __iter__(self):
        return iter(self.shards)

    def stacked(self, name: str) -> torch.Tensor:
        """Field `name` of every local shard, stacked on the CPU."""
        return torch.stack([getattr(g, name).cpu() for g in self.shards])

    def total(self, name: str) -> int:
        """A scalar counter summed over the local shards."""
        return int(sum(int(getattr(g, name)) for g in self.shards))


def create_sharded(cfg: FusionConfig, mesh: ShardMesh) -> ShardedGrid:
    """Empty grids, one per local shard on its device."""
    return ShardedGrid([gblocks.create(cfg, device=d) for d in mesh.devices])


# ---------------------------------------------------------------------------
# The collective
# ---------------------------------------------------------------------------

def all_gather(mesh: ShardMesh, xs: Sequence[torch.Tensor]):
    """Every shard's tensor, stacked in global shard order, for each local
    shard: xs holds one tensor per local shard (one shape and dtype), and
    the result one (D, ...) tensor per local shard, on its device. Local
    shards on one device share the result (read-only). With a process
    group (across processes, or one process joined to one) the stack rides
    dist.all_gather_into_tensor on it (NCCL for CUDA tensors, gloo for CPU
    tensors), at fixed shapes."""
    local = torch.stack([x.to(mesh.devices[0]) for x in xs])
    if mesh.group is not None:
        local = _gather_across(local, mesh)
    return [local if d == local.device else local.to(d)
            for d in mesh.devices]


def _gather_across(x: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    flat = x.contiguous().reshape(-1)
    if flat.dtype not in _WIRE_DTYPES:
        flat = flat.view(torch.uint8)
    out = torch.empty((mesh.world * flat.numel(),), dtype=flat.dtype,
                      device=flat.device)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, flat, group=mesh.group)
    return out.view(x.dtype).reshape((mesh.world * x.shape[0],)
                                     + x.shape[1:])


def gather_cat(mesh: ShardMesh, xs: Sequence[torch.Tensor]):
    """all_gather with the shard axis folded into the first axis: every
    shard's (n, ...) tensor concatenated to (D * n, ...)."""
    return [t.reshape((-1,) + t.shape[2:]) for t in all_gather(mesh, xs)]


def _gather_jobs(mesh: ShardMesh, jobs: Sequence[carve_ops.JobBatch]):
    """Each local shard's concatenation of every shard's job batch."""
    fields = [gather_cat(mesh, [getattr(j, f) for j in jobs])
              for f in carve_ops.JOB_FIELDS]
    return [carve_ops.JobBatch(*(f[i] for f in fields))
            for i in range(mesh.n_local)]


def local_frames(frames: common.Frame, mesh: ShardMesh):
    """This process's frame batch (leading axis = local shard count) as one
    Frame per local shard, on its device."""
    if frames.depth.shape[0] != mesh.n_local:
        raise ValueError(f"{frames.depth.shape[0]} frames for "
                         f"{mesh.n_local} local shards")
    return [frames.at(i).to(d) for i, d in enumerate(mesh.devices)]


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------

def integrate_frames_sharded(sgrid: ShardedGrid, frames: common.Frame,
                             cfg: FusionConfig, intr: PinholeIntrinsics,
                             mesh: ShardMesh,
                             method: str = "fast") -> ShardedGrid:
    """One data-parallel step of a ray integrator, in place: this
    process's frames (leading axis = local shard count) into the shards.

    `method` "fast" or "merged". Each shard prepares its own frame
    (models/fast.py _frame_batches, or models/merged.py _frame_parts: its
    bundling reads nothing of the grid), the job batches are gathered, and
    each shard integrates the updates whose blocks it owns. Merged also
    gathers the sparse (bundle, label) votes, their ray indices offset by
    the source shard's place in the concatenated band stream, and under
    anti-grazing every frame's bundle destinations, masked per frame
    (integrate_jobs ag_frames). Merged needs a banded carve mode. Under
    carve_mode "projective" the dense free-space carve runs first as the
    ownership-filtered dense apply (_sharded_dense_apply), except for
    merged with anti-grazing, which keeps the decimated carve jobs."""
    if method not in ("fast", "merged"):
        raise ValueError(f"integrate_frames_sharded: method={method!r}")
    if method == "merged" and not (
            cfg.tsdf.carve_mode in ("decimated", "projective")
            and cfg.tsdf.voxel_carving_enabled):
        raise ValueError("sharded merged integration needs a banded carve "
                         "mode (decimated/projective)")
    D, R = mesh.size, cfg.pipeline.max_rays
    ag = cfg.tsdf.enable_anti_grazing
    ids = [mesh.shard_index(i) for i in range(mesh.n_local)]
    fs = local_frames(frames, mesh)
    if (cfg.tsdf.carve_mode == "projective"
            and cfg.tsdf.voxel_carving_enabled
            and not (method == "merged" and ag)):
        _sharded_dense_apply(sgrid, fs, cfg, intr, mesh, region="carve")

    if method == "merged":
        from ..models.merged import _frame_parts
        parts = []
        for i, f in enumerate(fs):
            grid, batches, sem, _, bdest, _ = _frame_parts(
                sgrid.shards[i], f, cfg, intr, apply_proj_carve=False)
            sgrid.shards[i] = grid
            parts.append((batches, sem, bdest))
        batches_g = _gather_batches(mesh, [p[0] for p in parts])
        sem_g = [gather_cat(mesh, [p[1][k] + ids[i] * R if k == 0
                                   else p[1][k]
                                   for i, p in enumerate(parts)])
                 for k in range(4)]
        dest_g = gather_cat(mesh, [p[2] for p in parts]) if ag else None
        for i in range(mesh.n_local):
            sgrid.shards[i] = integrate_jobs(
                sgrid.shards[i], cfg, batches_g[i], shard_id=ids[i],
                num_shards=D, sem_points=tuple(s[i] for s in sem_g),
                ag_dest_voxels=dest_g[i] if ag else None,
                ag_own_bundle=True, ag_frames=D if ag else 1)
        return sgrid

    from ..models.fast import _frame_batches
    per_shard = []
    for i, f in enumerate(fs):
        grid, batches, _ = _frame_batches(sgrid.shards[i], f, cfg, intr)
        sgrid.shards[i] = grid
        per_shard.append(batches)
    batches_g = _gather_batches(mesh, per_shard)
    for i in range(mesh.n_local):
        sgrid.shards[i] = integrate_jobs(sgrid.shards[i], cfg, batches_g[i],
                                         shard_id=ids[i], num_shards=D)
    return sgrid


def _gather_batches(mesh: ShardMesh, per_shard):
    """[(jobs, S), ...] of each local shard -> for each local shard the
    same kinds with every shard's jobs concatenated."""
    out = [[] for _ in range(mesh.n_local)]
    for k in range(len(per_shard[0])):
        S = per_shard[0][k][1]
        for i, jobs in enumerate(_gather_jobs(mesh, [b[k][0]
                                                     for b in per_shard])):
            out[i].append((jobs, S))
    return out


def integrate_frames_sharded_projective(sgrid: ShardedGrid,
                                        frames: common.Frame,
                                        cfg: FusionConfig,
                                        intr: PinholeIntrinsics,
                                        mesh: ShardMesh) -> ShardedGrid:
    """One data-parallel step of the projective integrator, in place: each
    shard builds its own frame's mip atlas and compact candidate keys, the
    atlases (or their u16 wire planes), poses and keys are gathered, and
    each shard inserts the keys it owns and applies every frame to its
    blocks (_sharded_dense_apply)."""
    return _sharded_dense_apply(sgrid, local_frames(frames, mesh), cfg,
                                intr, mesh, region="all")


def _sharded_dense_apply(sgrid: ShardedGrid, fs, cfg: FusionConfig,
                         intr: PinholeIntrinsics, mesh: ShardMesh,
                         region: str = "all") -> ShardedGrid:
    """Own-frame atlas and compact candidates, gathered, then per frame
    the ownership-filtered insert and the dense per-block apply (K2 and
    K3, or K4 and K5), the reference's kernel branch. Shared by the
    projective step and the ray steps' dense carve (region "carve").

    With PipelineConfig.wire_atlas "u16" the atlases travel as the wire
    planes (ops/mip.py wire_encode) and every shard, its own frame's
    included, decodes them: the step equals single-device integration of
    the decoded atlases."""
    from ..models import projective as proj_model
    D = mesh.size
    plan = proj_model.make_plan(cfg, intr)
    # A frame touches at most a few times the per-frame row budget of
    # distinct blocks; 4x leaves room for ownership imbalance.
    key_budget = 4 * cfg.pipeline.block_budget
    wire_u16 = cfg.pipeline.wire_atlas == "u16"
    own, keys, drops = [], [], []
    for f in fs:
        atlas = mip_ops.build_atlas(f.depth, f.labels, f.colors, plan)
        if wire_u16:
            atlas = mip_ops.wire_encode(atlas, cfg)
        own.append(atlas)
        dec = mip_ops.atlas_from_wire(atlas, cfg) if wire_u16 else atlas
        k, drop = bhash.unique_keys(*proj_model.candidates_from_atlas(
            dec, f.T_G_C, cfg, intr, plan), key_budget)
        keys.append(k)
        drops.append(drop)
    if wire_u16:
        planes = [all_gather(mesh, [w[p] for w in own])
                  for p in range(len(own[0]))]
        decoded = {}
        atlases = []
        for i in range(mesh.n_local):
            key = id(planes[0][i])
            if key not in decoded:   # shards on one device share the planes
                decoded[key] = torch.stack([
                    mip_ops.atlas_from_wire(tuple(p[i][f] for p in planes),
                                            cfg) for f in range(D)])
            atlases.append(decoded[key])
    else:
        atlases = all_gather(mesh, own)
    poses = all_gather(mesh, [f.T_G_C for f in fs])
    keys_all = all_gather(mesh, keys)
    for i in range(mesh.n_local):
        grid = sgrid.shards[i]
        grid.overflow = grid.overflow + drops[i].to(grid.overflow.device)
        my = mesh.shard_index(i)
        for f in range(D):
            k = keys_all[i][f]
            grid, fc, fsl, fr = proj_model.insert_candidates(
                grid, k, k != TRASH_KEY, cfg, shard=(my, D))
            grid = proj_model.apply_frame(grid, atlases[i][f], poses[i][f],
                                          fc, fsl, fr, cfg, intr, plan,
                                          region=region)
        sgrid.shards[i] = grid
    return sgrid


# ---------------------------------------------------------------------------
# Merging and mirroring
# ---------------------------------------------------------------------------

def _merged_cfg(cfg: FusionConfig, n: int) -> FusionConfig:
    return dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, block_capacity=cfg.grid.block_capacity * n))


def merge_shards(sgrid: ShardedGrid, cfg: FusionConfig):
    """The local shards merged into one VoxelGrid of capacity n x capacity
    on the first shard's device, for meshing and export. Ownership is
    disjoint, so merging re-inserts every shard's blocks and adds their
    rows. Returns (grid, merged FusionConfig)."""
    mcfg = _merged_cfg(cfg, len(sgrid))
    dev = sgrid.shards[0].wsum.device
    out = gblocks.create(mcfg, device=dev)
    for grid in sgrid:
        nb = int(grid.n_blocks)
        if nb == 0:
            continue
        coords = grid.block_coords[:nb].to(dev)
        out = gblocks.allocate_blocks(
            out, coords, torch.ones(nb, dtype=torch.bool, device=dev),
            mcfg.grid)
        slots = gblocks.lookup_slots(out, coords, mcfg.grid).long()
        for name in ("wsum", "wsdf", "sem_count"):
            getattr(out, name).index_add_(
                0, slots, getattr(grid, name)[:nb].to(dev))
        for name in ("wcolor", "sem_delta"):
            getattr(out, name).index_add_(
                1, slots, getattr(grid, name)[:, :nb].to(dev))
        out.updated[slots] = True
    return out, mcfg


class ShardMirror:
    """An incremental mirror of a sharded grid for meshing and export.

    Each sync fetches only the rows whose `updated` flag is set on their
    owning shard and replaces them in a grid of merged capacity: ownership
    is disjoint, so a row's whole state lives on one shard and replacing it
    is exact. Traffic per cycle scales with the updated blocks, not the
    grid. Rows move in fixed chunks of `chunk` rows."""

    def __init__(self, cfg: FusionConfig, n_shards: int, chunk: int = 512,
                 device="cuda"):
        self.d = n_shards
        self.cfg = _merged_cfg(cfg, n_shards)
        self.grid = gblocks.create(self.cfg, device=device)
        self.chunk = chunk

    def sync(self, sgrid: ShardedGrid, all_rows: bool = False):
        """Pull the updated (or, with all_rows, every allocated) rows of
        each local shard into the mirror and clear the shards' updated
        flags. Returns sgrid."""
        cap = self.cfg.grid.block_capacity // self.d
        for grid in sgrid:
            dev = grid.wsum.device
            sel = torch.arange(cap, device=dev) < grid.n_blocks
            if not all_rows:
                sel &= grid.updated[:cap]
            rows = torch.nonzero(sel).reshape(-1).to(torch.int32)
            for i in range(0, rows.numel(), self.chunk):
                part = rows[i:i + self.chunk]
                padded = torch.full((self.chunk,), cap, dtype=torch.int32,
                                    device=dev)
                padded[:part.numel()] = part
                real = torch.arange(self.chunk, device=dev) < part.numel()
                r = padded.long()
                self._apply(grid.block_coords[r.clamp(max=cap - 1)], real,
                            grid.wsum[r], grid.wsdf[r], grid.sem_count[r],
                            grid.wcolor[:, r], grid.sem_delta[:, r])
            grid.updated.zero_()
        return sgrid

    def _apply(self, coords, real, w, wsdf, semc, wcol, semd):
        g, mg = self.grid, self.cfg.grid
        dev = g.wsum.device
        coords, real = coords.to(dev), real.to(dev)
        gblocks.allocate_blocks(g, coords, real, mg)
        slots = gblocks.lookup_slots(g, coords, mg)
        ok = real & (slots < mg.block_capacity)
        s = slots[ok].long()
        g.wsum[s] = w.to(dev)[ok]
        g.wsdf[s] = wsdf.to(dev)[ok]
        g.sem_count[s] = semc.to(dev)[ok]
        g.wcolor[:, s] = wcol.to(dev)[:, ok]
        g.sem_delta[:, s] = semd.to(dev)[:, ok]
        g.updated[s] = True

    def clear_updated(self):
        self.grid.updated.zero_()
