"""Multi-process bring-up and streaming over the sharded grid.

Counterpart: kimera_semantics_tpu/parallel/multihost.py (initialize,
local_batch_to_global, MultiHostPipeline). Each process ingests its own
frame stream, one frame per local shard and step; the steps' gathers
(parallel/sharding.py all_gather) are the only communication between
processes, since block ownership is hash-partitioned. torch.distributed is
told its address, world size and rank explicitly.
"""

from __future__ import annotations

from functools import partial
from typing import Iterable, Optional

import torch.distributed as dist

from ..config import FusionConfig
from ..core.camera import PinholeIntrinsics
from ..models.common import Frame
from . import sharding


def initialize(backend: str, init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> None:
    """dist.init_process_group (a no-op for a single process).
    `backend` is "nccl" for CUDA shards or "gloo" for CPU shards;
    `init_method` e.g. "tcp://127.0.0.1:<port>"."""
    if world_size is None or world_size <= 1:
        return
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def local_batch_to_global(frames: Frame, mesh: sharding.ShardMesh):
    """This process's frame batch (leading axis = local shard count) as one
    Frame per local shard, on its device; the global batch is every
    process's batch in rank order, which the steps' gathers assemble."""
    return sharding.local_frames(frames, mesh)


class MultiHostPipeline:
    """Continuous ingestion: every step consumes one frame per shard
    globally, integrates it into the sharded grid and, on request, meshes
    the blocks updated since the last mesh."""

    def __init__(self, cfg: FusionConfig, intr: PinholeIntrinsics,
                 mesh: Optional[sharding.ShardMesh] = None,
                 method: str = "fast", label_map=None):
        if method not in ("fast", "merged", "projective"):
            raise ValueError(f"unknown sharded method {method!r}")
        self.cfg = cfg
        self.intr = intr
        self.label_map = label_map
        self.mesh = mesh if mesh is not None else sharding.make_mesh()
        self.sgrid = sharding.create_sharded(cfg, self.mesh)
        self.steps = 0
        if method == "projective":
            self._step_fn = sharding.integrate_frames_sharded_projective
        else:
            self._step_fn = partial(sharding.integrate_frames_sharded,
                                    method=method)
        self.mirror = None      # made on the first mesh update
        self.mesh_cache = None

    @property
    def frames_per_step(self) -> int:
        """Frames this process contributes per step: its local shards."""
        return self.mesh.n_local

    def step(self, local_frames: Frame):
        """local_frames: leading axis = local shard count."""
        self.sgrid = self._step_fn(self.sgrid, local_frames, self.cfg,
                                   self.intr, self.mesh)
        self.steps += 1
        return self.sgrid

    def run(self, frame_iter: Iterable[Frame],
            max_steps: Optional[int] = None):
        batch = []
        for f in frame_iter:
            batch.append(f.to(self.mesh.devices[0]))
            if len(batch) == self.frames_per_step:
                self.step(Frame.stack(batch))
                batch = []
                if max_steps is not None and self.steps >= max_steps:
                    break
        return self.sgrid

    def merged_grid(self):
        """The local shards merged at once (one-shot export)."""
        return sharding.merge_shards(self.sgrid, self.cfg)

    def _ensure_mirror(self):
        if self.mirror is None:
            from ..server import viz
            self.mirror = sharding.ShardMirror(
                self.cfg, self.mesh.n_local, device=self.mesh.devices[0])
            self.mesh_cache = viz.MeshLayerCache()

    def update_mesh(self):
        """Incremental mesh cycle: sync the shard rows updated since the
        last call into the mirror, re-mesh exactly those blocks and replace
        them in the MeshLayerCache. Returns the whole growing Mesh."""
        from ..ops import mesh as mesh_ops
        self._ensure_mirror()
        self.sgrid = self.mirror.sync(self.sgrid)
        m, meshed_rows, tri_rows = mesh_ops.extract_mesh(
            self.mirror.grid, self.mirror.cfg, self.label_map,
            only_updated=True, return_blocks=True)
        self.mesh_cache.update(m, meshed_rows, tri_rows)
        self.mirror.clear_updated()
        return self.mesh_cache.full_mesh()

    def full_grid(self):
        """Every allocated row synced into the mirror (final export).
        Returns (VoxelGrid, merged FusionConfig)."""
        self._ensure_mirror()
        self.sgrid = self.mirror.sync(self.sgrid, all_rows=True)
        return self.mirror.grid, self.mirror.cfg
