"""SemanticTsdfServer equivalent: the streaming fusion pipeline.

Counterpart: kimera_semantics_tpu/server/pipeline.py (ServerConfig,
SemanticTsdfServer). A frame loop without ROS, with
  - message throttling (`min_time_between_msgs_sec`, TsdfServer behavior),
  - scan-to-map ICP before integration (`enable_icp`, ops/icp.py),
  - integrator dispatch via the factory,
  - periodic incremental mesh updates, synchronous or pipelined (the cycle
    is dispatched on the stream and collected on a worker thread),
  - periodic ESDF refreshes (`esdf_every_n_frames`, ops/esdf.py),
  - mesh generation + PLY save, map save/load, pointcloud outputs,
  - per-phase timing (utils/timing.py).

The grid lives on `device` (the card unless the caller asks for the CPU)
and the integrators update it IN PLACE. A pipelined mesh cycle has
enqueued all its reads of the grid before `updated` is cleared and the
next frame is integrated, so stream order keeps it on the grid as it was
at dispatch.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import sys
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import FusionConfig
from ..core.camera import PinholeIntrinsics
from ..core.color import LabelColorMap
from ..device import resolve
from ..grid import blocks as gblocks
from ..io import ply as ply_io
from ..io import serial as serial_io
from ..io.prefetch import prefetch
from ..models import factory
from ..models.common import Frame
from ..ops import mesh as mesh_ops
from ..utils import timing

@dataclasses.dataclass
class ServerConfig:
    mesh_every_n_frames: int = 0      # 0 = no periodic meshing
    min_frame_interval: float = 0.0   # seconds of *stream time* between frames
    mesh_filename: str = ""
    mesh_connected: bool = False      # vertex-deduplicated meshes on
                                      # generate_mesh outputs
    mesh_normals: bool = False        # per-vertex TSDF-gradient normals
    enable_icp: bool = False          # scan-to-map pose refinement
    icp_iters: int = 6
    icp_subsample: int = 16
    icp_refine_roll_pitch: bool = True
    icp_damping: float = 1e-3
    icp_min_match_ratio: float = 0.1
    prefetch_depth: int = 2           # frames decoded ahead of the device by
                                      # a producer thread (0 = synchronous)
    esdf_max_dist: float = 4.0
    esdf_every_n_frames: int = 0      # periodic ESDF refresh
    log_every_n_frames: int = 0       # progress lines to stderr (0 = quiet)
    stats_jsonl: str = ""             # one JSON metrics line per frame
    live_mesh_path: str = ""          # rewrite this PLY with the full mesh
                                      # at each periodic mesh update
    live_mesh_keep: int = 0           # also keep N rotating snapshots
    live_mesh_port: int = -1          # >=0: serve the live mesh over HTTP
                                      # (0 picks a free port; server/viz.py)
    async_mesh: bool = True           # pipelined periodic meshing: the
                                      # cycle is dispatched inline and
                                      # collected/published on a worker
                                      # thread; a cycle still in flight when
                                      # the next is due stalls the stream
                                      # (counted in mesh_stall_s)


class SemanticTsdfServer:
    def __init__(self, cfg: FusionConfig, intr: PinholeIntrinsics,
                 label_map: Optional[LabelColorMap] = None,
                 server_cfg: Optional[ServerConfig] = None, device="cuda"):
        self.cfg = cfg
        self.intr = intr
        self.device = resolve(device)
        self.label_map = label_map or LabelColorMap.random(cfg.grid.num_labels)
        self.server_cfg = sc = server_cfg or ServerConfig()
        self.integrator = factory.create(cfg.integrator, cfg, intr,
                                         device=self.device)
        self.grid = gblocks.create(cfg, device=self.device)
        self._frames_integrated = 0
        self._last_stream_time = -np.inf
        self.esdf = None              # latest periodic ESDF (EsdfBlocked)
        self.last_icp_match_ratio = None  # fraction of points on observed
                                          # in-band TSDF at the last ICP
                                          # (a device tensor)
        self.mesh_callbacks: List[Callable[[mesh_ops.Mesh], None]] = []
        self.mesh_cache = None
        self._live_writer = None
        self.live_streamer = None
        self._mesh_worker = None      # in-flight pipelined mesh cycle
        self._mesh_retry_updated = None
        self._mesh_fetch_hint = 4096
        self._mesh_page_hint = 256
        self.mesh_stall_s = 0.0       # stream time spent waiting on a cycle
                                      # still in flight when the next was due
        self.mesh_cycles = 0          # pipelined cycles dispatched
        self.mesh_cycle_s = []        # dispatch -> collected, per cycle
        if sc.live_mesh_path or sc.live_mesh_port >= 0:
            from . import viz
            self.mesh_cache = viz.MeshLayerCache()
            if sc.live_mesh_path:
                self._live_writer = viz.LiveMeshWriter(sc.live_mesh_path,
                                                       keep=sc.live_mesh_keep)
            if sc.live_mesh_port >= 0:
                self.live_streamer = viz.MeshHTTPStreamer(sc.live_mesh_port)

    # -- streaming ---------------------------------------------------------

    def insert_frame(self, frame: Frame, stream_time: Optional[float] = None
                     ) -> bool:
        """Integrate one frame; returns False if throttled
        (min_time_between_msgs_sec behavior)."""
        if (stream_time is not None and
                stream_time - self._last_stream_time <
                self.server_cfg.min_frame_interval):
            return False
        if stream_time is not None:
            self._last_stream_time = stream_time
        if self.server_cfg.enable_icp and self._frames_integrated > 0:
            frame = self._refine_pose(frame)
        t = timing.Timer(f"integrate/{self.cfg.integrator.value}")
        self.grid = self.integrator.integrate(self.grid, frame)
        t.stop(sync=self.grid.wsum)
        self._frames_integrated += 1
        n = self.server_cfg.mesh_every_n_frames
        if n and self._frames_integrated % n == 0:
            if self.server_cfg.async_mesh:
                self.update_mesh_async()
            else:
                self.update_mesh()
        ne = self.server_cfg.esdf_every_n_frames
        if ne and self._frames_integrated % ne == 0:
            self.update_esdf()
        return True

    def run(self, dataset, max_frames: Optional[int] = None) -> int:
        """Batch mode, the kimera_semantics_rosbag main loop. Frames decode
        on a prefetch thread (io/prefetch.py); a dataset with
        `host_frames()` decodes to numpy there and moves each frame to the
        device here."""
        count = 0
        n = len(dataset) if hasattr(dataset, "__len__") else None
        total = (min(n, max_frames) if (n is not None and max_frames)
                 else (n if n is not None else (max_frames or "?")))
        log_n = self.server_cfg.log_every_n_frames
        sink = (open(self.server_cfg.stats_jsonl, "w")
                if self.server_cfg.stats_jsonl else None)
        host = hasattr(dataset, "host_frames")
        source = dataset.host_frames() if host else iter(dataset)
        t0 = time.perf_counter()
        try:
            stream = itertools.islice(source, max_frames)
            for item in prefetch(stream, self.server_cfg.prefetch_depth,
                                 device=None if host else self.device):
                self.insert_frame(dataset.to_frame(item) if host else item)
                count += 1
                if log_n and count % log_n == 0:
                    print(f"Integrating frame {count}/{total} "
                          f"(blocks={int(self.grid.n_blocks)}, "
                          f"{count / (time.perf_counter() - t0):.1f} fps)",
                          file=sys.stderr)
                if sink is not None:
                    sink.write(json.dumps({
                        "frame": count,
                        "t_wall_s": round(time.perf_counter() - t0, 4),
                        "blocks": int(self.grid.n_blocks),
                        "overflow": int(self.grid.overflow),
                        "dropped_rays": int(self.grid.dropped_rays)}) + "\n")
        finally:
            self.join_mesh()
            if self._mesh_retry_updated is not None:
                # The stream's last pipelined cycle failed: complete it
                # synchronously so the live mesh does not end stale.
                self.update_mesh()
            if sink is not None:
                sink.close()
        return count

    def _refine_pose(self, frame: Frame) -> Frame:
        """Scan-to-map TSDF alignment (ops/icp.py), voxblox enable_icp."""
        from ..core import camera as cam
        from ..ops import icp as icp_ops
        sc = self.server_cfg
        with timing.Timer("icp/align"):
            pts_C, valid = cam.backproject(frame.depth, self.intr)
            stride = max(1, sc.icp_subsample)
            pts_C, valid = pts_C[::stride], valid[::stride]
            T, _, self.last_icp_match_ratio = icp_ops.align_to_map(
                self.grid, self.cfg, pts_C, valid, frame.T_G_C,
                iters=sc.icp_iters, damping=sc.icp_damping,
                refine_roll_pitch=sc.icp_refine_roll_pitch,
                min_match_ratio=sc.icp_min_match_ratio)
        return dataclasses.replace(frame, T_G_C=T)

    # -- meshing / output --------------------------------------------------

    def _take_retry(self):
        """Fold the blocks of a failed pipelined cycle back into `updated`
        (their flags were cleared at its dispatch)."""
        retry, self._mesh_retry_updated = self._mesh_retry_updated, None
        if retry is not None:
            self.grid.updated |= retry

    def update_mesh(self) -> mesh_ops.Mesh:
        """Incremental mesh over blocks updated since the last call
        (synchronous)."""
        self.join_mesh()
        self._take_retry()
        with timing.Timer("mesh/update"):
            out = mesh_ops.extract_mesh(
                self.grid, self.cfg, self.label_map, only_updated=True,
                with_normals=self.server_cfg.mesh_normals,
                return_blocks=self.mesh_cache is not None)
        self.grid.updated.zero_()
        return self._publish_mesh(out)

    def update_mesh_async(self) -> None:
        """Pipelined incremental mesh: dispatch the cycle against the
        current grid, clear the updated flags, and collect/publish on a
        worker thread while the next frames integrate. A cycle still in
        flight when the next is due stalls the stream (mesh_stall_s)."""
        t0 = time.perf_counter()
        self.join_mesh()                       # previous cycle must land
        self.mesh_stall_s += time.perf_counter() - t0
        if self._mesh_retry_updated is not None:
            # The previous cycle could not complete without the grid
            # (budget overflow or more blocks than a page): its blocks
            # rejoin this cycle, meshed synchronously.
            self.update_mesh()
            return
        t_dispatch = time.perf_counter()
        old_updated = self.grid.updated.clone()
        collect = mesh_ops.extract_mesh_cycle_async(
            self.grid, self.cfg, self.label_map, only_updated=True,
            with_normals=self.server_cfg.mesh_normals,
            return_blocks=self.mesh_cache is not None,
            hint_rows=self._mesh_fetch_hint, hold_grid=False,
            page_blocks=self._mesh_page_hint)
        self.grid.updated.zero_()
        self.mesh_cycles += 1

        def work():
            out = collect()
            if out is None:
                self._mesh_retry_updated = old_updated
                self._mesh_page_hint += 256   # grow the page for the retry
                return
            self._publish_mesh(out)
            self.mesh_cycle_s.append(time.perf_counter() - t_dispatch)
            self._mesh_fetch_hint = getattr(collect, "total_rows", 4096)
            if self.mesh_cache is not None:
                nblk = len(out[1])
                self._mesh_page_hint = max(
                    256, -(-int(nblk * 1.3) // 256) * 256)

        self._mesh_worker = threading.Thread(target=work, daemon=True)
        self._mesh_worker.start()

    def join_mesh(self):
        """Block until the in-flight pipelined mesh cycle (if any) lands."""
        w = self._mesh_worker
        if w is not None:
            w.join()
            self._mesh_worker = None

    def _publish_mesh(self, out) -> mesh_ops.Mesh:
        if self.mesh_cache is not None:
            m, meshed_rows, tri_rows = out
            self.mesh_cache.update(m, meshed_rows, tri_rows)
            full = self.mesh_cache.full_mesh()
            if self._live_writer is not None:
                self._live_writer.write(full)
            if self.live_streamer is not None:
                self.live_streamer.publish(
                    full, version=self.mesh_cache.version,
                    blocks=self.mesh_cache.num_blocks,
                    frames=self._frames_integrated)
        else:
            m = out
        for cb in self.mesh_callbacks:
            cb(m)
        return m

    def update_esdf(self):
        """Refresh the ESDF from the current TSDF state (the EsdfServer
        update cycle): a full block-sparse jump-flooding pass over the
        allocated blocks (ops/esdf.py)."""
        from ..ops import esdf as esdf_ops
        with timing.Timer("esdf/update"):
            self.esdf = esdf_ops.compute_esdf_blocked(
                self.grid, self.cfg, max_dist=self.server_cfg.esdf_max_dist)
        return self.esdf

    def generate_mesh(self, path: Optional[str] = None) -> mesh_ops.Mesh:
        """Full mesh over all allocated blocks (+ optional PLY save),
        TsdfServer::generateMesh."""
        self.join_mesh()
        with timing.Timer("mesh/generate"):
            m = mesh_ops.extract_mesh(self.grid, self.cfg, self.label_map,
                                      only_updated=False,
                                      with_normals=self.server_cfg.mesh_normals)
            if self.server_cfg.mesh_connected:
                m = mesh_ops.connect_mesh(m, self.cfg.grid.voxel_size)
        path = path or self.server_cfg.mesh_filename
        if path:
            ply_io.write_ply(path, m.vertices, m.colors, m.triangles,
                             normals=m.normals)
        return m

    # -- pointcloud outputs (TsdfServer publishPointclouds parity) ----------

    def _voxel_centers(self, slot_idx: np.ndarray, lin_idx: np.ndarray
                       ) -> np.ndarray:
        """World-space centers for (slot, linear-voxel) index pairs."""
        g = self.cfg.grid
        V = g.voxels_per_side
        bc = self.grid.block_coords.cpu().numpy()[slot_idx]
        local = np.stack([lin_idx // (V * V), (lin_idx // V) % V,
                          lin_idx % V], axis=-1)
        return gblocks.voxel_center(torch.as_tensor(bc * V + local),
                                    g.voxel_size).numpy()

    def _observed(self):
        cap = self.cfg.grid.block_capacity
        nb = int(self.grid.n_blocks)
        w = self.grid.wsum[:cap].cpu().numpy().copy()
        w[nb:] = 0.0
        d = gblocks.tsdf_distance(
            self.grid, self.cfg.tsdf.truncation_distance)[:cap].cpu().numpy()
        return w, d

    def surface_pointcloud(self, thresh: Optional[float] = None):
        """(points (N,3), colors (N,3) u8) of near-surface observed voxels,
        the reference's `surface_pointcloud` topic."""
        g = self.cfg.grid
        thresh = g.voxel_size * 0.75 if thresh is None else thresh
        w, d = self._observed()
        slot, lin = np.nonzero((w > 1e-6) & (np.abs(d) < thresh))
        flat = torch.as_tensor(slot.astype(np.int64) * g.vps3 + lin,
                               device=self.device)
        table = mesh_ops._label_table(self.cfg, self.label_map, self.device)
        cols = mesh_ops.voxel_colors(self.grid, self.cfg, table,
                                     flat).cpu().numpy()
        return (self._voxel_centers(slot, lin),
                np.clip(cols, 0, 255).astype(np.uint8))

    def tsdf_pointcloud(self):
        """(points (N,3), distances (N,)) for every observed voxel."""
        w, d = self._observed()
        slot, lin = np.nonzero(w > 1e-6)
        return self._voxel_centers(slot, lin), d[slot, lin]

    def freespace_pointcloud(self, min_distance: Optional[float] = None):
        """(points (N,3),) of confidently-free observed voxels, the
        `freespace_pointcloud` topic."""
        t = self.cfg.tsdf.truncation_distance
        min_distance = t * 0.95 if min_distance is None else min_distance
        w, d = self._observed()
        slot, lin = np.nonzero((w > 1e-6) & (d >= min_distance))
        return self._voxel_centers(slot, lin)

    # -- checkpointing -----------------------------------------------------

    def save_map(self, path: str, esdf=None):
        """saveMap. A `.vxblx` extension selects the voxblox-compatible wire
        format: the TSDF layer, and given `esdf` the ESDF layer after it
        (the reference's tsdf_esdf.vxblx); any other the KSDV container,
        which also round-trips the semantic channels."""
        self.join_mesh()
        if path.endswith(".vxblx"):
            from ..io import vxblx as vxblx_io
            vxblx_io.save_vxblx(path, self.grid, self.cfg, esdf=esdf)
        else:
            serial_io.save_grid(path, self.grid)

    def load_map(self, path: str):
        self.join_mesh()
        if path.endswith(".vxblx"):
            from ..io import vxblx as vxblx_io
            self.grid = vxblx_io.load_vxblx(path, self.cfg,
                                            device=self.device)
        else:
            self.grid = serial_io.load_grid(path, self.cfg,
                                            device=self.device)

    # -- stats -------------------------------------------------------------

    @property
    def num_blocks(self) -> int:
        return int(self.grid.n_blocks)

    def stats(self) -> dict:
        self.join_mesh()    # mesh_cache readers see the landed cycle
        nb = int(self.grid.n_blocks)
        return {
            "frames": self._frames_integrated,
            "blocks": nb,
            "overflow": int(self.grid.overflow),
            "dropped_rays": int(self.grid.dropped_rays),
            # allocated rows only: the trash tile is never read
            "observed_voxels": int((self.grid.wsum[:nb] > 0).sum()),
        }
