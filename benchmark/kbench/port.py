"""The system under test: the port's server, built from a configuration
file, and the loops that hand it frames.

Everything the port runs goes through `SemanticTsdfServer`: `run` (the
offline replay, `kimera_semantics_rosbag`'s loop, frames decoded on its
prefetch thread) or `insert_frame` (the live node, with the pipelined mesh
cycle). A frame reaches the port as a camera delivers it: host arrays of
depth, labels, colours and the pose. The port's own handling starts there,
with `models/common.py frame_from_images`, which uploads them.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function


def fusion_config(conf: dict):
    """The port's FusionConfig of a configuration file."""
    from kimera_semantics_tpu_torch.config import (
        ColorMode, FusionConfig, GridConfig, IntegratorType, PipelineConfig,
        SemanticConfig, TsdfConfig)
    fu, bu = conf["fusion"], conf["budgets"]
    svps, vps = fu["storage_voxels_per_side"], fu["voxels_per_side"]
    return FusionConfig(
        grid=GridConfig(voxel_size=fu["voxel_size"], voxels_per_side=svps,
                        io_voxels_per_side=vps if vps != svps else 0,
                        block_capacity=bu["storage_block_capacity"],
                        num_labels=fu["num_labels"],
                        world_extent_blocks=fu["world_extent_blocks"]),
        tsdf=TsdfConfig(
            truncation_distance=fu["truncation_distance"],
            max_ray_length_m=fu["max_ray_length_m"],
            min_ray_length_m=fu["min_ray_length_m"],
            use_const_weight=fu["use_const_weight"],
            use_weight_dropoff=fu["use_weight_dropoff"],
            voxel_carving_enabled=fu["voxel_carving_enabled"],
            allow_clear=fu["allow_clear"],
            start_voxel_subsampling_factor=fu[
                "start_voxel_subsampling_factor"],
            carve_mode=fu["carve_mode"], band_density=fu["band_density"]),
        semantic=SemanticConfig(
            semantic_measurement_probability=fu["measurement_probability"],
            color_mode=ColorMode(fu["color_mode"]),
            dynamic_labels=tuple(fu["dynamic_labels"])),
        pipeline=PipelineConfig(
            max_rays=bu["max_rays"], segment_budget=bu["segment_budget"],
            block_budget=bu["block_budget"],
            carve_budget=bu["carve_budget"], carve_steps=bu["carve_steps"],
            carve_gamma=bu["carve_gamma"], carve_k_max=bu["carve_k_max"],
            stream_active_fraction=bu["stream_active_fraction"],
            sem_stage_ranks=bu["sem_stage_ranks"],
            band_steps=bu.get("band_steps")),
        integrator=IntegratorType(fu["method"]))


def build_server(conf: dict, traffic: dict, colors: np.ndarray, device):
    """A SemanticTsdfServer of the configuration, for the traffic mix."""
    from kimera_semantics_tpu_torch.core.camera import PinholeIntrinsics
    from kimera_semantics_tpu_torch.core.color import LabelColorMap
    from kimera_semantics_tpu_torch.server.pipeline import (
        SemanticTsdfServer, ServerConfig)
    cam = conf["camera"]
    intr = PinholeIntrinsics(fx=cam["fx"], fy=cam["fy"], cx=cam["cx"],
                             cy=cam["cy"], width=cam["width"],
                             height=cam["height"])
    pairs = {lab: tuple(int(v) for v in colors[lab])
             for lab in range(len(colors))}
    lmap = LabelColorMap.from_pairs(pairs, {c: lab for lab, c in
                                            pairs.items()},
                                    conf["fusion"]["num_labels"])
    sc = ServerConfig(mesh_every_n_frames=traffic["mesh_every_n_frames"],
                      async_mesh=True,
                      prefetch_depth=traffic["prefetch_depth"])
    return SemanticTsdfServer(fusion_config(conf), intr, lmap, sc,
                              device=device)


def counters(srv):
    """(overflow, dropped_rays) of the server's grid (a host sync)."""
    return int(srv.grid.overflow), int(srv.grid.dropped_rays)


class Feed:
    """The trajectory's frames handed to the port in a closed loop, as a
    camera delivers them. Counts how often each trajectory frame went in
    and stamps each hand-over on the host clock."""

    def __init__(self, frames, device):
        from kimera_semantics_tpu_torch.models.common import frame_from_images
        self.frames = frames
        self.device = device
        self.next = 0
        self.order = []
        self.stamps = []
        self._upload = frame_from_images

    def take(self):
        """(index, host frame) of the next frame of the loop."""
        i = self.next % len(self.frames)
        self.next += 1
        return i, self.frames[i]

    def to_frame(self, item):
        """The port's upload of a delivered frame."""
        i, h = item
        self.stamps.append(time.perf_counter())
        self.order.append(i)
        with record_function("upload (frame_from_images)"):
            return self._upload(depth=h["depth"], labels=h["labels"],
                                colors=h["colors"], T_G_C=h["T_G_C"],
                                device=self.device)


class _Replay:
    """A dataset for SemanticTsdfServer.run: the loop's host frames,
    produced on the server's prefetch thread until `stop()` holds."""

    def __init__(self, feed: Feed, stop):
        self.feed, self.stop = feed, stop

    def host_frames(self):
        while not self.stop():
            yield self.feed.take()

    def to_frame(self, item):
        return self.feed.to_frame(item)


def drive(srv, feed: Feed, traffic: dict, seconds=None, frames=None):
    """Hand the port frames for `seconds` on the host clock, or `frames`
    frames, through the traffic's entry point. Returns the host seconds
    from the first hand-over to the last frame's end (and, in the stream,
    the last mesh cycle's landing)."""
    start = len(feed.order)
    t0 = time.perf_counter()
    if frames is not None:
        n0 = feed.next
        stop = lambda: feed.next - n0 >= frames  # noqa: E731
    else:
        t_end = t0 + seconds
        stop = lambda: time.perf_counter() >= t_end  # noqa: E731
    if traffic["entry"] == "run":
        srv.run(_Replay(feed, stop))
    elif traffic["entry"] == "insert_frame":
        while not stop():
            srv.insert_frame(feed.to_frame(feed.take()))
        srv.join_mesh()
    else:
        raise ValueError(f"unknown entry {traffic['entry']!r}")
    if srv.device.type == "cuda":
        torch.cuda.synchronize(srv.device)
    t1 = time.perf_counter()
    return t1 - t0, t1, len(feed.order) - start


def frame_times(stamps, t_end):
    """Seconds of each frame: hand-over to the next hand-over, the last to
    the end of the window."""
    s = list(stamps) + [t_end]
    return [b - a for a, b in zip(s[:-1], s[1:])]


def output(srv) -> dict:
    """The port's fused grid as the check reads it: the allocated blocks'
    storage coordinates and their rows of every channel (copies), and the
    counters."""
    g = srv.grid
    nb = int(g.n_blocks)
    return dict(blocks=g.block_coords[:nb].to(torch.int64).clone(),
                wsum=g.wsum[:nb].clone(), wsdf=g.wsdf[:nb].clone(),
                sem_count=g.sem_count[:nb].clone(),
                sem_delta=g.sem_delta[:, :nb].clone(),
                wcolor=g.wcolor[:, :nb].clone(),
                overflow=int(g.overflow), dropped_rays=int(g.dropped_rays))
