"""Frame providers.

Counterpart: kimera_semantics_tpu/io/dataset.py (SyntheticDataset,
DirectoryDataset, save_directory_dataset):

  - SyntheticDataset: frames rendered from the analytic sim world on an
    orbit, the data source of the benchmark and of chip_smoke.py;
  - DirectoryDataset: a directory of frame_*.npz files (depth, labels or
    colors, T_G_C) with an intrinsics.npz, the offline "bag" format.
    `host_frames()` decodes to numpy (on a prefetch thread) and `to_frame`
    moves a decoded frame to the device (in the consuming thread).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..core.camera import PinholeIntrinsics
from ..core.color import LabelColorMap
from ..device import resolve
from ..models.common import Frame, frame_from_images
from ..sim import render as sim_render
from ..sim import world as sim_world


class SyntheticDataset:
    """Orbit-camera sweep of the eval world, rendered on `device`."""

    def __init__(self, num_frames: int = 50,
                 intr: Optional[PinholeIntrinsics] = None,
                 world: Optional[sim_world.World] = None,
                 label_map: Optional[LabelColorMap] = None,
                 radius: float = 3.2, height: float = 2.2, device="cuda"):
        self.device = resolve(device)
        self.num_frames = num_frames
        self.intr = intr or PinholeIntrinsics(fx=160.0, fy=160.0, cx=159.5,
                                              cy=119.5, width=320, height=240)
        self.world = (world if world is not None
                      else sim_world.default_eval_world()).to(self.device)
        self.label_map = label_map or LabelColorMap.random()
        self.radius = radius
        self.height = height

    def __len__(self):
        return self.num_frames

    def pose(self, i: int) -> np.ndarray:
        angle = 2.0 * np.pi * i / max(self.num_frames, 1)
        return sim_render.orbit_pose(angle, radius=self.radius,
                                     height=self.height)

    def frame(self, i: int) -> Frame:
        T = torch.as_tensor(self.pose(i), device=self.device)
        depth, labels = sim_render.render_depth_labels(self.world, T,
                                                       self.intr)
        colors = self.label_map.colors_from_labels(labels)
        return Frame(depth=depth, labels=labels.to(torch.int32),
                     colors=colors.to(torch.float32), T_G_C=T)

    def __iter__(self) -> Iterator[Frame]:
        for i in range(self.num_frames):
            yield self.frame(i)


class DirectoryDataset:
    """Loads frame_*.npz files: depth (H,W) f32, labels (H,W) i32 or
    colors (H,W,3) u8, T_G_C (4,4) f32; intrinsics.npz holds fx, fy, cx,
    cy, width, height. Frames go to `device`."""

    def __init__(self, path: str, label_map: Optional[LabelColorMap] = None,
                 device="cuda"):
        self.path = path
        self.device = resolve(device)
        self.label_map = label_map or LabelColorMap.random()
        meta = np.load(os.path.join(path, "intrinsics.npz"))
        self.intr = PinholeIntrinsics(
            fx=float(meta["fx"]), fy=float(meta["fy"]), cx=float(meta["cx"]),
            cy=float(meta["cy"]), width=int(meta["width"]),
            height=int(meta["height"]))
        self.files: List[str] = sorted(
            f for f in os.listdir(path) if f.startswith("frame_")
            and f.endswith(".npz"))
        if not self.files:
            raise ValueError(f"{path}: no frame_*.npz files")
        # Stream-consistency check (rosbag_data_provider.cpp:178-190): every
        # frame must carry the full synchronized tuple.
        probe = np.load(os.path.join(path, self.files[0]))
        if "depth" not in probe or "T_G_C" not in probe:
            raise ValueError(f"{path}: frames need depth + T_G_C")
        if "labels" not in probe and "colors" not in probe:
            raise ValueError(f"{path}: frames need labels or colors")

    def __len__(self):
        return len(self.files)

    def host_frame(self, i: int) -> dict:
        """Frame i decoded to numpy arrays (no device work)."""
        data = np.load(os.path.join(self.path, self.files[i]))
        return {k: data[k] for k in ("depth", "labels", "colors", "T_G_C")
                if k in data}

    def to_frame(self, arrays: dict) -> Frame:
        return frame_from_images(
            depth=arrays["depth"], intr=self.intr, label_map=self.label_map,
            labels=arrays.get("labels"), colors=arrays.get("colors"),
            T_G_C=arrays["T_G_C"], device=self.device)

    def frame(self, i: int) -> Frame:
        return self.to_frame(self.host_frame(i))

    def host_frames(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self.host_frame(i)

    def __iter__(self) -> Iterator[Frame]:
        for i in range(len(self)):
            yield self.frame(i)


def save_directory_dataset(path: str, dataset,
                           num_frames: Optional[int] = None):
    """Materialize any dataset to the directory format (writes fixtures)."""
    os.makedirs(path, exist_ok=True)
    intr = dataset.intr
    np.savez(os.path.join(path, "intrinsics.npz"),
             fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
             width=intr.width, height=intr.height)
    n = num_frames if num_frames is not None else len(dataset)
    host = lambda x: x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)  # noqa: E731
    for i in range(n):
        f = dataset.frame(i)
        np.savez(os.path.join(path, f"frame_{i:05d}.npz"),
                 depth=host(f.depth), labels=host(f.labels),
                 T_G_C=host(f.T_G_C))
