"""Frame providers.

Counterpart: kimera_semantics_tpu/io/dataset.py (SyntheticDataset): frames
rendered from the analytic sim world on an orbit, the data source of the
benchmark and of chip_smoke.py.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from ..core.camera import PinholeIntrinsics
from ..core.color import LabelColorMap
from ..device import resolve
from ..models.common import Frame
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
