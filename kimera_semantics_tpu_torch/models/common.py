"""Shared frame-level plumbing for the integrators.

Counterpart: kimera_semantics_tpu/models/common.py (Frame,
frame_from_images, prepare_points, gather_packed, compact). A Frame is a
dataclass of tensors on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import camera as cam
from ..core import transforms
from ..core.color import LabelColorMap
from ..device import resolve
from ..ops import semantic as sem_ops
from ..ops import tsdf as tsdf_ops
from ..ops.reduce import stable_compact_order
from ..utils import timing


@dataclasses.dataclass(frozen=True)
class Frame:
    """One (depth, semantics, pose) input tuple."""

    depth: torch.Tensor      # (H, W) float32 meters
    labels: torch.Tensor     # (H, W) int32
    colors: torch.Tensor     # (H, W, 3) float32 [0, 255]
    T_G_C: torch.Tensor      # (4, 4) float32

    # A batch of frames is a Frame whose tensors carry a leading axis.

    @staticmethod
    def stack(frames) -> "Frame":
        return Frame(*(torch.stack([getattr(f, n) for f in frames])
                       for n in FRAME_FIELDS))

    def at(self, b: int) -> "Frame":
        """Frame `b` of a batch."""
        return Frame(*(getattr(self, n)[b] for n in FRAME_FIELDS))

    def to(self, device) -> "Frame":
        return Frame(*(getattr(self, n).to(device) for n in FRAME_FIELDS))


FRAME_FIELDS = ("depth", "labels", "colors", "T_G_C")


def _host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def frame_from_images(depth, intr=None,
                      label_map: Optional[LabelColorMap] = None,
                      labels=None, colors=None, T_G_C=None,
                      device="cuda") -> Frame:
    """Build a Frame on `device`, deriving labels from colors (label-map
    lookup) or colors from labels (semantic recoloring) as needed. Inputs
    may be numpy arrays or tensors."""
    del intr  # reserved for rescale handling, as in the reference
    dev = resolve(device)
    with timing.span("server/upload"):
        if labels is None:
            if colors is None or label_map is None:
                raise ValueError("need labels, or colors + label_map")
            labels = label_map.labels_from_colors(
                _host(colors).astype(np.uint8))
        if colors is None:
            if label_map is None:
                raise ValueError("need colors or label_map")
            colors = label_map.colors_from_labels(
                _host(labels).astype(np.int32))
        if T_G_C is None:
            T_G_C = np.eye(4, dtype=np.float32)

        def t(x, dtype):
            return torch.tensor(_host(x), dtype=dtype, device=dev)

        # Each copy from pageable host memory returns once it has landed.
        with timing.span("sync/upload"):
            return Frame(depth=t(depth, torch.float32),
                         labels=t(labels, torch.int32),
                         colors=t(colors, torch.float32),
                         T_G_C=t(T_G_C, torch.float32))


def stage(name: str) -> timing.span:
    """The span "integrate_frame/<name>" around one stage of an
    integrator's frame (utils/timing.py)."""
    return timing.span(f"integrate_frame/{name}")


def prepare_points(frame: Frame, intr, cfg):
    """Backproject + validity + weights: (pts_C, pts_G, origin, colors,
    labels, weights, valid, is_clearing), per pixel. A point with a dynamic
    label is skipped entirely, TSDF included."""
    pts_C, px_valid = cam.backproject(frame.depth, intr)
    labels = frame.labels.reshape(-1)
    colors = frame.colors.reshape(-1, 3)
    valid, is_clearing = tsdf_ops.point_validity(pts_C, cfg.tsdf)
    valid = valid & px_valid & sem_ops.dynamic_label_mask(labels,
                                                          cfg.semantic)
    weights = tsdf_ops.voxel_weight(pts_C, cfg.tsdf)
    pts_G = transforms.apply(frame.T_G_C, pts_C)
    origin = transforms.translation(frame.T_G_C)
    return pts_C, pts_G, origin, colors, labels, weights, valid, is_clearing


def gather_packed(idx: torch.Tensor, *arrays):
    """Row-gather every array at `idx`. The reference packs the arrays into
    one matrix for a single TPU gather; here each is indexed directly."""
    return tuple(a[idx] for a in arrays)


def compact(order_mask: torch.Tensor, max_out: int, *arrays):
    """Pack the entries where order_mask is True into the first slots, in
    their original order, cut to `max_out`. Returns (kept_mask, gathered
    arrays...); entries beyond max_out are dropped (fixed ray budget)."""
    kept, order = stable_compact_order(order_mask, max_out)
    return (kept,) + gather_packed(order, *arrays)
