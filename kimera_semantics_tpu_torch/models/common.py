"""Shared frame-level plumbing for the integrators.

Counterpart: kimera_semantics_tpu/models/common.py (Frame,
frame_from_images). A Frame is a dataclass of tensors on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.color import LabelColorMap
from ..device import resolve


@dataclasses.dataclass(frozen=True)
class Frame:
    """One (depth, semantics, pose) input tuple."""

    depth: torch.Tensor      # (H, W) float32 meters
    labels: torch.Tensor     # (H, W) int32
    colors: torch.Tensor     # (H, W, 3) float32 [0, 255]
    T_G_C: torch.Tensor      # (4, 4) float32


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
    if labels is None:
        if colors is None or label_map is None:
            raise ValueError("need labels, or colors + label_map")
        labels = label_map.labels_from_colors(_host(colors).astype(np.uint8))
    if colors is None:
        if label_map is None:
            raise ValueError("need colors or label_map")
        colors = label_map.colors_from_labels(_host(labels).astype(np.int32))
    if T_G_C is None:
        T_G_C = np.eye(4, dtype=np.float32)

    def t(x, dtype):
        return torch.tensor(_host(x), dtype=dtype, device=dev)

    return Frame(depth=t(depth, torch.float32), labels=t(labels, torch.int32),
                 colors=t(colors, torch.float32), T_G_C=t(T_G_C, torch.float32))
