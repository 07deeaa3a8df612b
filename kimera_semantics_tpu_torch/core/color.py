"""Semantic label <-> color maps.

Counterpart: kimera_semantics_tpu/core/color.py (LabelColorMap,
rainbow_colormap). The maps
are built on the host with numpy exactly as the reference builds them; the
decode takes the host LUT path (one 2^24-entry table), and the encode
accepts numpy arrays or tensors.
"""

from __future__ import annotations

import csv
import dataclasses
import io
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import UNKNOWN_LABEL

# White is force-mapped to the unknown label 0 in both directions.
WHITE = (255, 255, 255)
GRAY = (128, 128, 128)


def pack_rgb(rgb: np.ndarray) -> np.ndarray:
    """Pack (..., 3) uint8 RGB into int32 keys."""
    keys = rgb[..., 0].astype(np.int32)
    keys <<= 8
    keys |= rgb[..., 1]
    keys <<= 8
    keys |= rgb[..., 2]
    return keys


@dataclasses.dataclass(frozen=True)
class LabelColorMap:
    """Bidirectional label<->color map.

    - sorted_keys / sorted_labels: packed-RGB -> label
    - label_colors: (256, 3) uint8, label -> RGB
    """

    sorted_keys: np.ndarray      # (K,) int32
    sorted_labels: np.ndarray    # (K,) int32
    label_colors: np.ndarray     # (256, 3) uint8
    num_labels: int
    _host_lut: list = dataclasses.field(default_factory=list, compare=False,
                                        repr=False)

    @staticmethod
    def from_pairs(label_to_rgb: Dict[int, Tuple[int, int, int]],
                   rgb_to_label: Dict[Tuple[int, int, int], int],
                   num_labels: int) -> "LabelColorMap":
        label_to_rgb = dict(label_to_rgb)
        rgb_to_label = dict(rgb_to_label)
        label_to_rgb[UNKNOWN_LABEL] = WHITE
        rgb_to_label[WHITE] = UNKNOWN_LABEL
        keys = pack_rgb(np.array(list(rgb_to_label.keys()), dtype=np.uint8))
        labels = np.array(list(rgb_to_label.values()), dtype=np.int32)
        order = np.argsort(keys)
        colors = np.zeros((256, 3), dtype=np.uint8)
        for lab, rgb in label_to_rgb.items():
            colors[lab] = rgb
        return LabelColorMap(sorted_keys=keys[order].astype(np.int32),
                             sorted_labels=labels[order],
                             label_colors=colors, num_labels=num_labels)

    @staticmethod
    def from_csv(path_or_text: str,
                 num_labels: Optional[int] = None) -> "LabelColorMap":
        """Load a `name,red,green,blue,alpha,id` CSV (the reference's cfg/
        label files). Later rows win on duplicate colors. num_labels
        defaults to max(21, largest id whose color is not white + 1)."""
        if os.path.exists(path_or_text):
            with open(path_or_text, "r") as f:
                text = f.read()
        else:
            text = path_or_text
        label_to_rgb: Dict[int, Tuple[int, int, int]] = {}
        rgb_to_label: Dict[Tuple[int, int, int], int] = {}
        for row in csv.reader(io.StringIO(text)):
            if not row or row[0].strip() == "name":
                continue
            if len(row) != 6:
                raise ValueError(f"Invalid label-map CSV row: {row}")
            r, g, b, _a, lab = (int(x) for x in row[1:6])
            label_to_rgb[lab] = (r, g, b)
            rgb_to_label[(r, g, b)] = lab
        if num_labels is None:
            reachable = [lab for lab, rgb in label_to_rgb.items()
                         if rgb != WHITE]
            num_labels = max(21, max(reachable, default=0) + 1)
        return LabelColorMap.from_pairs(label_to_rgb, rgb_to_label, num_labels)

    @staticmethod
    def random(num_labels: int = 21, seed: int = 0) -> "LabelColorMap":
        """255 random colors with labels 0-7 pinned to distinguishable
        colors (the reference's getRandomSemanticLabelToColorMap)."""
        rng = np.random.RandomState(seed)
        colors = rng.randint(0, 256, size=(256, 3)).astype(np.uint8)
        pinned = [GRAY, (0, 255, 0), (0, 0, 255), (128, 0, 128),
                  (255, 192, 203), (0, 128, 128), (255, 165, 0), (255, 255, 0)]
        for i, c in enumerate(pinned):
            colors[i] = c
        rgb_to_label = {}
        for lab in range(255, -1, -1):
            rgb_to_label[tuple(int(v) for v in colors[lab])] = lab
        label_to_rgb = {lab: tuple(int(v) for v in colors[lab])
                        for lab in range(256)}
        return LabelColorMap.from_pairs(label_to_rgb, rgb_to_label, num_labels)

    def labels_from_colors(self, rgb) -> np.ndarray:
        """Color -> label id through the host LUT; unknown colors ->
        UNKNOWN_LABEL. rgb: (..., 3) uint8 numpy array or tensor."""
        if torch.is_tensor(rgb):
            rgb = rgb.cpu().numpy()
        keys = pack_rgb(np.asarray(rgb, dtype=np.uint8))
        return self._lut()[keys].astype(np.int32)

    def _lut(self) -> np.ndarray:
        if not self._host_lut:
            lut = np.full(1 << 24, UNKNOWN_LABEL, dtype=np.uint8)
            lut[self.sorted_keys] = self.sorted_labels.astype(np.uint8)
            self._host_lut.append(lut)
        return self._host_lut[0]

    def colors_from_labels(self, labels):
        """Label -> RGB uint8. numpy in -> numpy out; tensor in -> tensor
        out on the same device. Negative labels wrap once and labels past
        255 clamp, as the reference's gather does."""
        if torch.is_tensor(labels):
            table = torch.as_tensor(self.label_colors, device=labels.device)
            idx = torch.clamp(labels.long(), -256, 255) % 256
            return table[idx]
        return self.label_colors[np.clip(labels, -256, 255)]


def rainbow_colormap(values: torch.Tensor) -> torch.Tensor:
    """voxblox `rainbowColorMap(h)`: h in [0, 1] -> RGB uint8 (..., 3), the
    6-sector rainbow of ColorMode.SEMANTIC_PROBABILITY."""
    h = torch.clamp(values, 0.0, 1.0) * 5.9999
    i = torch.floor(h).to(torch.int32)
    f = h - i
    f = torch.where(i % 2 == 0, 1.0 - f, f)  # even sectors ramp down
    n = 1.0 - f
    zero, one = torch.zeros_like(n), torch.ones_like(n)

    def select(vals, default):
        out = default
        for k in range(5, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out
    r = select([one, n, zero, zero, n, one], one)
    g = select([n, one, one, n, zero, zero], zero)
    b = select([zero, zero, n, one, one, n], zero)
    return (torch.stack([r, g, b], dim=-1) * 255.0).to(torch.uint8)
