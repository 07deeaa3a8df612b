"""Semantic label <-> color maps.

Counterpart: kimera_semantics_tpu/core/color.py (LabelColorMap). The maps
are built on the host with numpy exactly as the reference builds them; the
decode takes the host LUT path (one 2^24-entry table), and the encode
accepts numpy arrays or tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

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
