"""kimera_semantics_tpu_torch: the PyTorch/CUDA port of kimera_semantics_tpu.

A second package beside the JAX one, module for module: the JAX package is the
reference the port is held against and is left as it is. The port imports
`torch` and numpy, never `jax` and nothing of `kimera_semantics_tpu`.

Every entry point takes an explicit `device` that defaults to "cuda" and
raises when no card is present; only an explicit `device="cpu"` runs the plain
PyTorch versions of the kernels on the CPU (the tests do). On the card, the
TPU kernels of the projective main path run as hand-written CUDA kernels
(ops/kernels.py, csrc/*.cu).
"""

import torch as _torch

# No f32 result of the port may pass through TF32: the reference computes at
# HIGHEST matmul precision (kimera_semantics_tpu/__init__.py). The port keeps
# its geometry out of matmuls altogether; these flags pin the rest.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import (ColorMode, FusionConfig, GridConfig, IntegratorType,  # noqa: E402
                     PipelineConfig, SemanticConfig, TsdfConfig)
from .core.camera import PinholeIntrinsics  # noqa: E402
from .core.color import LabelColorMap  # noqa: E402
from .grid.blocks import VoxelGrid, create  # noqa: E402
from .models.common import Frame, frame_from_images  # noqa: E402

__version__ = "0.1.0"
