"""Float32 rounding helpers shared by the plain versions and the kernels.

No JAX counterpart: these pin down rounding that the reference leaves to its
compiler. The reference (kimera_semantics_tpu on XLA:CPU) rewrites division by
a constant as multiplication by the constant's float32 reciprocal, and
contracts some `a*b + c` patterns into one fused multiply-add. Where such a
value decides an integer (a pixel, a mip level, a band mask), the port
reproduces the same rounding on purpose: `recip` for the first, `fma` for the
second, and the CUDA kernels call `__fmaf_rn` at the same places (they are
otherwise built with `--fmad=false`, so nothing else is contracted).
"""

from __future__ import annotations

import numpy as np
import torch


def recip(c: float) -> float:
    """float32(1 / float32(c)) as a Python float (exact in float32)."""
    return float(np.float32(1.0) / np.float32(c))


def f32(c: float) -> float:
    """`c` rounded to float32, as a Python float."""
    return float(np.float32(c))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a*b + c rounded once, as a fused multiply-add does.

    The float64 product of two float32 values is exact; the sum rounds to
    float64 and then to float32, which equals one rounding except in cases
    of probability ~2^-28."""
    def d(x):
        return x.double() if torch.is_tensor(x) else float(x)
    return (d(a) * d(b) + d(c)).float()
