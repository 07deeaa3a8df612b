"""SE(3) transforms as (4, 4) float32 tensors.

Counterpart: kimera_semantics_tpu/core/transforms.py. Products are written
out element by element instead of going through a matmul, so no float32
geometry can pass through TF32 and the rounding follows the reference's
compiled form (core/fp.py): a 3-term dot is fma(z, c, fma(y, b, x * a)).
"""

from __future__ import annotations

import torch

from .fp import fma


def _dot3(x, y, z, a, b, c):
    """x*a + y*b + z*c as the reference's dot computes it."""
    return fma(z, c, fma(y, b, x * a))


def from_quat_trans(qxyzw: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Build a 4x4 transform from quaternion (x, y, z, w) and translation (3,)."""
    q = qxyzw.float()
    q = q / torch.sqrt((q * q).sum())
    x, y, z, w = q[0], q[1], q[2], q[3]
    rot = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)]),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)]),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)]),
    ])
    out = torch.eye(4, dtype=torch.float32, device=q.device)
    out[:3, :3] = rot
    out[:3, 3] = t.float().reshape(3)
    return out


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """T_a_c = T_a_b @ T_b_c, written out (no matmul, full float32)."""
    acc = a[:, 0:1] * b[0:1, :]
    for k in range(1, 4):
        acc = fma(a[:, k:k + 1], b[k:k + 1, :], acc)
    return acc


def inverse(t: torch.Tensor) -> torch.Tensor:
    r = t[:3, :3]
    p = t[:3, 3]
    q = -r.T
    out = torch.eye(4, dtype=t.dtype, device=t.device)
    out[:3, :3] = r.T
    out[:3, 3] = _dot3(q[:, 0], q[:, 1], q[:, 2], p[0], p[1], p[2])
    return out


def apply(t: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply T (4,4) to points (..., 3)."""
    x, y, z = points[..., 0:1], points[..., 1:2], points[..., 2:3]
    return _dot3(x, y, z, t[:3, 0], t[:3, 1], t[:3, 2]) + t[:3, 3]


def identity(device="cpu") -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device)


def translation(t: torch.Tensor) -> torch.Tensor:
    return t[:3, 3]
