"""Device selection for the port's entry points (no JAX counterpart: JAX
picks its backend globally).

Entry points default to the card. Asking for CUDA on a machine without one
raises instead of running on the CPU; the CPU runs only when asked for.
"""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and no card is
    present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


def check_on(dev: torch.device, **tensors):
    """Raise unless every named tensor lies on `dev`."""
    for name, t in tensors.items():
        if t.device.type != dev.type or (
                dev.index is not None and t.device.index != dev.index):
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
