"""Hierarchical accumulating timers, the voxblox `timing::Timer` equivalent.

Counterpart: kimera_semantics_tpu/utils/timing.py. `Timer(..., sync=t)`
synchronizes the CUDA device of tensor `t` (a tensor, or a list or tuple of
tensors) before stopping, so device work is attributed to the right phase;
CPU tensors need no sync.
"""

from __future__ import annotations

import math
import threading
import time
from collections import defaultdict
from typing import Optional

import torch


class _Registry:
    def __init__(self):
        self.lock = threading.Lock()
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.sq_totals = defaultdict(float)

    def add(self, name: str, dt: float):
        with self.lock:
            self.totals[name] += dt
            self.sq_totals[name] += dt * dt
            self.counts[name] += 1

    def reset(self):
        with self.lock:
            self.totals.clear()
            self.counts.clear()
            self.sq_totals.clear()


_registry = _Registry()


def synchronize(sync) -> None:
    """Wait for the CUDA devices of the tensors in `sync`."""
    ts = sync if isinstance(sync, (list, tuple)) else [sync]
    for dev in {t.device for t in ts if torch.is_tensor(t)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class Timer:
    """Named accumulating timer; use as a context manager or start/stop."""

    def __init__(self, name: str, sync=None):
        self.name = name
        self._sync = sync
        self._t0: Optional[float] = None
        self.elapsed: Optional[float] = None  # seconds, once stopped
        self.start()

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync=None):
        sync = sync if sync is not None else self._sync
        if sync is not None:
            synchronize(sync)
        if self._t0 is not None:
            self.elapsed = time.perf_counter() - self._t0
            _registry.add(self.name, self.elapsed)
            self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def reset():
    _registry.reset()


def get(name: str):
    """(total_s, count, mean_s) for a timer name."""
    with _registry.lock:
        t, c = _registry.totals[name], _registry.counts[name]
    return t, c, (t / c if c else 0.0)


def report() -> str:
    """Printable table like voxblox timing::Timing::Print."""
    with _registry.lock:
        rows = []
        for name in sorted(_registry.totals):
            t = _registry.totals[name]
            c = _registry.counts[name]
            mean = t / c
            var = max(_registry.sq_totals[name] / c - mean * mean, 0.0)
            rows.append((name, c, t, mean, math.sqrt(var)))
    lines = [f"{'name':<40} {'count':>7} {'total_s':>10} {'mean_s':>10} "
             f"{'std_s':>10}"]
    for name, c, t, mean, std in rows:
        lines.append(f"{name:<40} {c:>7} {t:>10.4f} {mean:>10.5f} "
                     f"{std:>10.5f}")
    return "\n".join(lines)
