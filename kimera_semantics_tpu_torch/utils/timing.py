"""Spans and counters of the port's work: the voxblox `timing::Timer` and
`timing::Timing::Print` equivalent, and the port's profiler ranges.

Counterpart: kimera_semantics_tpu/utils/timing.py (whose `Timer` blocks on
the device when asked). Here there is one primitive, `span(name, args)`:

  - On exit it adds its host seconds to a process-wide registry (total,
    count, sum of squares), which `report()` prints.
  - While a torch.profiler runs on the calling thread
    (`torch.autograd._profiler_enabled()`), it also opens a
    `record_function(name, args)` range, so every span lies on the
    profiler's timeline beside the device's kernels. With no profiler it
    costs a flag check and a registry add.
  - It never waits for the device: a span is host time, and the device
    work it enqueued may still be running when it closes.

Names are `<layer>/<stage>`, nested by call. A span named `sync/<site>`
wraps one statement that makes the host wait for the device (a host
sync): its count is that site's syncs, and its time the host's wait for
the device to drain the work enqueued before it. `count(name, n)` adds to
a counter in the same registry.
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
        self.counters = defaultdict(int)

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
            self.counters.clear()


_registry = _Registry()


class span:
    """A named span of host time; a context manager. `args` (a string, such
    as a frame's number) goes to the profiler range with the name.
    `elapsed` holds the span's host seconds once it has closed."""

    __slots__ = ("name", "args", "elapsed", "_t0", "_range")

    def __init__(self, name: str, args: Optional[str] = None):
        self.name = name
        self.args = args
        self.elapsed: Optional[float] = None

    def __enter__(self):
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name, self.args)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        _registry.add(self.name, self.elapsed)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    with _registry.lock:
        _registry.counters[name] += n


def reset():
    _registry.reset()


def get(name: str):
    """(total_s, count, mean_s) of the spans called `name`."""
    with _registry.lock:
        # .get: reading a span that never ran must not register it.
        t, c = _registry.totals.get(name, 0.0), _registry.counts.get(name, 0)
    return t, c, (t / c if c else 0.0)


def report() -> str:
    """Printable table like voxblox timing::Timing::Print: each span's
    count, total, mean and std in host seconds, then the counters. Where
    server/frame spans ran, a last column gives each count per frame
    (syncs a frame at a `sync/` site)."""
    with _registry.lock:
        rows = []
        for name in sorted(_registry.totals):
            t = _registry.totals[name]
            c = _registry.counts[name]
            mean = t / c
            var = max(_registry.sq_totals[name] / c - mean * mean, 0.0)
            rows.append((name, c, t, mean, math.sqrt(var)))
        counters = sorted(_registry.counters.items())
        frames = _registry.counts.get("server/frame", 0)
    lines = [f"{'span (host seconds)':<40} {'count':>7} {'total_s':>10} "
             f"{'mean_s':>10} {'std_s':>10}"
             + (f" {'n/frame':>9}" if frames else "")]
    for name, c, t, mean, std in rows:
        lines.append(f"{name:<40} {c:>7} {t:>10.4f} {mean:>10.5f} "
                     f"{std:>10.5f}" + (f" {c / frames:>9.3f}" if frames
                                        else ""))
    if counters:
        lines.append(f"{'counter':<40} {'value':>7}")
        lines.extend(f"{name:<40} {v:>7}" for name, v in counters)
    return "\n".join(lines)
