"""A traced window and what is read from it: the device's busy time, the
host ranges, the host syncs, the longest device operations and idle gaps.
"""

from __future__ import annotations

import time
import warnings

import torch


class Traced:
    """What one torch.profiler window recorded."""

    def __init__(self, events, window_s: float, frames: int, launches,
                 kernels=None):
        from torch.autograd import DeviceType
        self.events = events
        self.window_s = window_s
        self.frames = frames
        self.launches = launches
        # What kernels_roofline reads besides the launches: the port's
        # kernel names, the counts, the port's launch counter, problems.
        self.kernels = kernels or {}
        self.device = [e for e in events if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)]
        self.host = [e for e in events if e.device_type == DeviceType.CPU]

    def busy_s(self) -> float:
        """Seconds in which the device ran anything (union of spans)."""
        total, end = 0.0, float("-inf")
        for s, e in sorted((e.time_range.start, e.time_range.end)
                           for e in self.device):
            if e > end:
                total += e - max(s, end)
                end = e
        return total / 1e6

    def range_s(self, name: str) -> float:
        """Host seconds in the profiler ranges called `name`."""
        return sum(e.time_range.elapsed_us() for e in self.host
                   if e.name == name) / 1e6

    def count(self, pred) -> int:
        return sum(1 for e in self.host if pred(e.name))

    def device_ops(self, n: int = 10):
        """[[name, seconds]] of the device operations that took most."""
        by = {}
        for e in self.device:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
        return [[k[:64], v] for k, v in sorted(by.items(),
                                              key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """[[host range, seconds]]: the device's idle gaps, each given to
        the innermost profiler range (record_function) open on the host at
        its middle, summed by range."""
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in self.device)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        ranges = sorted(((e.time_range.start, e.time_range.end, e.name)
                         for e in self.host
                         if getattr(e, "is_user_annotation", False)
                         or "/" in e.name or "(" in e.name),
                        key=lambda r: r[0])
        by = {}
        for a, b in gaps:
            mid = (a + b) / 2
            best = None
            for s, e, name in ranges:
                if s > mid:
                    break
                if e >= mid and (best is None or e - s < best[1] - best[0]):
                    best = (s, e, name)
            key = best[2] if best else "(no range open)"
            by[key] = by.get(key, 0.0) + (b - a) / 1e6
        return [[k[:64], v] for k, v in sorted(by.items(),
                                              key=lambda kv: -kv[1])[:n]]


def traced(fn, device, kernels, counts_dir):
    """Run fn() (returning the frames it drove) under torch.profiler with
    the kernel recorder on (the counts of `counts_dir`); returns a
    Traced."""
    from torch.profiler import ProfilerActivity, profile

    from .roofline import Recorder, load_counts, port_kernel_names
    counts = load_counts(counts_dir)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with Recorder(kernels, counts) as rec:
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                frames = fn()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                window = time.perf_counter() - t0
        events = prof.events()
    return Traced(events, window, frames, rec.launches, kernels=dict(
        port_names=port_kernel_names(kernels), counts=counts,
        port_launches=rec.port_launches(), problems=rec.problems))
