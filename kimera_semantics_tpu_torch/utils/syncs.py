"""The host syncs of a block of work, read from a torch.profiler trace.

A second witness beside torch.cuda.set_sync_debug_mode, which PyTorch
names a prototype that does not yet detect every synchronizing operation:
the CUDA runtime and driver calls that make the host wait on the device,
as the trace records them while the block runs.
"""

from __future__ import annotations

import warnings

import torch

# Runtime and driver calls that return only once the device has caught up.
SYNC_CALLS = frozenset({
    "cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpy3D", "cudaMemcpyToSymbol",
    "cudaMemcpyFromSymbol", "cudaMemset", "cuCtxSynchronize",
    "cuStreamSynchronize", "cuEventSynchronize"})
LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel", "cuLaunchKernelEx"})
_RANGE = "host_syncs/block"


def is_host_sync(name: str) -> bool:
    """Whether a CUDA runtime or driver call of this name waits on the
    device (a synchronize, or a copy or set that is not Async)."""
    return name in SYNC_CALLS or (name.startswith("cuMemcpy")
                                  and "Async" not in name)


def _traced(fn):
    """Run fn() under a torch.profiler trace; returns the host events that
    start while it runs. The profiler's own synchronize when it stops
    falls outside fn()'s range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=acts) as prof:
            with record_function(_RANGE):
                fn()
        events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    # the host's span of fn() (the trace also holds its device-side span)
    span = next(e.time_range for e in events if e.name == _RANGE)
    return [e for e in events
            if span.start <= e.time_range.start <= span.end]


def host_syncs(fn):
    """Run fn() under a torch.profiler trace. Returns (syncs, launches):
    the host-syncing CUDA calls made while fn() ran, {name: count}, and
    the kernel launch calls seen. A trace with no launch saw no runtime
    call at all, so its empty `syncs` proves nothing."""
    syncs, launches = {}, 0
    for e in _traced(fn):
        if is_host_sync(e.name):
            syncs[e.name] = syncs.get(e.name, 0) + 1
        elif e.name in LAUNCH_CALLS:
            launches += 1
    return syncs, launches


def sync_sites(fn):
    """Run fn() under a torch.profiler trace. Returns (declared,
    undeclared, launches): the host-syncing CUDA calls made while fn() ran
    by the innermost `sync/` span (utils/timing.py) open at their start,
    {span name: count}; those in no `sync/` span by the innermost span of
    the port open there ("(none)" outside every span), {name: count}; and
    the kernel launch calls seen."""
    events = _traced(fn)
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if "/" in e.name and e.name != _RANGE]
    declared, undeclared, launches = {}, {}, 0
    for e in events:
        if e.name in LAUNCH_CALLS:
            launches += 1
        if not is_host_sync(e.name):
            continue
        x = e.time_range.start
        open_ = [(b - a, name) for a, b, name in spans if a <= x <= b]
        sync = min((r for r in open_ if r[1].startswith("sync/")),
                   default=None)
        if sync is not None:
            declared[sync[1]] = declared.get(sync[1], 0) + 1
        else:
            site = min(open_, default=(0, "(none)"))[1]
            undeclared[site] = undeclared.get(site, 0) + 1
    return declared, undeclared, launches
