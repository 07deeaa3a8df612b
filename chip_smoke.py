#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kimera_semantics_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must complete:
  1. build the CUDA kernels from kimera_semantics_tpu_torch/csrc (nvcc, one
     process per source, in parallel), print each kernel's ptxas report and
     the static SASS of K3, K4 and K5;
  2. hold each kernel of the projective main path (K1-K3, and K4 at the
     same frame list) against its plain PyTorch version on the card, at
     the main path's shapes, and time both (K1 in its keys-only instance,
     which the allocation walk runs, and in its full instance), and time
     an empty kernel (csrc/empty.cu) for the launch floor; then the block
     hash table's kernels ([hash]: H1 hash_lookup and H2 hash_insert,
     csrc/hash.cu) against their plain versions with torch.equal on every
     array at 512 keys in an 8192-entry table, 4096 colliding keys, and
     capacity 16376 pushed past its capacity and probed through its
     tombstones, H2 three times from one state with identical tables;
  3. drive the projective main path (models/projective.py integrate_frame)
     at the canonical configuration of bench.py (projective method,
     640x480, 0.05 m voxels, 16^3 blocks) over 4 warm-up and 24 timed
     synthetic frames, check that every kernel launched once per frame and
     that no block overflowed; trace the same loop on a fresh grid with
     torch.profiler for the time of each stage of integrate_frame and the
     device's busy share; re-run the same frames through the plain
     versions on the card and compare the grids block by block (the hash
     tables entry for entry); then [syncs]: 8 projective frames under
     torch.cuda.set_sync_debug_mode("error"), which must raise nothing,
     and under torch.profiler, whose trace must hold no synchronizing
     CUDA call (utils/syncs.py), and the syncs per frame left on the
     fast, merged and serve frames, by call site; then drive them with
     fused_apply=False (K4 then K5 per frame, K3 never) and hold that grid
     to the fused one bit for bit; then two frames at vps 5 with
     fused_apply=False and at vps 21 (V3 % 8 != 0: K5's generic instance),
     each held bit for bit to a plain run on the card, and K4's and K5's
     generic instances checked and timed on the first frame; then the u16
     wire atlas codec ([wire]): the planes encoded on the card against the
     CPU's, 2 + 8 frames with wire_sim=True held block by block to a plain
     run and timed beside the float32 route;
  4. capture the inputs of the ray integrators' kernels from one frame of
     the fast integrator at bench.py's fast configuration (K1 at voxel
     granularity, K6 slot_resolve_stream, K5 block_rmw_add in packed
     staging, and K5 in dense and onehot form at the same rows), hold each
     against its plain version on the card and time both (K5 also with the
     L2 flushed before each launch);
  5. drive the fast integrator (models/fast.py integrate_frame) at that
     configuration over 4 warm-up and 24 timed frames, check the launches
     per frame (K1 twice, K2, K3, K6 and K5 once) and that no block
     overflowed, trace it for its stages and the device's busy share, and
     compare the grid block by block with a re-run through the plain
     versions;
  6. drive the merged integrator at bench.py's merged configuration over 2
     warm-up and 8 timed frames, with the same launch and overflow checks,
     compare its grid block by block with a re-run through the plain
     versions, and trace it for its stages;
  7. the serving output: K4 at 32^3 literal storage (V3 = 32768) against
     its plain version, and K5 in onehot form on its deltas; the CLI (`node batch --preset demo --method
     projective --storage-vps 32`) over 4 + 24 frames written with
     save_directory_dataset, with its launches, overflow, PLY and a .vxblx
     that reloads to the grid's TSDF voxels; the stream server at the demo
     preset with pipelined meshing every 5 frames (frames/s, cycle ms,
     stall), the snapshot check of the async cycle, the mesh cache against
     generate_mesh (its seams counted, then every block re-meshed), and a
     .ksdv round trip; `sim-eval --preset eval`
     against the JAX package's CPU values;
  8. the rosbag batch slice: K7 add_f32 bit-exact against its plain
     version and timed beside torch.add in alternating rounds (median and
     spread of each); the scatter-strategy profiling
     tool (tools/profile_scatter.py) at its full size with --warm-kernel,
     K7 launched exactly once and every strategy's channels equal to one
     reference indexed add; the fast integrator with scatter_mode "direct"
     and "sorted" against "segment" on the same 2 + 8 frames; the
     reference's rosbag batch (`node batch <bag> --preset rosbag --esdf`
     over 4 + 24 frames written to a .bag) with the ESDF against the TSDF
     near the surface and against brute-force Euclidean distances, and its
     tsdf_esdf.vxblx reloading both layers; scan-to-map ICP recovering a
     perturbed held-out view, and the batch again with --enable-icp
     --esdf-every 10;
  9. the sharded grid, 4 shards on the one card (their times are
     sequential work, not a multi-card number), 2 steps of 4 frames each:
     [sharded fast] and [sharded merged] (anti-grazing on, the 4-frame
     bitmask) at bench.py's settings, each held shard by shard to its own
     plain run and, with [sharded projective] (float32 and u16 wire), to
     8 single-device integrate_frame calls (u16: wire_sim=True) on one grid
     of 16376 blocks, ownership disjoint, launches per step checked;
     [sharded nccl]: the fast and u16 projective steps with every gather
     through a one-process NCCL group, bit for bit the in-process runs;
     [mirror]: MultiHostPipeline with an incremental mesh after each step,
     the mirror against merge_shards and the mesh against a full
     extraction; [batched]: fast and merged integrate_frames at B = 8
     against 8 sequential frames and their plain run, K6 once with 8
     cubes;
 10. report per-stage times, the kernel table (one JSON line), the card's
     name and power limit, and last the one-line JSON result.

Exits non-zero, with no result line, on any failure, including when no
CUDA device is present or the package is missing.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
BANDWIDTH = 3.35e12      # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
FP32_PEAK = 67e12        # H100 SXM float32 outside the tensor cores, FLOP/s
WARM_FRAMES = 4          # integrated before the timed frames
FRAMES = 24              # timed frames of the projective and fast paths
MERGED_WARM = 2          # merged: warm-up and timed frames
MERGED_FRAMES = 8
REPS = 50                # launches per kernel timing

# Tolerances of the kernel-vs-plain checks. Both sides run the same float32
# operations in the same order (fused multiply-adds at the same places), so
# integer outputs must be bit-exact; float outputs are held to 1e-6 relative
# (only the order of the adds into the grid could differ, and it does not).
FLOAT_RTOL = 1e-6
# The plain scatter modes against "segment" ([modes]): "direct" adds every
# update in another order (with atomics on the card), so floats are held to
# MODE_TOL relative plus MODE_TOL of the channel's largest value; "sorted"
# sums each frame's stream as differences of one running float32 cumsum,
# so a voxel's sum is off by ulps of that prefix: 8 eps P, P the channel's
# grid total (truncation times wsum's for wsdf). Counts exact in both.
MODE_TOL = 1e-5


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, reps: int) -> float:
    """Mean ms per call of fn() over `reps` calls, from CUDA events, after
    one warm call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


KERNEL_SYMBOLS = {"dda_job_stream": "dda_kernel",
                  "block_meta": "block_meta_kernel",
                  "projective_apply_fused": "proj_apply_kernel",
                  "projective_sample_update": "proj_sample_kernel",
                  "slot_resolve_stream": "slot_resolve_kernel",
                  "block_rmw_add": "block_rmw_kernel",
                  "add_f32": "ksd_add_f32_kernel",
                  "hash_lookup": "hash_lookup_kernel",
                  "hash_insert": "hash_insert_kernel",
                  "empty": "empty_kernel"}
CHANNELS = ("wsum", "wsdf", "sem_count", "sem_delta", "wcolor")
K1_OUTPUTS = ("key", "local", "w", "wsdf", "wc", "valid", "run_key",
              "run_idx")


def trace(fn):
    """The events of a torch.profiler trace (CPU and CUDA) of fn(), which
    ends in a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return prof.events()


def device_events(events):
    """The trace's device activities (kernels, copies, sets), without the
    device-side spans of profiler ranges."""
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


# A profiler session now and then returns a trace without the device
# activity of kernels that fn() did launch (seen on the H100 for K7 and for
# torch.add, a few microseconds each). A trace that shows no span of
# `symbol` is taken again, up to TRACE_ATTEMPTS traces in all; a kernel
# that never shows stays a failure. TRACE_RETRIES counts the traces taken
# again, by symbol, and is printed with the kernels line.
TRACE_ATTEMPTS = 4
TRACE_RETRIES = {}


def device_time(fn, symbol: str, reps: int):
    """Mean device ms of the CUDA kernel `symbol` per call of fn(), from a
    torch.profiler trace of `reps` calls; None if the trace shows no device
    time for it."""
    fn()

    def run():
        for _ in range(reps):
            fn()
    for attempt in range(TRACE_ATTEMPTS):
        if attempt:
            TRACE_RETRIES[symbol] = TRACE_RETRIES.get(symbol, 0) + 1
        spans = [e.time_range.elapsed_us() for e in device_events(trace(run))
                 if symbol in e.name]
        if spans and sum(spans) > 0:
            return sum(spans) / 1e3 / reps
    return None


def cold_device_time(fn, symbol: str, reps: int, dev):
    """device_time of `symbol` with the 50 MB L2 flushed before every call
    of fn(): a 64 MB scratch tensor is zeroed first (a memset, not the
    profiled symbol), so the kernel finds its inputs in HBM."""
    import torch
    scratch = torch.empty(16 << 20, dtype=torch.float32, device=dev)

    def run():
        scratch.zero_()
        fn()
    ms = device_time(run, symbol, reps)
    del scratch
    return ms


def busy_ms(events) -> float:
    """ms during which the device ran anything (union of its activities)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_events(events))
    total, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


# Kernels whose device time must come from the profiler (no fallback to
# the wrapper's event time): K3 and K5, templated kernels whose symbols
# must still contain KERNEL_SYMBOLS' names.
PROFILED_ONLY = ("projective_apply_fused", "block_rmw_add")


def kernel_times(name, fn, plain_fn):
    """The kernel's device ms per launch (profiler; CUDA events around the
    wrapper calls where the trace shows no device time, except for
    PROFILED_ONLY, which then fail), the wrapper's ms per call and, given
    plain_fn, the plain version's ms per call (both CUDA events)."""
    wrapper = cuda_time(fn, REPS)
    dev = device_time(fn, KERNEL_SYMBOLS[name], REPS)
    if dev is None and name in PROFILED_ONLY:
        fail(f"{name}: the profiler trace shows no device time for a "
             f"kernel named *{KERNEL_SYMBOLS[name]}*")
    return dict(ms=dev if dev is not None else wrapper, wrapper_ms=wrapper,
                timed_by="profiler" if dev is not None else "cuda events",
                plain_ms=cuda_time(plain_fn, 5) if plain_fn else None)


def max_rel_err(a, b) -> float:
    import torch
    d = (a.double() - b.double()).abs()
    return float((d / b.double().abs().clamp(min=1e-30)).max()) if d.numel() \
        else 0.0


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


@contextlib.contextmanager
def plain_kernels(kernels):
    """Route the main path through the kernels' plain versions (on
    whatever device the tensors are): for the reference run only."""
    names = tuple(kernels.launches)
    saved = {n: getattr(kernels, n) for n in names}
    try:
        for n in names:
            setattr(kernels, n, getattr(kernels, n + "_plain"))
        yield
    finally:
        for n, f in saved.items():
            setattr(kernels, n, f)


def canonical(kt):
    """bench.py's canonical projective configuration (bench.py:87-145)."""
    from kimera_semantics_tpu_torch.config import (
        FusionConfig, GridConfig, PipelineConfig, SemanticConfig, TsdfConfig)
    cfg = FusionConfig(
        grid=GridConfig(voxel_size=0.05, voxels_per_side=16,
                        block_capacity=4096),
        tsdf=TsdfConfig(truncation_distance=0.1, max_ray_length_m=5.0,
                        voxel_carving_enabled=True, use_const_weight=False),
        semantic=SemanticConfig(semantic_measurement_probability=0.8),
        pipeline=PipelineConfig(max_rays=32768, dedup_table_size=1 << 20,
                                segment_budget=1 << 17, alloc_stride=8,
                                block_budget=512, patch_rows=128))
    intr = kt.PinholeIntrinsics(fx=320.0, fy=320.0, cx=319.5, cy=239.5,
                                width=640, height=480)
    return cfg, intr



def ray_config(kt, method: str):
    """bench.py's configuration of a ray integrator (bench.py:87-145 with
    BENCH_METHOD=fast or merged): the canonical grid, carve_mode
    "projective", band density "matched" (fast) or "octave" (merged), and
    the method's ray and segment budgets."""
    cfg, intr = canonical(kt)
    fast = method == "fast"
    return dataclasses.replace(
        cfg, tsdf=dataclasses.replace(
            cfg.tsdf, carve_mode="projective",
            band_density="matched" if fast else "octave"),
        pipeline=dataclasses.replace(
            cfg.pipeline, max_rays=28672 if fast else 32768,
            segment_budget=98304 if fast else 40960)), intr


def stage_ms(events, stages, n_frames, outer=None):
    """Host ms per frame of each `integrate_frame/<stage>` profiler range;
    with `outer`, ranges nested in an `integrate_frame/<outer>` range (the
    projective path's own stages inside the fast path's dense carve) are
    left out."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU
           and e.name.startswith("integrate_frame/")]
    spans = [(e.time_range.start, e.time_range.end) for e in cpu
             if outer and e.name == f"integrate_frame/{outer}"]

    def nested(e):
        return any(a <= e.time_range.start and e.time_range.end <= b
                   for a, b in spans)
    return {k: sum(e.time_range.elapsed_us() for e in cpu
                   if e.name == f"integrate_frame/{k}"
                   and (k == outer or not nested(e))) / 1e3 / n_frames
            for k in stages}


def compare_grids(grid, ref, cfg, exact, label):
    """Fail unless `ref` holds the same blocks as `grid` with the same
    counters, and its channels agree block by block (the channels in
    `exact` bit for bit, the others within FLOAT_RTOL). Returns the largest
    float difference and the observed voxel count."""
    import torch
    from kimera_semantics_tpu_torch.grid import blocks
    g = cfg.grid
    n_blocks = int(grid.n_blocks)
    for name in ("n_blocks", "overflow", "dropped_rays", "frame_counter"):
        if int(getattr(ref, name)) != int(getattr(grid, name)):
            fail(f"{label}: plain run {name} {int(getattr(ref, name))}, "
                 f"kernel run {int(getattr(grid, name))}")
    # Both runs inserted the same key streams, and the hash kernels are
    # deterministic: the tables are equal entry for entry, slot ids
    # included.
    for name in ("table_keys", "table_slots", "block_coords"):
        if not torch.equal(getattr(grid, name), getattr(ref, name)):
            fail(f"{label}: the plain run's {name} differ from the kernel "
                 "run's")
    coords = grid.block_coords[:n_blocks]
    s_k = blocks.lookup_slots(grid, coords, g).long()
    s_p = blocks.lookup_slots(ref, coords, g).long()
    if bool((s_p >= g.block_capacity).any()):
        fail(f"{label}: plain run allocated another block set")
    worst = 0.0
    for c in CHANNELS:
        a, b = getattr(grid, c), getattr(ref, c)
        a, b = (a[:, s_k], b[:, s_p]) if a.dim() == 3 else (a[s_k], b[s_p])
        if not bool(torch.isfinite(a).all()):
            fail(f"{label} {c}: non-finite values")
        if c in exact:
            if not torch.equal(a, b):
                fail(f"{label} {c}: kernel run and plain run differ")
        elif max_abs_err(a, b) > 0 and max_rel_err(a, b) > FLOAT_RTOL:
            fail(f"{label} {c}: kernel run and plain run differ")
        else:
            worst = max(worst, max_abs_err(a, b))
    upd_k = grid.updated[s_k]
    if not torch.equal(upd_k, ref.updated[s_p]) or not bool(upd_k.any()):
        fail(f"{label}: updated flags differ")
    dist = blocks.tsdf_distance(grid, cfg.tsdf.truncation_distance)[s_k]
    labs = blocks.mle_labels(grid)[s_k]
    seen = grid.wsum[s_k] > 0
    if not bool(torch.isfinite(dist).all()) or int(labs.max()) >= g.num_labels:
        fail(f"{label}: readouts out of range")
    return worst, int(seen.sum()), sorted(set(labs[seen].tolist()))


def drive(model, cfg, intr, frames, warm, n, dev, expect, **frame_kw):
    """Integrate frames[:warm], then time frames[warm:warm + n] on the
    host clock (ending in a synchronize) with every launch count set to 0
    just before; fail unless the counts equal `expect` (per frame) and no
    block overflowed. `frame_kw` goes to every integrate_frame call.
    Returns (grid, counts, ms per frame)."""
    import torch
    from kimera_semantics_tpu_torch.grid import blocks
    from kimera_semantics_tpu_torch.ops import kernels
    grid = blocks.create(cfg, device=dev)
    for f in frames[:warm]:
        model.integrate_frame(grid, f, cfg, intr, device=dev, **frame_kw)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for f in frames[warm:warm + n]:
        model.integrate_frame(grid, f, cfg, intr, device=dev, **frame_kw)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / n
    counts = dict(kernels.launches)
    want = {k: expect.get(k, 0) * n for k in counts}
    if counts != want:
        fail(f"{model.__name__}: launches {counts} over {n} frames, "
             f"expected {want}")
    if int(grid.overflow) != 0 or int(grid.n_blocks) <= 0:
        fail(f"{model.__name__}: overflow {int(grid.overflow)}, n_blocks "
             f"{int(grid.n_blocks)}")
    return grid, counts, ms


def capture_ray_inputs(fast, kernels, grid, frame, cfg, intr, dev):
    """Run one fast frame with each ray-path kernel wrapper recording its
    arguments (cloned) before it launches: K1's second launch (the band
    walk at voxel granularity), K6 and K5."""
    import torch
    seen = {}
    real = {n: getattr(kernels, n) for n in ("dda_job_stream",
                                             "slot_resolve_stream",
                                             "block_rmw_add")}

    def recorder(name):
        def fn(*a, **kw):
            # K5's first five arguments are the grid channels themselves
            keep = lambda i, x: (x.clone() if torch.is_tensor(x) and not (  # noqa
                name == "block_rmw_add" and i < 5) else x)
            seen.setdefault(name, []).append(
                ([keep(i, x) for i, x in enumerate(a)],
                 {k: keep(-1, v) for k, v in kw.items()}))
            return real[name](*a, **kw)
        return fn
    try:
        for n in real:
            setattr(kernels, n, recorder(n))
        fast.integrate_frame(grid, frame, cfg, intr, device=dev)
    finally:
        for n, f in real.items():
            setattr(kernels, n, f)
    torch.cuda.synchronize()
    if [len(seen.get(n, ())) for n in real] != [2, 1, 1]:
        fail("fast frame launched " + str({n: len(v) for n, v in
                                           seen.items()}))
    return seen["dda_job_stream"][1][0], seen["slot_resolve_stream"][0][0], \
        seen["block_rmw_add"][0]


def k1_full_bytes(R: int, S: int, MAXR: int) -> int:
    """Bytes K1's full instance moves: four (3, R) float planes, the
    weights and the 1-byte flags read; six 4-byte (S, R) planes, the 1-byte
    valid plane and the (MAXR, R) run keys written."""
    return 4 * (3 * 4 * R + R) + R + (4 * 6 + 1) * S * R + 4 * MAXR * R


def check_outputs(label, got, ref, names, floats):
    """Fail unless kernel and plain outputs agree: ints bit-exact, floats
    within FLOAT_RTOL. Returns the largest float difference."""
    import torch
    err = 0.0
    for n, a, b in zip(names, got, ref):
        if n in floats:
            e = max_abs_err(a, b)
            if e > 0 and max_rel_err(a, b) > FLOAT_RTOL:
                fail(f"{label} {n}: kernel and plain differ (max abs {e})")
            err = max(err, e)
        elif not torch.equal(a, b):
            fail(f"{label} {n}: kernel and plain differ at "
                 f"{int((a != b).sum())} entries")
    return err


def ray_kernel_checks(kt, frames, dev, report):
    """Phase 4: K1 (voxel granularity), K6 and K5 against their plain
    versions on the card, at the fast path's shapes, and timed."""
    import torch
    from kimera_semantics_tpu_torch.grid import blocks
    from kimera_semantics_tpu_torch.models import fast
    from kimera_semantics_tpu_torch.ops import kernels
    cfg, intr = ray_config(kt, "fast")
    g = cfg.grid
    grid = blocks.create(cfg, device=dev)
    for f in frames[:WARM_FRAMES]:
        fast.integrate_frame(grid, f, cfg, intr, device=dev)
    k1_args, k6_args, (k5_args, k5_kw) = capture_ray_inputs(
        fast, kernels, grid, frames[WARM_FRAMES], cfg, intr, dev)

    # K1 at voxel granularity: the band walk.
    _, S, _, point3, _, _, _, _ = k1_args
    R = point3.shape[1]
    out_k = kernels.dda_job_stream(*k1_args)
    out_p = kernels.dda_job_stream_plain(*k1_args)
    torch.cuda.synchronize()
    err = check_outputs("K1 (voxel)", out_k, out_p, K1_OUTPUTS,
                        ("w", "wsdf", "wc"))
    MAXR = out_k[6].shape[0]
    t = kernel_times("dda_job_stream", lambda: kernels.dda_job_stream(
        *k1_args), lambda: kernels.dda_job_stream_plain(*k1_args))
    report["dda_job_stream"]["voxel"] = dict(
        err=err, R=R, S=S, MAXR=MAXR, **t,
        bytes=k1_full_bytes(R, S, MAXR), ops=R * (60 + 40 * S))
    print(f"[K1 dda_job_stream, voxel granularity] R={R} S={S} MAXR={MAXR}: "
          f"ints bit-exact, float max abs err {err:g}")

    # K6: every output bit-exact.
    out_k = kernels.slot_resolve_stream(*k6_args)
    out_p = kernels.slot_resolve_stream_plain(*k6_args)
    torch.cuda.synchronize()
    check_outputs("K6", out_k, out_p, ("k2", "w", "wsdf", "cnt", "key",
                                       "valid", "run_slots"), ())
    cube, cam, gate_near = k6_args[1], k6_args[2], k6_args[13]
    S6, R6 = k6_args[5].shape
    M6 = k6_args[3].shape[0]
    n_valid = int(out_k[5].sum())
    report["slot_resolve_stream"] = dict(
        err=0.0, **kernel_times(
            "slot_resolve_stream",
            lambda: kernels.slot_resolve_stream(*k6_args),
            lambda: kernels.slot_resolve_stream_plain(*k6_args)),
        # inputs: the run keys, four 4-byte (S, R) planes (run_idx, local,
        # w, wsdf), the 1-byte valid flags, labels (4 B) and informative
        # flags (1 B) per ray, the cubes and camera blocks, and wc only
        # where gate_near reads it (valid steps); outputs: five 4-byte
        # (S, R) planes, the 1-byte valid flags and the run slots. ops:
        # integer and float ops per run and per step.
        bytes=4 * M6 * R6 + 17 * S6 * R6 + 5 * R6 + 4 * cube.numel()
        + 4 * cam.numel() + (4 * n_valid if gate_near else 0)
        + 21 * S6 * R6 + 4 * M6 * R6,
        ops=R6 * (20 * M6 + 16 * S6))
    print(f"[K6 slot_resolve_stream] R={R6} S={S6} MAXR={M6} cube "
          f"{tuple(cube.shape)} gate_near={gate_near}: all seven outputs "
          f"bit-exact; {n_valid} valid steps, "
          f"{int((out_k[6] >= 0).sum())} resolved runs")

    # K5: the captured packed staging, then dense and onehot forms of the
    # same votes at the same rows.
    slots, d_w, d_wsdf, d_cnt, _, d_wc = k5_args[5:11]
    lk, d_packed = k5_kw["lk_delta"], k5_kw["d_sem"]
    P = d_packed.shape[0]
    L = g.num_labels
    cr = torch.floor(d_packed * (1.0 / 32.0))
    lr = (d_packed - 32.0 * cr).long()
    dense = torch.zeros((L,) + d_w.shape, dtype=torch.float32, device=dev)
    dense.scatter_add_(0, lr, cr)           # integral counts: exact
    d_lab = lr[0].to(torch.int32)
    live = (torch.div(slots[::8], 8, rounding_mode="floor")
            != (g.padded_rows - 8) // 8)
    rows = live.repeat_interleave(8)
    Kb, V3 = d_w.shape
    n_live = int(rows.sum())
    nz = lambda x: int((x[rows] != 0).sum())  # noqa: E731
    rmw_base = 8 * (nz(d_w) + nz(d_wsdf) + nz(d_cnt))
    forms = {
        "packed": (dict(d_sem=d_packed, sem_packed_ranks=P), None,
                   4 * n_live * V3 * (3 + P), 8 * int((cr[:, rows] > 0)
                                                        .sum()), P),
        "dense": (dict(d_sem=dense), None, 4 * n_live * V3 * (3 + L),
                  8 * nz(dense.transpose(0, 1)), L),
        "onehot": ({}, d_lab, 4 * n_live * V3 * 4, 8 * nz(d_cnt), 1),
    }
    base = [getattr(grid, c) for c in CHANNELS]
    k5 = {form: k5_check(kernels, form, base, slots, (d_w, d_wsdf, d_cnt),
                         lab, d_wc, lk, kw, n_live, delta_bytes, vote_bytes,
                         rmw_base, planes, dev)
          for form, (kw, lab, delta_bytes, vote_bytes, planes)
          in forms.items()}
    report["block_rmw_add"] = dict(k5["packed"], forms=k5)
    del grid, base
    torch.cuda.empty_cache()



def k5_check(kernels, form, base, slots, deltas, lab, d_wc, lk, kw,
             n_live, delta_bytes, vote_bytes, rmw_base, planes, dev):
    """K5 in one vote form against its plain version on clones of the grid
    channels `base` (counts and label planes bit-exact, floats within
    FLOAT_RTOL), then timed with its inputs warm in L2 and with the L2
    flushed before each launch. Returns the report entry."""
    import torch
    Kb, V3 = deltas[0].shape
    args = lambda chs: (*chs, slots, *deltas, lab, d_wc)  # noqa: E731
    ck = [t.clone() for t in base]
    cp = [t.clone() for t in base]
    kernels.block_rmw_add(*args(ck), lk, **kw)
    kernels.block_rmw_add_plain(*args(cp), lk, **kw)
    torch.cuda.synchronize()
    err = check_outputs(f"K5 ({form})", ck, cp, CHANNELS,
                        ("wsum", "wsdf", "wcolor"))
    if torch.equal(ck[3], base[3]):
        fail(f"K5 ({form}) added no vote")
    del cp
    k5 = lambda: kernels.block_rmw_add(*args(ck), lk, **kw)  # noqa: E731
    entry = dict(
        err=err, K=Kb, V3=V3, **kernel_times(
            "block_rmw_add", k5,
            lambda: kernels.block_rmw_add_plain(*args(ck), lk, **kw)),
        cold_ms=cold_device_time(k5, KERNEL_SYMBOLS["block_rmw_add"], REPS,
                                 dev),
        # the live tiles' deltas read once, the slots, and one read and
        # one write of each grid word a nonzero delta or a vote adds to
        bytes=delta_bytes + 4 * Kb + rmw_base + vote_bytes,
        ops=n_live * V3 * (12 + 4 * planes))
    if entry["cold_ms"] is None:
        fail(f"K5 ({form}): no device time with the L2 flushed")
    del ck
    torch.cuda.empty_cache()
    print(f"[K5 block_rmw_add, {form}] Kb={Kb} V3={V3} live rows "
          f"{n_live}: counts and label planes bit-exact, float max abs "
          f"err {err:g}; device {entry['ms']:.5f} ms warm, "
          f"{entry['cold_ms']:.5f} ms with the L2 flushed before each "
          "launch")
    return entry


def atlas_pixels(proj_ops, meta, T_C_G, cfg, intr, plan, rows):
    """The distinct atlas pixels (depth and label) that the voxels of the
    meta rows `rows` sample inside their block's window: the pixels a
    projective apply kernel loads."""
    import torch
    _, _, _, _, _, row, col = proj_ops.voxel_pixels(meta, T_C_G, cfg, intr,
                                                    plan)
    inwin = ((row >= 0) & (row < plan.row_window) & (col >= 0)
             & (col < plan.col_window) & rows[:, None])
    pixel = ((meta[:, :1] + row) * plan.atlas_width + meta[:, 1:2] + col)
    return int(torch.unique(pixel[inwin]).numel())


def k4_check(kernels, proj_ops, label, cfg, intr, plan, meta, fslots, T_C_G,
             atlas):
    """K4 (projective_sample_update) against its plain version on the tiles
    K5 reads (slot group not the trash group): d_lab and d_cnt bit-exact,
    d_w and d_wsdf within FLOAT_RTOL; timed. Returns the report entry."""
    import torch
    g = cfg.grid
    args = (meta, fslots, T_C_G, atlas, cfg, intr, plan)
    got = kernels.projective_sample_update(*args)
    ref = kernels.projective_sample_update_plain(*args)
    torch.cuda.synchronize()
    live = torch.div(fslots, 8, rounding_mode="floor") != g.block_capacity // 8
    err = check_outputs(f"K4 ({label})", [x[live] for x in got[:4]],
                        [x[live] for x in ref[:4]],
                        ("d_w", "d_wsdf", "d_cnt", "d_lab"),
                        ("d_w", "d_wsdf"))
    if got[4] is not None or not bool(got[0][live].any()):
        fail(f"K4 ({label}): no update, or colour deltas outside COLOR mode")
    K, V3 = meta.shape[0], g.vps3
    n_live = int(live.sum())
    real = live & (meta[:, 2] > 0)
    n_px = atlas_pixels(proj_ops, meta, T_C_G, cfg, intr, plan, real)
    n_upd = int((got[0][live] != 0).sum())
    print(f"[K4 projective_sample_update, {label}] K={K} V3={V3}: live rows "
          f"{n_live}, real rows {int(real.sum())}, updated voxels {n_upd}, "
          f"atlas pixels read {n_px}; labels and counts bit-exact, float "
          f"max abs err {err:g}")
    del got, ref
    return dict(
        err=err, K=K, V3=V3, **kernel_times(
            "projective_sample_update",
            lambda: kernels.projective_sample_update(*args),
            lambda: kernels.projective_sample_update_plain(*args)),
        # the four delta planes of the live tiles written once, meta and
        # slots read, and the depth and label of each atlas pixel sampled
        bytes=16 * n_live * V3 + K * 36 + 2 * 4 * n_px,
        ops=60 * int(real.sum()) * V3)


PROJECTIVE_KERNELS = ("dda_job_stream", "block_meta", "projective_apply_fused",
                      "hash_insert", "hash_lookup")
# The hash kernels' launches per projective frame: the frame list's insert
# (H2) and its lookup (H1).
PROJ_HASH = dict(hash_insert=1, hash_lookup=1)
# ... per fast or merged frame with the projective carve: the carve's frame
# list (H2, H1), the runs' insert (H2) and the camera cube's lookup (H1).
RAY_HASH = dict(hash_insert=2, hash_lookup=2)


# The modules that look blocks up outside the integrators (grid/blocks.py
# lookup_slots, one H1 launch a call): the mesh's neighbour lookup, the
# map's save, ICP and the grid audit.
LOOKUP_CALLERS = frozenset(f"kimera_semantics_tpu_torch/{m}.py" for m in (
    "ops/mesh", "io/vxblx", "ops/icp", "utils/checks"))


@contextlib.contextmanager
def block_lookups():
    """Count the calls of grid/blocks.py lookup_slots with at least one key,
    by calling module (on any thread: the mesh cycle collects on a worker).
    Yields the counts, {module path: calls}."""
    import threading
    from kimera_semantics_tpu_torch.grid import blocks as gblocks
    real = gblocks.lookup_slots
    calls, lock = {}, threading.Lock()

    def counted(grid, block_coords, cfg, rounds=0):
        if block_coords.numel():
            caller = os.path.relpath(sys._getframe(1).f_code.co_filename,
                                     ROOT)
            with lock:
                calls[caller] = calls.get(caller, 0) + 1
        return real(grid, block_coords, cfg, rounds)
    gblocks.lookup_slots = counted
    try:
        yield calls
    finally:
        gblocks.lookup_slots = real


def check_launches(label, counts, want, lookups=None):
    """Fail unless the launch counts equal `want`. `lookups`, block_lookups'
    counts, adds one H1 launch a call, and every call must come from
    LOOKUP_CALLERS: the integrators' own lookups are in `want`."""
    want = dict(want)
    if lookups is not None:
        stray = sorted(set(lookups) - LOOKUP_CALLERS)
        if stray:
            fail(f"{label}: blocks looked up from {stray}: {lookups}")
        want["hash_lookup"] += sum(lookups.values())
    if dict(counts) != want:
        fail(f"{label}: launches {counts}, expected {want}"
             + (f" (block lookups {lookups})" if lookups is not None
                else ""))
# Each kernel's slice and the path of that slice whose run gives its
# "launches": the projective main path (K1-K3), the fast integrator (K5,
# K6), the serving output's CLI at 32^3 literal storage (K4) and the
# scatter-strategy profiling tool's warm-kernel probe (K7); the hash
# kernels (H1, H2) run on every path, and their slice's is the projective.
MAIN_PATH = {"dda_job_stream": "projective", "block_meta": "projective",
             "projective_apply_fused": "projective",
             "projective_sample_update": "cli_vps32",
             "slot_resolve_stream": "fast", "block_rmw_add": "fast",
             "add_f32": "scatter_profile", "hash_lookup": "projective",
             "hash_insert": "projective"}


def traced_profile(model, cfg, intr, frames, dev, stages, ms, tag,
                   outer=None):
    """Trace the timed loop of `model` once more on a fresh grid with
    torch.profiler; print each stage's host ms per frame, the device's busy
    time and idle share of the untraced `ms`, and each kernel's device ms
    per frame in the loop."""
    import torch
    from kimera_semantics_tpu_torch.grid import blocks
    n = len(frames) - WARM_FRAMES
    tgrid = blocks.create(cfg, device=dev)
    for f in frames[:WARM_FRAMES]:
        model.integrate_frame(tgrid, f, cfg, intr, device=dev)
    torch.cuda.synchronize()
    traced = {}

    def traced_loop():
        t0 = time.perf_counter()
        for f in frames[WARM_FRAMES:]:
            model.integrate_frame(tgrid, f, cfg, intr, device=dev)
        torch.cuda.synchronize()
        traced["ms"] = 1e3 * (time.perf_counter() - t0) / n
    events = trace(traced_loop)
    del tgrid
    st = stage_ms(events, stages, n, outer)
    dev_ms = {k: sum(e.time_range.elapsed_us()
                     for e in device_events(events) if sym in e.name)
              / 1e3 / n
              for k, sym in KERNEL_SYMBOLS.items() if k != "empty"}
    busy = busy_ms(events) / n
    print(f"[{tag}] host ms/frame under the profiler ({traced['ms']:.3f} "
          "ms/frame traced): " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in st.items()))
    print(f"[{tag} device] busy {busy:.3f} ms/frame (trace), idle share "
          f"{1 - busy / ms:.4f} of the untraced {ms:.3f} ms/frame; kernel "
          "device ms/frame in the loop: " + ", ".join(
              f"{k} {v:.5f}" for k, v in dev_ms.items()))


# sim-eval --preset eval, as the JAX package gives it on the CPU for the
# same label map (the preset's CSV is absent, so both sides take
# LabelColorMap.random(21)):
#   JAX_PLATFORMS=cpu python -m kimera_semantics_tpu.server.node sim-eval \
#       --preset eval --mesh-out ""
SIM_EVAL_REF = {"rmse_tsdf": 0.07861868292093277,
                "label_accuracy": 0.9325676656642123,
                "mesh_error_mean": 0.005379501264542341}
SIM_EVAL_RTOL = 0.02        # rmse_tsdf and mesh_error.mean, relative
SIM_EVAL_LABEL_ATOL = 0.005  # label_accuracy, absolute


@contextlib.contextmanager
def stdout_to_stderr():
    """The CLI's own JSON line goes to stderr: this script's standard
    output carries only its own lines."""
    with contextlib.redirect_stdout(sys.stderr):
        yield


def literal32_config(kt, cfg):
    """The canonical configuration on 32^3 blocks stored literally: the
    block capacity the CLI gives --storage-vps 32 (clamped to the int32
    segment-key budget of 21 labels)."""
    from kimera_semantics_tpu_torch.server import node
    args = node.parse_args(["batch", "unused", "--preset", "demo",
                            "--method", "projective", "--storage-vps", "32"])
    with stdout_to_stderr(), contextlib.redirect_stderr(open(os.devnull,
                                                             "w")):
        c32, _ = node._build(args)
    return dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, voxels_per_side=32,
        block_capacity=c32.grid.block_capacity))


def k4_k5_pair(kernels, proj, proj_ops, c, intr, frame, dev, label,
               check_k4):
    """One frame's list on a fresh grid of configuration `c`, K4's deltas
    (checked and timed against its plain version when `check_k4`), then K5
    in onehot form on those deltas into the grid: the unfused route's pair.
    Returns the K4 entry (or None) and the K5 entry."""
    import torch
    from kimera_semantics_tpu_torch.core import transforms
    from kimera_semantics_tpu_torch.grid import blocks
    from kimera_semantics_tpu_torch.ops import mip as mip_ops
    from kimera_semantics_tpu_torch.ops import semantic as sem_ops
    plan = proj.make_plan(c, intr)
    atlas = mip_ops.build_atlas(frame.depth, frame.labels, frame.colors,
                                plan)
    grid = blocks.create(c, device=dev)
    grid, fcoords, fslots, freal = proj.allocate_from_atlas(
        grid, atlas, frame.T_G_C, c, intr, plan)
    T_C_G = transforms.inverse(frame.T_G_C)
    meta = kernels.block_meta(fcoords, freal, T_C_G, intr, plan,
                              c.grid.block_size)
    out = (k4_check(kernels, proj_ops, label, c, intr, plan, meta, fslots,
                    T_C_G, atlas) if check_k4 else None)
    # K5 reads only the live tiles (slot group not the trash group); K4
    # leaves the others unwritten.
    d_w, d_wsdf, d_cnt, d_lab, _ = kernels.projective_sample_update(
        meta, fslots, T_C_G, atlas, c, intr, plan)
    rows = (torch.div(fslots, 8, rounding_mode="floor")
            != c.grid.block_capacity // 8)
    nz = lambda x: int((x[rows] != 0).sum())  # noqa: E731
    n_live, V3 = int(rows.sum()), c.grid.vps3
    lk = sem_ops.make_likelihood_cached(c).delta
    k5 = k5_check(kernels, f"onehot, {label}", [getattr(grid, ch) for ch in
                                                CHANNELS],
                  fslots, (d_w, d_wsdf, d_cnt), d_lab, None, lk, {}, n_live,
                  4 * n_live * V3 * 4, 8 * nz(d_cnt),
                  8 * (nz(d_w) + nz(d_wsdf) + nz(d_cnt)), 1, dev)
    del grid, d_w, d_wsdf, d_cnt, d_lab
    torch.cuda.empty_cache()
    return out, k5


# The unfused route at an odd vps (V3 % 8 != 0, K5's generic instance): vps
# 5 with fused_apply=False, and vps 21 (V3 9261, past the fused kernel's
# limit, so unfused whatever fused_apply says); blocks of the canonical
# 0.8 m, so the frame lists keep the canonical size.
ODD_VPS = ((5, False), (21, True))


def odd_vps_phase(kernels, proj, proj_ops, cfg, intr, frames, dev, launches):
    """Two projective frames at each ODD_VPS configuration through K1, K2,
    K4 and K5 (the launches checked), held bit for bit and block by block
    to a plain run on the card; then K4's generic instance checked and
    timed on the first frame's list, and K5's generic instance on its
    deltas. Returns K4's and K5's report entries."""
    import torch
    from kimera_semantics_tpu_torch.grid import blocks
    k4, variants = {}, {}
    for vps, fused in ODD_VPS:
        c = dataclasses.replace(
            cfg, grid=dataclasses.replace(cfg.grid, voxels_per_side=vps,
                                          voxel_size=0.8 / vps),
            pipeline=dataclasses.replace(cfg.pipeline, fused_apply=fused))
        tag = f"vps{vps}"
        grid, counts, ms = drive(proj, c, intr, frames, 0, 2, dev, dict(
            dda_job_stream=1, block_meta=1, projective_sample_update=1,
            block_rmw_add=1, **PROJ_HASH))
        launches[tag] = counts
        ref = blocks.create(c, device=dev)
        plain_run(kernels, proj, ref, c, intr, frames[:2], dev)
        _, n_seen, labels = compare_grids(grid, ref, c, CHANNELS, tag)
        print(f"[{tag}] V3 {c.grid.vps3}, fused_apply={fused}: 2 frames, "
              f"{ms:.3f} ms/frame host clock; launches {counts}; "
              f"n_blocks {int(grid.n_blocks)} overflow "
              f"{int(grid.overflow)}; grid equal to the plain run's bit "
              f"for bit, block by block; observed voxels {n_seen}, labels "
              f"{labels}")
        del grid, ref
        torch.cuda.empty_cache()
        k4[tag], variants[f"onehot, {tag}, generic"] = k4_k5_pair(
            kernels, proj, proj_ops, c, intr, frames[0], dev, tag, True)
    return k4, variants


WIRE_WARM, WIRE_FRAMES = 2, 8   # [wire]: warm-up and timed frames


def wire_phase(kernels, proj, mip_ops, cfg, intr, frames, dev, launches):
    """The u16 wire atlas codec on the card: the first frame's atlas
    encoded there equals the same atlas encoded on the CPU plane for plane
    (dtype and value), and decodes alike; then WIRE_WARM + WIRE_FRAMES
    canonical projective frames with integrate_frame(..., wire_sim=True)
    (K1-K3 once per frame, timed on the host clock beside the float32
    route on the same frames), the grid held block by block to a plain run
    with wire_sim=True (counts and label planes exactly, floats within
    FLOAT_RTOL) and shown to differ from the float32 route's."""
    import torch
    from kimera_semantics_tpu_torch.grid import blocks
    plan = proj.make_plan(cfg, intr)
    f0 = frames[0]
    atlas = mip_ops.build_atlas(f0.depth, f0.labels, f0.colors, plan)
    card = mip_ops.wire_encode(atlas, cfg)
    cpu = mip_ops.wire_encode(atlas.cpu(), cfg)
    for i, (a, b) in enumerate(zip(card, cpu)):
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
            fail(f"wire: plane {i} encoded on the card differs from the CPU's")
    if not torch.equal(mip_ops.atlas_from_wire(card, cfg).cpu(),
                       mip_ops.atlas_from_wire(cpu, cfg)):
        fail("wire: the atlas decoded on the card differs from the CPU's")
    wire_bytes = sum(x.numel() * x.element_size() for x in card)
    n = WIRE_WARM + WIRE_FRAMES
    expect = dict(dda_job_stream=1, block_meta=1, projective_apply_fused=1,
                  **PROJ_HASH)
    grid, counts, wms = drive(proj, cfg, intr, frames[:n], WIRE_WARM,
                              WIRE_FRAMES, dev, expect, wire_sim=True)
    launches["wire"] = counts
    f32, _, fms = drive(proj, cfg, intr, frames[:n], WIRE_WARM,
                        WIRE_FRAMES, dev, expect)
    ref = blocks.create(cfg, device=dev)
    plain_run(kernels, proj, ref, cfg, intr, frames[:n], dev, wire_sim=True)
    worst, n_seen, labels = compare_grids(grid, ref, cfg,
                                          ("sem_count", "sem_delta"), "wire")
    del ref
    g = cfg.grid
    coords = grid.block_coords[:int(grid.n_blocks)]
    s_w = blocks.lookup_slots(grid, coords, g).long()
    s_f = blocks.lookup_slots(f32, coords, g).long()
    both = s_f < g.block_capacity
    moved = max_abs_err(grid.wsdf[s_w[both]], f32.wsdf[s_f[both]])
    if moved == 0.0:
        fail("wire: the grid equals the float32 route's (no codec applied)")
    print(f"[wire] {WIRE_FRAMES} frames with wire_sim=True: {wms:.3f} "
          f"ms/frame host clock, float32 route {fms:.3f} ms/frame on the same "
          f"frames; launches {counts}; planes encoded on the card equal the "
          f"CPU's ({wire_bytes} B a frame against "
          f"{atlas.numel() * atlas.element_size()} B of float32 atlas); grid "
          f"equal to the plain run's (counts and label planes exact, float "
          f"max abs {worst:g}), wsdf up to {moved:g} from the float32 "
          f"route's; observed voxels {n_seen}, labels {labels}")
    del grid, f32
    torch.cuda.empty_cache()


def tsdf_words(vxblx, grid, cfg):
    """The grid's TSDF section, blocks sorted by origin: (origins, dist,
    weight, color words)."""
    import numpy as np
    sec = vxblx.grid_to_tsdf_section(grid, cfg)
    order = np.lexsort(sec.block_origins.T[::-1])
    w = sec.voxel_data[order].reshape(len(order), -1, 3)
    return (sec.block_origins[order], w[..., 0].view(np.float32), w[..., 1],
            w[..., 2])


def cli_phase(kt, kernels, intr, label_map, dev, launches):
    """`node batch --preset demo --method projective --storage-vps 32` on
    4 + 24 frames written by save_directory_dataset: no overflow, a
    non-empty PLY, K4 and K5 once per frame and K3 never, and a .vxblx
    that reloads to the grid's TSDF voxels."""
    import numpy as np
    import torch
    from kimera_semantics_tpu_torch.io import ply, vxblx
    from kimera_semantics_tpu_torch.io.dataset import (
        SyntheticDataset, save_directory_dataset)
    from kimera_semantics_tpu_torch.server import node
    n = WARM_FRAMES + FRAMES
    tmp = tempfile.mkdtemp(prefix="ksd_smoke_")
    try:
        t0 = time.time()
        save_directory_dataset(
            os.path.join(tmp, "frames"),
            SyntheticDataset(num_frames=n, intr=intr, label_map=label_map,
                             device=dev))
        print(f"[cli] {n} frames {intr.width}x{intr.height} written in "
              f"{time.time() - t0:.1f} s")
        mesh_path = os.path.join(tmp, "mesh.ply")
        map_path = os.path.join(tmp, "map.vxblx")
        args = node.parse_args(["batch", os.path.join(tmp, "frames"),
                                "--preset", "demo", "--method", "projective",
                                "--storage-vps", "32", "--mesh-out",
                                mesh_path, "--map-out", map_path])
        torch.cuda.synchronize()
        kernels.reset_launches()
        with stdout_to_stderr(), block_lookups() as lookups:
            srv, out = node.cmd_batch(args, streaming=False)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        launches["cli_vps32"] = counts
        want = {k: (n if k in ("dda_job_stream", "block_meta",
                               "projective_sample_update", "block_rmw_add",
                               "hash_insert", "hash_lookup")
                    else 0) for k in counts}
        check_launches("cli", counts, want, lookups)
        print(f"[cli] H1 launches: {n} by the integrator, "
              f"{sum(lookups.values())} by block lookups {lookups}")
        if out["overflow"] != 0 or out["triangles"] <= 0:
            fail(f"cli: overflow {out['overflow']}, triangles "
                 f"{out['triangles']}")
        if len(ply.read_ply(mesh_path)[2]) != out["triangles"]:
            fail("cli: the PLY does not hold the mesh")
        cfg = srv.cfg
        a = tsdf_words(vxblx, srv.grid, cfg)
        b = tsdf_words(vxblx, vxblx.load_vxblx(map_path, cfg, device=dev),
                       cfg)
        # The reload stores wsdf = dist * weight, so its distance can
        # round once: |dist| within 1e-6 m, weights exact, colour channels
        # within 1.
        col = lambda w: np.stack([(w >> s) & 0xFF for s in (24, 16, 8)])  # noqa: E731
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[2], b[2])
                and np.abs(a[1] - b[1]).max() <= 1e-6
                and np.abs(col(a[3]).astype(int) - col(b[3])).max() <= 1):
            fail("cli: the .vxblx does not reload to the grid's TSDF voxels")
        print(f"[cli] batch --preset demo --method projective --storage-vps "
              f"32 (V3={cfg.grid.vps3}, capacity {cfg.grid.block_capacity}):"
              f" {out['frames']} frames at {out['frames_per_s']:.2f} frames/s"
              f" (utils/timing, frame decode included); blocks "
              f"{out['blocks']} overflow {out['overflow']} triangles "
              f"{out['triangles']}; launches {counts}; .vxblx reloads to "
              f"the same {len(a[0])} blocks' TSDF voxels")
        del srv
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


def welded(mesh, voxel_size):
    import numpy as np
    q = np.round(mesh.vertices / (voxel_size / 1024.0)).astype(np.int64)
    return (set(map(tuple, q)),
            {tuple(sorted(map(tuple, q[t]))) for t in mesh.triangles})


def serve_phase(kt, kernels, intr, frames, dev, launches):
    """The stream server at the demo preset (fast, 0.05 m voxels, 32-voxel
    blocks on 16^3 storage tiles, the CLI's capacity), meshing every 5
    frames through the pipelined cycle; the snapshot check; the cache
    against generate_mesh; a .ksdv round trip."""
    import numpy as np
    import torch
    from kimera_semantics_tpu_torch.grid import blocks
    from kimera_semantics_tpu_torch.io import serial
    from kimera_semantics_tpu_torch.ops import mesh as mesh_ops
    from kimera_semantics_tpu_torch.server import node
    from kimera_semantics_tpu_torch.server.pipeline import (
        SemanticTsdfServer, ServerConfig)
    from kimera_semantics_tpu_torch.utils import timing
    args = node.parse_args(["stream", "unused", "--preset", "demo"])
    with stdout_to_stderr(), contextlib.redirect_stderr(open(os.devnull,
                                                             "w")):
        cfg, lmap = node._build(args)
    tmp = tempfile.mkdtemp(prefix="ksd_serve_")
    try:
        srv = SemanticTsdfServer(cfg, intr, lmap, ServerConfig(
            mesh_every_n_frames=5,
            live_mesh_path=os.path.join(tmp, "live.ply")), device=dev)
        for f in frames[:WARM_FRAMES]:
            srv.insert_frame(f)
        srv.join_mesh()
        torch.cuda.synchronize()
        stall0, cycles0, n_cyc0 = srv.mesh_stall_s, srv.mesh_cycles, len(
            srv.mesh_cycle_s)
        t_int = f"integrate/{cfg.integrator.value}"
        int0 = timing.get(t_int)[0]
        kernels.reset_launches()
        t0 = time.perf_counter()
        with block_lookups() as lookups:
            for f in frames[WARM_FRAMES:]:
                srv.insert_frame(f)
            srv.join_mesh()
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        int_s = timing.get(t_int)[0] - int0
        counts = dict(kernels.launches)
        launches["serve"] = counts
        n = len(frames) - WARM_FRAMES
        # Per frame: K6 per job stream (band, and carve jobs when
        # decimated), K1 per stream and once more for the projective
        # carve's allocation, K2 + K3 for that carve, K5 once.
        mode = cfg.tsdf.carve_mode
        streams = 2 if mode == "decimated" else 1
        # H2 for the runs' insert and H1 for the cube, both once more for
        # the projective carve's frame list; the mesh cycles' lookups add
        # theirs.
        carve = int(mode == "projective")
        want = dict(dda_job_stream=streams + carve, block_meta=carve,
                    projective_apply_fused=carve,
                    slot_resolve_stream=streams, block_rmw_add=1,
                    hash_insert=1 + carve, hash_lookup=1 + carve)
        want = {k: want.get(k, 0) * n for k in counts}
        check_launches("serve", counts, want, lookups)
        st = srv.stats()
        cyc = srv.mesh_cycle_s[n_cyc0:]
        if st["overflow"] != 0 or not cyc:
            fail(f"serve: overflow {st['overflow']}, {len(cyc)} cycles")
        tris = srv.mesh_cache.full_mesh().num_triangles
        n_cyc = srv.mesh_cycles - cycles0
        print(f"[serve] demo preset (fast, carve_mode {mode}, band density "
              f"{cfg.tsdf.band_density}, V3={cfg.grid.vps3} storage of "
              f"{cfg.grid.io_vps}^3 blocks, capacity "
              f"{cfg.grid.block_capacity}), mesh every 5 frames: {n} frames "
              f"in {sec:.3f} s, {n / sec:.2f} frames/s with meshing; cycles "
              f"{n_cyc}, dispatch->collect mean "
              f"{1e3 * sum(cyc) / len(cyc):.2f} ms (max "
              f"{1e3 * max(cyc):.2f}); mesh_stall_s "
              f"{srv.mesh_stall_s - stall0:.4f}; triangles {tris}; overflow "
              f"{st['overflow']} dropped_rays {st['dropped_rays']}; launches "
              f"{counts}; block lookups (H1 launches beyond the "
              f"integrator's) {lookups}")
        # integrate/<method> ends each frame in a synchronize, so it holds
        # the device work of the cycles enqueued before it; the rest of the
        # loop is the cycles' dispatch on the host.
        print(f"[serve split] integrate {1e3 * int_s / n:.3f} ms/frame "
              f"(utils/timing, synchronized); the rest "
              f"{1e3 * (sec - int_s) / max(n_cyc, 1):.3f} ms per cycle "
              f"(dispatch and stalls)")

        # Snapshot check: a cycle dispatched, a frame integrated at once,
        # then collected, equals a synchronous mesh of the grid as it was.
        snap = blocks.VoxelGrid(**{k: getattr(srv.grid, k).clone()
                                   for k in blocks.FIELDS})
        collect = mesh_ops.extract_mesh_cycle_async(
            srv.grid, cfg, lmap, only_updated=True, return_blocks=True,
            hold_grid=False)
        srv.integrator.integrate(srv.grid, frames[0])
        got = collect()
        ref = mesh_ops.extract_mesh(snap, cfg, lmap, only_updated=True,
                                    return_blocks=True)
        del snap
        torch.cuda.empty_cache()
        if got is None or not (
                np.array_equal(got[0].vertices, ref[0].vertices)
                and np.array_equal(got[0].colors, ref[0].colors)
                and np.array_equal(got[1], ref[1])
                and np.array_equal(got[2], ref[2])):
            fail("serve: the async cycle did not mesh the grid as it was at "
                 "dispatch")
        now = mesh_ops.extract_mesh(srv.grid, cfg, lmap, only_updated=True)
        changed = now.num_triangles != ref[0].num_triangles or \
            not np.array_equal(now.vertices, ref[0].vertices)
        print(f"[serve snapshot] cycle dispatched, one frame integrated, "
              f"then collected: {got[0].num_triangles} triangles equal to "
              f"the grid's as at dispatch (the grid's mesh changed since: "
              f"{changed})")

        # The cache keeps each block's triangles from the update that last
        # meshed it, as voxblox's MeshLayer and the JAX package do: a block
        # whose +x/+y/+z neighbour changed since keeps its old triangles on
        # that face (a seam). So the cache is held to generate_mesh after a
        # final update_mesh over every allocated block, and the seams of
        # the incremental updates are counted before it.
        srv.update_mesh()
        vs = cfg.grid.voxel_size
        gen = srv.generate_mesh()
        seams = len(welded(srv.mesh_cache.full_mesh(), vs)[1]
                    ^ welded(gen, vs)[1])
        srv.grid.updated[:int(srv.grid.n_blocks)] = True
        srv.update_mesh()
        full = srv.mesh_cache.full_mesh()
        if gen.num_triangles != full.num_triangles or \
                welded(full, vs) != welded(gen, vs):
            fail("serve: the mesh cache differs from generate_mesh")
        print(f"[serve cache] MeshLayerCache after a final update_mesh of "
              f"every block: {full.num_triangles} triangles, equal to "
              f"generate_mesh as welded vertex and triangle sets (before it, "
              f"{seams} triangles of the two sets differed: the seams of "
              f"blocks not re-meshed since a neighbour changed)")

        path = os.path.join(tmp, "map.ksdv")
        t0 = time.time()
        srv.save_map(path)
        back = serial.load_grid(path, cfg, device=dev)
        for k in blocks.FIELDS:
            if not torch.equal(getattr(back, k), getattr(srv.grid, k)):
                fail(f"serve: .ksdv round trip changed {k}")
        print(f"[serve ksdv] {os.path.getsize(path) / 2**30:.2f} GiB saved "
              f"and loaded in {time.time() - t0:.1f} s: every channel "
              f"exact")
        del back, srv
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


def sim_eval_phase():
    """sim-eval --preset eval on the card against the JAX package's CPU
    values (SIM_EVAL_REF)."""
    from kimera_semantics_tpu_torch.server import node
    args = node.parse_args(["sim-eval", "--preset", "eval", "--mesh-out",
                            ""])
    t0 = time.time()
    with stdout_to_stderr():
        srv, out = node.cmd_sim_eval(args)
    got = {"rmse_tsdf": out["rmse_tsdf"],
           "label_accuracy": out["label_accuracy"],
           "mesh_error_mean": out["mesh_error"]["mean"]}
    ref = SIM_EVAL_REF
    ok = (abs(got["rmse_tsdf"] - ref["rmse_tsdf"])
          <= SIM_EVAL_RTOL * ref["rmse_tsdf"]
          and abs(got["mesh_error_mean"] - ref["mesh_error_mean"])
          <= SIM_EVAL_RTOL * ref["mesh_error_mean"]
          and abs(got["label_accuracy"] - ref["label_accuracy"])
          <= SIM_EVAL_LABEL_ATOL and out["overflow"] == 0)
    if not ok:
        fail(f"sim-eval: {got} against the JAX package's {ref}")
    print(f"[sim-eval] --preset eval ({out['frames']} viewpoints, "
          f"{time.time() - t0:.1f} s): rmse_tsdf {got['rmse_tsdf']!r}, "
          f"label_accuracy {got['label_accuracy']!r}, mesh_error mean "
          f"{got['mesh_error_mean']!r}; the JAX package on the CPU: "
          f"{ref}; within {SIM_EVAL_RTOL:.0%} relative and "
          f"{SIM_EVAL_LABEL_ATOL} on label accuracy")
    del srv


K7_ROUNDS = 7   # alternating K7 / torch.add device timings


def k7_check(kernels, dev, report):
    """K7 add_f32 at the probe's shape, (8, 128) float32, bit-exact against
    its plain version, then timed beside torch.add on the same tensors in
    K7_ROUNDS alternating rounds (K7, torch.add, K7, ...; each a profiler
    trace of REPS launches): the medians go to the report, the spreads
    (max - min over the rounds) are printed beside them."""
    import numpy as np
    import torch
    rng = np.random.RandomState(7)
    x, y = (torch.tensor(rng.standard_normal((8, 128)).astype(np.float32),
                         device=dev) for _ in range(2))
    got = kernels.add_f32(x, y)
    ref = kernels.add_f32_plain(x, y)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        fail(f"K7 add_f32: kernel and plain differ at "
             f"{int((got != ref).sum())} entries")
    k7 = lambda: kernels.add_f32(x, y)  # noqa: E731
    lib = lambda: torch.add(x, y)  # noqa: E731
    rounds = {"k7": [], "torch.add": []}
    for _ in range(K7_ROUNDS):
        for key, fn, sym in (("k7", k7, KERNEL_SYMBOLS["add_f32"]),
                             ("torch.add", lib, "add")):
            ms = device_time(fn, sym, REPS)
            if ms is None:
                fail(f"K7 timing: no device time for {key} in the trace")
            rounds[key].append(ms)
    med = {k: sorted(v)[len(v) // 2] for k, v in rounds.items()}
    spread = {k: max(v) - min(v) for k, v in rounds.items()}
    t = kernel_times("add_f32", k7, lambda: kernels.add_f32_plain(x, y))
    t.update(ms=med["k7"], timed_by=f"profiler, median of {K7_ROUNDS} "
             "alternating rounds")
    report["add_f32"] = dict(
        err=0.0, **t, library_ms=med["torch.add"], rounds=rounds,
        # two inputs read and one output written once; one add each
        bytes=3 * 4 * x.numel(), ops=x.numel())
    print(f"[K7 add_f32] (8, 128) float32: bit-exact against x + y; "
          f"{K7_ROUNDS} alternating rounds of {REPS} launches, device ms "
          f"median [spread]: K7 {med['k7']:.5f} [{spread['k7']:.5f}], "
          f"torch.add {med['torch.add']:.5f} [{spread['torch.add']:.5f}]; "
          f"rounds {json.dumps(rounds)}")


def scatter_phase(kernels, dev, launches):
    """tools/profile_scatter at its full size with --warm-kernel and 8
    timed calls per strategy: K7 launched exactly once, every strategy's
    channels equal to (calls) x one reference indexed add (exact: every
    value is 1 or 0.5)."""
    import torch
    from kimera_semantics_tpu_torch.tools import profile_scatter as ps
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.time()
    res = ps.run(frames=8, smoke=False, device=dev, warm_kernel=True,
                 log=lambda line: print(f"[scatter] {line}"))
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    launches["scatter_profile"] = counts
    if counts != {k: int(k == "add_f32") for k in counts}:
        fail(f"scatter: launches {counts}, expected add_f32 once")
    ref = ps.reference(res["segments"])
    k = res["frames"] + 1
    for name in ps.STRATEGIES:
        for c, t in res["channels"][name].items():
            if not torch.equal(t, k * ref[c]):
                fail(f"scatter {name}: {c} differs from {k} x the reference "
                     f"(max abs {max_abs_err(t, k * ref[c]):g})")
    seg = res["segments"]
    print(f"[scatter] cap {seg['cap']} V3 {seg['v3']} L {seg['L']} B "
          f"{seg['B']} nseg {seg['nseg']}, {k} calls each in "
          f"{time.time() - t0:.1f} s: every strategy's channels equal {k} x "
          f"one indexed add of the live segments; ms per call " + ", ".join(
              f"{n} {res['ms'][n]:.3f}" for n in ps.STRATEGIES))
    del res, ref
    torch.cuda.empty_cache()


def mode_compare(grid, ref, cfg, mode, label):
    """A plain-mode grid against the segment grid of the same frames, by
    block coordinate: counters and block sets equal, sem_count exact,
    floats within the mode's tolerance (see MODE_TOL). Returns the largest
    float difference."""
    import torch
    from kimera_semantics_tpu_torch.grid import blocks
    g = cfg.grid
    for name in ("n_blocks", "overflow", "dropped_rays"):
        if int(getattr(ref, name)) != int(getattr(grid, name)):
            fail(f"{label}: {name} {int(getattr(grid, name))}, segment "
                 f"{int(getattr(ref, name))}")
    nb = int(grid.n_blocks)
    coords = grid.block_coords[:nb]
    s_a = blocks.lookup_slots(grid, coords, g).long()
    s_b = blocks.lookup_slots(ref, coords, g).long()
    if bool((s_b >= g.block_capacity).any()):
        fail(f"{label}: another block set than the segment run's")
    worst = 0.0
    eps = float(torch.finfo(torch.float32).eps)
    for c in ("wsum", "wsdf", "sem_count", "sem_delta"):
        a, b = getattr(grid, c), getattr(ref, c)
        a, b = (a[:, s_a], b[:, s_b]) if a.dim() == 3 else (a[s_a], b[s_b])
        if c == "sem_count":
            if not torch.equal(a, b):
                fail(f"{label} sem_count: differs from the segment run")
            continue
        d = (a.double() - b.double()).abs()
        if mode == "direct":
            tol = MODE_TOL * (b.double().abs() + float(b.abs().max()))
        elif c == "wsdf":
            tol = 8 * eps * cfg.tsdf.truncation_distance * float(
                ref.wsum[s_b].double().sum())
        else:
            tol = 8 * eps * float(b.double().abs().sum())
        if bool((d > tol).any()):
            fail(f"{label} {c}: max abs difference {float(d.max()):g} "
                 f"against the segment run, over its tolerance")
        worst = max(worst, float(d.max()))
    return worst


def modes_phase(kt, kernels, frames, dev, launches):
    """The fast integrator at bench.py's fast settings over 2 + 8 frames
    with scatter_mode "direct" and "sorted", each grid against the
    "segment" grid of the same frames."""
    import torch
    from kimera_semantics_tpu_torch.models import fast
    fcfg, fintr = ray_config(kt, "fast")
    seg_grid, _, seg_ms = drive(fast, fcfg, fintr, frames, MERGED_WARM,
                                MERGED_FRAMES, dev, dict(
                                    dda_job_stream=2, block_meta=1,
                                    projective_apply_fused=1,
                                    slot_resolve_stream=1, block_rmw_add=1,
                                    **RAY_HASH))
    line = [f"segment {1e3 / seg_ms:.1f}"]
    for mode in ("direct", "sorted"):
        cfg = dataclasses.replace(fcfg, pipeline=dataclasses.replace(
            fcfg.pipeline, scatter_mode=mode))
        # The plain tail: hash-resolved slots (H1 in place of the cube's)
        # and indexed adds, no K5 or K6; the projective carve keeps K1, K2
        # and K3.
        grid, counts, ms = drive(fast, cfg, fintr, frames, MERGED_WARM,
                                 MERGED_FRAMES, dev, dict(
                                     dda_job_stream=2, block_meta=1,
                                     projective_apply_fused=1, **RAY_HASH))
        launches[f"fast_{mode}"] = counts
        worst = mode_compare(grid, seg_grid, fcfg, mode, f"modes {mode}")
        print(f"[modes] fast, scatter_mode {mode}: {MERGED_FRAMES} frames "
              f"{ms:.3f} ms/frame, {1e3 / ms:.1f} frames/s; same "
              f"{int(grid.n_blocks)} blocks and counters as segment, "
              f"sem_count exact, float max abs difference {worst:g}; "
              f"launches {counts}")
        line.append(f"{mode} {1e3 / ms:.1f}")
        del grid
        torch.cuda.empty_cache()
    print("[modes] frames/s: " + ", ".join(line))
    del seg_grid
    torch.cuda.empty_cache()


ROSBAG_TOPICS = ("/tesse/depth_cam/mono/image_raw",
                 "/tesse/seg_cam/rgb/image_raw",
                 "/tesse/depth_cam/camera_info")


def esdf_brute_force(res, grid, cfg, n_samples, max_dist, dev):
    """The ESDF against the exact nearest-seed Euclidean distance at
    `n_samples` seeded observed voxels outside the band (the oracle of
    tests/test_esdf_blocked.py: under one voxel of error); near-surface
    voxels must carry the TSDF itself. Returns (max error, seeds)."""
    import numpy as np
    import torch
    from kimera_semantics_tpu_torch.grid import blocks
    nb = res.block_coords.shape[0]
    vps, v = res.vps, cfg.grid.voxel_size
    trunc = cfg.tsdf.truncation_distance
    tsdf = blocks.tsdf_distance(grid, trunc)[:nb]
    observed = grid.wsum[:nb] > 1e-6
    near = observed & (tsdf.abs() < trunc * 0.99)
    dist = torch.as_tensor(res.distance, device=dev)
    if not torch.equal(dist[near], tsdf[near]):
        fail("bag: the ESDF differs from the TSDF at near-surface voxels")
    li = torch.arange(vps, dtype=torch.float32, device=dev) + 0.5
    local = torch.stack(torch.meshgrid(li, li, li, indexing="ij"),
                        dim=-1).reshape(-1, 3)
    bc = torch.as_tensor(res.block_coords, dtype=torch.float32, device=dev)
    centers = (bc[:, None, :] * vps + local[None]) * v
    seeds, resid = centers[near], tsdf[near].abs()
    cand = torch.nonzero(observed & ~near).cpu().numpy()
    rng = np.random.RandomState(0)
    sel = cand[rng.choice(len(cand), size=min(n_samples, len(cand)),
                          replace=False)]
    sel_t = torch.as_tensor(sel, device=dev)
    pts = centers[sel_t[:, 0], sel_t[:, 1]]
    brute = torch.cat([
        (torch.linalg.vector_norm(pts[i:i + 16, None, :] - seeds[None],
                                  dim=-1) + resid[None]).min(dim=1)[0]
        for i in range(0, len(pts), 16)])
    brute = brute.clamp(0.0, max_dist)
    e = float((dist[sel_t[:, 0], sel_t[:, 1]].abs() - brute).abs().max())
    if e >= v:
        fail(f"bag: ESDF error {e:g} m against brute force, over a voxel")
    return e, int(seeds.shape[0])


def bag_icp_phase(kt, kernels, intr, dev, launches):
    """The reference's rosbag batch at full width: 4 + 24 frames of the
    eval world written to a .bag on the rosbag preset's topics, then
    `node batch <bag> --preset rosbag --esdf` into tsdf_esdf.vxblx and a
    PLY; then ICP on its grid, and the batch again with --enable-icp
    --esdf-every 10."""
    import numpy as np
    import torch
    from kimera_semantics_tpu_torch.core import camera as cam
    from kimera_semantics_tpu_torch.io import rosbag, vxblx
    from kimera_semantics_tpu_torch.io.dataset import SyntheticDataset
    from kimera_semantics_tpu_torch.ops import icp as icp_ops
    from kimera_semantics_tpu_torch.server import node
    from kimera_semantics_tpu_torch.utils import timing
    n = WARM_FRAMES + FRAMES
    lmap = kt.LabelColorMap.random(21)
    tmp = tempfile.mkdtemp(prefix="ksd_bag_")
    try:
        bag = os.path.join(tmp, "scene.bag")
        t0 = time.time()
        rosbag.write_dataset_bag(
            bag, SyntheticDataset(num_frames=n, intr=intr, label_map=lmap,
                                  device=dev),
            depth_topic=ROSBAG_TOPICS[0], semantic_topic=ROSBAG_TOPICS[1],
            cam_info_topic=ROSBAG_TOPICS[2])
        print(f"[bag] {n} frames {intr.width}x{intr.height} written to a "
              f".bag of {os.path.getsize(bag) / 2**20:.1f} MiB in "
              f"{time.time() - t0:.1f} s (16UC1 depth, rgb8 semantics, "
              f"CameraInfo, TF)")
        map_path = os.path.join(tmp, "tsdf_esdf.vxblx")
        mesh_path = os.path.join(tmp, "mesh.ply")
        args = node.parse_args(["batch", bag, "--preset", "rosbag", "--esdf",
                                "--map-out", map_path, "--mesh-out",
                                mesh_path])
        esdf0 = timing.get("esdf/batch")[0]
        torch.cuda.synchronize()
        kernels.reset_launches()
        with stdout_to_stderr(), block_lookups() as lookups:
            srv, out = node.cmd_batch(args, streaming=False)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        launches["bag"] = counts
        cfg, res = srv.cfg, srv.esdf
        esdf_s = timing.get("esdf/batch")[0] - esdf0
        # Per frame (carve_mode "decimated", the preset's): K1 and K6 for
        # the band and the carve jobs, K5 once.
        # H2 and H1 once each (the runs' insert, the cube); the mesh's and
        # the map's block lookups add theirs.
        want = {k: n * dict(dda_job_stream=2, slot_resolve_stream=2,
                            block_rmw_add=1, hash_insert=1,
                            hash_lookup=1).get(k, 0) for k in counts}
        check_launches("bag", counts, want, lookups)
        print(f"[bag] H1 launches: {n} by the integrator, "
              f"{sum(lookups.values())} by block lookups {lookups}")
        if out["overflow"] != 0 or out["triangles"] <= 0 or \
                out["frames"] != n:
            fail(f"bag: {out}")
        err, n_seeds = esdf_brute_force(res, srv.grid, cfg, 300,
                                        args.esdf_max_dist, dev)
        a = tsdf_words(vxblx, srv.grid, cfg)
        b = tsdf_words(vxblx, vxblx.load_vxblx(map_path, cfg, device=dev),
                       cfg)
        col = lambda w: np.stack([(w >> s) & 0xFF for s in (24, 16, 8)])  # noqa: E731
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[2], b[2])
                and np.abs(a[1] - b[1]).max() <= 1e-6
                and np.abs(col(a[3]).astype(int) - col(b[3])).max() <= 1):
            fail("bag: the .vxblx does not reload to the grid's TSDF voxels")
        secs = vxblx.read_sections(map_path)
        ref = vxblx.esdf_to_section(res, cfg)
        if [s.type for s in secs] != ["tsdf", "esdf"] or not (
                np.array_equal(secs[1].block_origins, ref.block_origins)
                and np.array_equal(secs[1].voxel_data.reshape(
                    ref.voxel_data.shape), ref.voxel_data)):
            fail("bag: the .vxblx ESDF layer does not reload to the "
                 "ESDF's words")
        print(f"[bag] batch <bag> --preset rosbag --esdf (fast, carve_mode "
              f"{cfg.tsdf.carve_mode}, V3={cfg.grid.vps3} storage of "
              f"{cfg.grid.io_vps}^3 blocks, capacity "
              f"{cfg.grid.block_capacity}): {out['frames']} frames at "
              f"{out['frames_per_s']:.2f} frames/s (utils/timing, bag decode "
              f"included); blocks {out['blocks']} overflow "
              f"{out['overflow']} dropped_rays {out['dropped_rays']} "
              f"triangles {out['triangles']}; launches {counts}")
        print(f"[bag esdf] {esdf_s:.3f} s (max_dist "
              f"{args.esdf_max_dist} m, {res.block_coords.shape[0]} blocks "
              f"of {res.vps}^3, {res.distance.nbytes + res.observed.nbytes}"
              f" B out, {int(res.observed.sum())} observed voxels); equal "
              f"to the TSDF at near-surface voxels; max error {err:.5f} m "
              f"against brute force over {n_seeds} seeds at 300 sampled "
              f"voxels (bound: one voxel); tsdf_esdf.vxblx "
              f"{os.path.getsize(map_path) / 2**20:.1f} MiB reloads to the "
              f"grid's TSDF voxels and the ESDF's words "
              f"({len(secs[1].block_origins)} ESDF blocks of "
              f"{secs[1].voxels_per_side}^3)")

        # ICP: a held-out view (between the bag's first two) against the
        # grid, its pose perturbed in the camera frame by 3 cm and 1
        # degree, as tests/test_icp.py perturbs it.
        grid, sc = srv.grid, srv.server_cfg
        ds = SyntheticDataset(num_frames=2 * n, intr=intr, label_map=lmap,
                              device=dev)
        f = ds.frame(1)
        T_true = f.T_G_C.float()
        ang = np.deg2rad(1.0) / np.sqrt(3.0)
        xi = torch.tensor([ang, -ang, ang, 0.02, -0.015, 0.015],
                          dtype=torch.float32, device=dev)
        T_pert = T_true @ icp_ops._exp_se3(xi)
        pts_C, valid = cam.backproject(f.depth, intr)
        stride = max(1, sc.icp_subsample)
        pts_C, valid = pts_C[::stride], valid[::stride]
        kw = dict(iters=sc.icp_iters, damping=sc.icp_damping,
                  refine_roll_pitch=sc.icp_refine_roll_pitch,
                  min_match_ratio=sc.icp_min_match_ratio)
        _, rms0, _ = icp_ops.align_to_map(grid, cfg, pts_C, valid, T_pert,
                                          **dict(kw, iters=1))
        T, rms, ratio = icp_ops.align_to_map(grid, cfg, pts_C, valid,
                                             T_pert, **kw)
        torch.cuda.synchronize()
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            icp_ops.align_to_map(grid, cfg, pts_C, valid, T_pert, **kw)
        torch.cuda.synchronize()
        icp_ms = 1e3 * (time.perf_counter() - t0) / reps

        def pose_err(A):
            dt = float(torch.linalg.vector_norm(A[:3, 3] - T_true[:3, 3]))
            c = float(((A[:3, :3] @ T_true[:3, :3].T).trace() - 1) / 2)
            return dt, float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))
        pre, post = pose_err(T_pert), pose_err(T)
        vs = cfg.grid.voxel_size
        # As tests/test_icp.py holds it: the residual at least halved, the
        # rotation error reduced, and the position within a voxel (one
        # view leaves near-null directions of the pose, so the position
        # error need not shrink).
        if not (post[0] < vs and post[1] < pre[1]
                and float(rms) < 0.5 * float(rms0)):
            fail(f"icp: pose error {pre} -> {post} (m, deg), rms "
                 f"{float(rms0):g} -> {float(rms):g}, match ratio "
                 f"{float(ratio):g}")
        print(f"[icp] held-out view, {int(valid.sum())} points (every "
              f"{stride}th pixel), the preset's defaults ({sc.icp_iters} "
              f"iterations): pose error {pre[0] * 100:.2f} cm {pre[1]:.3f} "
              f"deg -> {post[0] * 100:.2f} cm {post[1]:.3f} deg (within "
              f"a voxel, {vs * 100:.0f} cm); rms {float(rms0):.5f} -> "
              f"{float(rms):.5f} m; match ratio {float(ratio):.4f}; "
              f"{icp_ms:.3f} ms per alignment")
        del srv, grid
        torch.cuda.empty_cache()

        args = node.parse_args(["batch", bag, "--preset", "rosbag",
                                "--enable-icp", "--esdf-every", "10",
                                "--mesh-out", ""])
        icp0, up0 = timing.get("icp/align"), timing.get("esdf/update")
        with stdout_to_stderr():
            srv, out2 = node.cmd_batch(args, streaming=False)
        icp1, up1 = timing.get("icp/align"), timing.get("esdf/update")
        n_esdf = up1[1] - up0[1]
        if out2["overflow"] != 0 or out2["frames"] != n or \
                n_esdf != n // 10 or icp1[1] - icp0[1] != n - 1:
            fail(f"bag --enable-icp: {out2}, {n_esdf} ESDF refreshes, "
                 f"{icp1[1] - icp0[1]} alignments")
        print(f"[icp batch] batch <bag> --preset rosbag --enable-icp "
              f"--esdf-every 10: {out2['frames']} frames at "
              f"{out2['frames_per_s']:.2f} frames/s (without ICP "
              f"{out['frames_per_s']:.2f}); {icp1[1] - icp0[1]} alignments, "
              f"{1e3 * (icp1[0] - icp0[0]) / max(icp1[1] - icp0[1], 1):.3f}"
              f" ms each; last match ratio "
              f"{float(srv.last_icp_match_ratio):.4f}; {n_esdf} ESDF "
              f"refreshes, {1e3 * (up1[0] - up0[0]) / max(n_esdf, 1):.1f} ms "
              f"each; blocks "
              f"{out2['blocks']} overflow {out2['overflow']} triangles "
              f"{out2['triangles']}")
        del srv
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The sharded grid and the batched integrate_frames
# ---------------------------------------------------------------------------

SHARDS = 4               # [sharded *], [mirror]: shards on the one card
SHARD_STEPS = 2          # steps of SHARDS frames each
BATCH = 8                # [batched]: frames per integrate_frames call
# The sharded and batched grids against single-device and sequential
# integrate_frame calls: the JAX package's own bound between those forms
# (tests/test_sharding.py, tests/test_models.py), floats summed in another
# order and grouping.
SHARDED_TOL = 1e-4
# The single-device references hold SHARDS x 4096 blocks less one tile
# group: at 16384 rows the (voxel, label) key of the ray integrators' segment
# reduce no longer fits int32 and they would take the plain scatter tail,
# where the shards take the staged route.
SINGLE_CAPACITY = SHARDS * 4096 - 8


def with_capacity(cfg, capacity):
    return dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, block_capacity=capacity))


def with_pipeline(cfg, **kw):
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, **kw))


def sharded_launches(method, cfg, d):
    """Launches per step of a d-shard step on one card: per shard its own
    frame's allocation walk (K1 keys only) and, per frame and shard, the
    ownership-filtered dense apply (K2, K3) where free space is carved
    densely; per shard and gathered stream K1 at voxel granularity and,
    on the staged route, K5 (the sharded ray steps resolve slots by hash,
    no K6; multi-frame anti-grazing takes the plain tail). The hash
    kernels: per frame and shard the dense apply's frame list (H2, H1);
    per shard the runs' insert (H2) and their slots' lookup (H1), and with
    anti-grazing the lookup of the destination voxels' blocks (H1)."""
    ag = cfg.tsdf.enable_anti_grazing
    dense = method == "projective" or (
        cfg.tsdf.carve_mode == "projective" and not (method == "merged"
                                                     and ag))
    out = dict(dda_job_stream=d if dense else 0,
               block_meta=d * d if dense else 0,
               projective_apply_fused=d * d if dense else 0,
               hash_insert=d * d if dense else 0,
               hash_lookup=d * d if dense else 0)
    if method != "projective":
        streams = 1 if cfg.tsdf.carve_mode == "projective" and not (
            method == "merged" and ag) else 2
        out["dda_job_stream"] += d * streams
        if not (method == "merged" and ag):
            out["block_rmw_add"] = d
        out["hash_insert"] += d
        out["hash_lookup"] += d * (2 if ag else 1)
    return out


def run_sharded(step, sg, frames, cfg, intr, mesh, kernels, expect, label):
    """SHARD_STEPS steps of SHARDS frames each into `sg`, each timed on
    the host clock (ending in a synchronize) with every launch count set
    to 0 just before; fails unless the counts equal `expect` per step.
    Returns (ms per step, the counts of the last step)."""
    import torch
    from kimera_semantics_tpu_torch.models.common import Frame
    ms = []
    for s in range(SHARD_STEPS):
        batch = Frame.stack(frames[s * SHARDS:(s + 1) * SHARDS])
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        step(sg, batch, cfg, intr, mesh)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        counts = dict(kernels.launches)
        want = {k: expect.get(k, 0) for k in counts}
        if counts != want:
            fail(f"{label} step {s}: launches {counts}, expected {want}")
    return ms, counts


def step_busy(fn):
    """(host ms, device busy ms, "kernel device ms" text) of one traced
    call of fn()."""
    t = {}

    def run():
        t0 = time.perf_counter()
        fn()
        import torch
        torch.cuda.synchronize()
        t["ms"] = 1e3 * (time.perf_counter() - t0)
    events = trace(run)
    dev = device_events(events)
    per = {k: sum(e.time_range.elapsed_us() for e in dev if sym in e.name)
           / 1e3 for k, sym in KERNEL_SYMBOLS.items() if k != "empty"}
    return t["ms"], busy_ms(events), ", ".join(
        f"{k} {v:.5f}" for k, v in per.items() if v > 0)


def compare_to_single(sg, single, cfg, scfg, label):
    """Each shard's blocks against the single-device grid by coordinate,
    within SHARDED_TOL; the shards' blocks disjoint and together the single
    grid's; no overflow. Returns the largest channel difference."""
    import torch
    from kimera_semantics_tpu_torch.grid import blocks
    over = sum(int(g.overflow) for g in sg)
    if over or int(single.overflow):
        fail(f"{label}: overflow {over} (shards), {int(single.overflow)} "
             "(single device)")
    total, seen, worst = 0, set(), 0.0
    for s, g in enumerate(sg):
        nb = int(g.n_blocks)
        coords = g.block_coords[:nb]
        for c in map(tuple, coords.cpu().tolist()):
            if c in seen:
                fail(f"{label}: block {c} allocated on two shards")
            seen.add(c)
        s_sh = blocks.lookup_slots(g, coords, cfg.grid).long()
        s_si = blocks.lookup_slots(single, coords, scfg.grid).long()
        if bool((s_si >= scfg.grid.block_capacity).any()):
            fail(f"{label}: shard {s} holds a block the single grid lacks")
        for c in CHANNELS:
            a, b = getattr(g, c), getattr(single, c)
            a, b = (a[:, s_sh], b[:, s_si]) if a.dim() == 3 else \
                (a[s_sh], b[s_si])
            if not bool(torch.isclose(a, b, rtol=SHARDED_TOL,
                                      atol=SHARDED_TOL).all()):
                fail(f"{label} shard {s} {c}: differs from the single-device "
                     f"grid by up to {max_abs_err(a, b):g}")
            worst = max(worst, max_abs_err(a, b))
        total += nb
    if total != int(single.n_blocks) or total == 0:
        fail(f"{label}: shards hold {total} blocks, the single-device grid "
             f"{int(single.n_blocks)}")
    return worst


def single_device(model, cfg, intr, frames, dev, counter_of=None,
                  **frame_kw):
    """frames through `model` one integrate_frame at a time on one grid;
    returns (grid, host ms per frame). With `counter_of`, frame i starts
    from frame_counter counter_of(i): a shard's counter counts its own
    frames, and the fast band's thinning salt reads it."""
    import torch
    from kimera_semantics_tpu_torch.grid import blocks
    grid = blocks.create(cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        if counter_of is not None:
            grid.frame_counter = torch.full_like(grid.frame_counter,
                                                 counter_of(i))
        model.integrate_frame(grid, f, cfg, intr, device=dev, **frame_kw)
    torch.cuda.synchronize()
    return grid, 1e3 * (time.perf_counter() - t0) / len(frames)


def sharded_phase(kernels, frames, dev, launches, smi, label, method, cfg,
                  intr, model, plain=True, **single_kw):
    """[sharded fast|merged|projective]: SHARDS shards on the one card,
    SHARD_STEPS steps, held to its own plain run shard by shard and to
    single-device integrate_frame calls. Returns the sharded grid."""
    import torch
    from kimera_semantics_tpu_torch.parallel import sharding
    mesh = sharding.make_mesh(devices=[dev] * SHARDS)
    step = (sharding.integrate_frames_sharded_projective
            if method == "projective" else
            lambda *a: sharding.integrate_frames_sharded(*a, method=method))
    expect = sharded_launches(method, cfg, SHARDS)
    sg = sharding.create_sharded(cfg, mesh)
    ms, counts = run_sharded(step, sg, frames, cfg, intr, mesh, kernels,
                             expect, label)
    launches[label] = counts
    n = SHARDS * SHARD_STEPS
    # One more step on a copy of the first step's grids, traced, for the
    # device's busy time.
    from kimera_semantics_tpu_torch.models.common import Frame
    tg = sharding.create_sharded(cfg, mesh)
    step(tg, Frame.stack(frames[:SHARDS]), cfg, intr, mesh)
    t_ms, busy, per = step_busy(lambda: step(
        tg, Frame.stack(frames[SHARDS:2 * SHARDS]), cfg, intr, mesh))
    del tg
    print(f"[{label}] {SHARDS} shards on one card, {SHARD_STEPS} steps of "
          f"{SHARDS} frames: host ms/step {', '.join(f'{m:.3f}' for m in ms)}"
          f" ({ms[-1] / SHARDS:.3f} ms/frame in the last step; the shards "
          f"run one after another: not a multi-card time); traced step "
          f"{t_ms:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / t_ms:.4f} (kernel device ms: {per}); launches per "
          f"step {counts}; n_blocks "
          f"{[int(g.n_blocks) for g in sg]} overflow "
          f"{sum(int(g.overflow) for g in sg)} dropped_rays "
          f"{sum(int(g.dropped_rays) for g in sg)} ({smi})")
    if plain:
        ref = sharding.create_sharded(cfg, mesh)
        kernels.reset_launches()
        with plain_kernels(kernels):
            for s in range(SHARD_STEPS):
                step(ref, Frame.stack(frames[s * SHARDS:(s + 1) * SHARDS]),
                     cfg, intr, mesh)
        torch.cuda.synchronize()
        if any(kernels.launches.values()):
            fail("the plain reference run launched a kernel")
        worst = 0.0
        for s in range(SHARDS):
            w, _, _ = compare_grids(sg[s], ref[s], cfg, ("sem_count",),
                                    f"{label} shard {s}")
            worst = max(worst, w)
        del ref
        torch.cuda.empty_cache()
        print(f"[{label} reference] plain run: every shard the same block "
              f"coordinates and counters, counts exact, floats within "
              f"{FLOAT_RTOL:g} relative (max abs {worst:g})")
    scfg = with_capacity(cfg, SINGLE_CAPACITY)
    single, sms = single_device(model, scfg, intr, frames[:n], dev,
                                counter_of=lambda i: i // SHARDS,
                                **single_kw)
    worst = compare_to_single(sg, single, cfg, scfg, label)
    print(f"[{label} single] {n} integrate_frame calls on one grid of "
          f"{SINGLE_CAPACITY} blocks, frame i from frame_counter i // "
          f"{SHARDS} as on its shard ({sms:.3f} ms/frame host clock): the "
          f"same {int(single.n_blocks)} blocks, disjoint over the shards; "
          f"channels within {SHARDED_TOL:g} (max abs {worst:g}); overflow 0")
    del single
    torch.cuda.empty_cache()
    return sg


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nccl_phase(kernels, frames, dev, runs, smi):
    """[sharded nccl]: the sharded fast and projective (u16 wire) steps
    again with every gather through a one-process NCCL group (bool flags
    and uint16 planes as bytes), held bit for bit, block by block, to the
    in-process runs."""
    import torch
    import torch.distributed as dist
    from kimera_semantics_tpu_torch.parallel import sharding
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = sharding.make_mesh(devices=[dev] * SHARDS)
        if mesh.group is None:
            fail("[sharded nccl]: the mesh did not take the process group")
        for label, (method, cfg, intr, ref) in runs.items():
            step = (sharding.integrate_frames_sharded_projective
                    if method == "projective" else
                    lambda *a, m=method: sharding.integrate_frames_sharded(
                        *a, method=m))
            sg = sharding.create_sharded(cfg, mesh)
            ms, _ = run_sharded(step, sg, frames, cfg, intr, mesh, kernels,
                                sharded_launches(method, cfg, SHARDS),
                                f"nccl {label}")
            for s in range(SHARDS):
                compare_grids(sg[s], ref[s], cfg, CHANNELS,
                              f"[sharded nccl] {label} shard {s}")
            print(f"[sharded nccl] {label}: {SHARD_STEPS} steps with the "
                  "gathers through NCCL, host ms/step "
                  f"{', '.join(f'{m:.3f}' for m in ms)}; every shard bit "
                  f"for bit the in-process run's, block by block ({smi})")
            del sg
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()


def mirror_phase(kt, frames, dev, cfg, intr, smi):
    """[mirror]: MultiHostPipeline fast, SHARDS shards on the card, two
    steps with an incremental mesh update after each: the mirror equals
    merge_shards and the incremental mesh a full extraction of it."""
    import numpy as np
    import torch
    from kimera_semantics_tpu_torch.grid import blocks
    from kimera_semantics_tpu_torch.models.common import Frame
    from kimera_semantics_tpu_torch.ops import mesh as mesh_ops
    from kimera_semantics_tpu_torch.parallel import multihost, sharding
    lm = kt.LabelColorMap.random(cfg.grid.num_labels)
    pipe = multihost.MultiHostPipeline(
        cfg, intr, sharding.make_mesh(devices=[dev] * SHARDS), label_map=lm)
    ms = []
    for s in range(SHARD_STEPS):
        pipe.step(Frame.stack(frames[s * SHARDS:(s + 1) * SHARDS]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = pipe.update_mesh()
        ms.append(1e3 * (time.perf_counter() - t0))
    merged, mcfg = sharding.merge_shards(pipe.sgrid, cfg)
    mirror, gcfg = pipe.mirror.grid, pipe.mirror.cfg
    nb = int(merged.n_blocks)
    if int(mirror.n_blocks) != nb or nb == 0:
        fail(f"[mirror]: {int(mirror.n_blocks)} mirror blocks, {nb} merged")
    coords = merged.block_coords[:nb]
    s_m = blocks.lookup_slots(merged, coords, mcfg.grid).long()
    s_i = blocks.lookup_slots(mirror, coords, gcfg.grid).long()
    for c in CHANNELS:
        a, b = getattr(merged, c), getattr(mirror, c)
        a, b = (a[:, s_m], b[:, s_i]) if a.dim() == 3 else (a[s_m], b[s_i])
        if not torch.equal(a, b):
            fail(f"[mirror] {c}: the mirror differs from merge_shards")
    full = mesh_ops.extract_mesh(mirror, gcfg, label_map=lm)
    if m.num_triangles != full.num_triangles or m.num_triangles == 0:
        fail(f"[mirror]: incremental mesh {m.num_triangles} triangles, full "
             f"extraction {full.num_triangles}")
    a = np.sort(m.vertices.reshape(-1, 9), axis=0)
    b = np.sort(full.vertices.reshape(-1, 9), axis=0)
    if not np.allclose(a, b, atol=1e-5):
        fail("[mirror]: the incremental mesh's triangles differ from the "
             "full extraction's")
    print(f"[mirror] {SHARDS} shards, {SHARD_STEPS} steps with an "
          f"incremental mesh each ({', '.join(f'{x:.1f}' for x in ms)} ms "
          f"per mesh update): the mirror equals merge_shards over {nb} "
          f"blocks, and its {m.num_triangles} incremental triangles a full "
          f"extraction's ({smi})")
    del pipe, merged, mirror
    torch.cuda.empty_cache()


def batched_phase(kt, kernels, frames, dev, launches, smi):
    """[batched]: fast and merged integrate_frames at B = BATCH at bench's
    settings against BATCH sequential integrate_frame calls and their own
    plain run, with their launches (one K6 with BATCH cubes, K5 once over
    BATCH x block_budget staged rows for fast; merged's batched votes take
    the plain tail), each with BATCH x bench's segment budget."""
    import torch
    from kimera_semantics_tpu_torch.grid import blocks
    from kimera_semantics_tpu_torch.models import fast, merged
    from kimera_semantics_tpu_torch.models.common import Frame
    batch = Frame.stack(frames[:BATCH])
    for name, model in (("fast", fast), ("merged", merged)):
        cfg, intr = ray_config(kt, name)
        # BATCH frames' (voxel, label) segments meet in one reduce: the
        # segment budget scales with the frames, as the staged rows do.
        cfg = with_pipeline(cfg, segment_budget=BATCH
                            * cfg.pipeline.segment_budget)
        label = f"batched {name}"
        # H2 and H1 per frame for the dense carve's frame lists, then
        # once each for the runs' insert and the BATCH cubes' lookup.
        expect = dict(dda_job_stream=BATCH + 1, block_meta=BATCH,
                      projective_apply_fused=BATCH, slot_resolve_stream=1,
                      block_rmw_add=1 if name == "fast" else 0,
                      hash_insert=BATCH + 1, hash_lookup=BATCH + 1)
        warm = blocks.create(cfg, device=dev)
        model.integrate_frames(warm, batch, cfg, intr, device=dev)
        del warm
        grid = blocks.create(cfg, device=dev)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        model.integrate_frames(grid, batch, cfg, intr, device=dev)
        torch.cuda.synchronize()
        bms = 1e3 * (time.perf_counter() - t0) / BATCH
        counts = dict(kernels.launches)
        want = {k: expect.get(k, 0) for k in counts}
        if counts != want:
            fail(f"[{label}]: launches {counts}, expected {want}")
        launches[label] = counts
        tgrid = blocks.create(cfg, device=dev)
        t_ms, busy, per = step_busy(lambda: model.integrate_frames(
            tgrid, batch, cfg, intr, device=dev))
        del tgrid
        ref = blocks.create(cfg, device=dev)
        with plain_kernels(kernels):
            model.integrate_frames(ref, batch, cfg, intr, device=dev)
        torch.cuda.synchronize()
        worst, _, _ = compare_grids(grid, ref, cfg, ("sem_count",),
                                    f"[{label}] plain")
        del ref
        seq, sms = single_device(model, cfg, intr, frames[:BATCH], dev)
        if int(seq.n_blocks) != int(grid.n_blocks):
            fail(f"[{label}]: {int(grid.n_blocks)} blocks, sequential "
                 f"{int(seq.n_blocks)}")
        sworst = compare_to_single([grid], seq, cfg, cfg, label)
        print(f"[{label}] B={BATCH}: {bms:.3f} ms/frame host clock, "
              f"sequential integrate_frame {sms:.3f} ms/frame (both "
              "unresolved: the host clock spreads 10-70% between runs); "
              f"traced call {t_ms:.3f} ms, device busy {busy:.3f} ms, idle "
              f"share {1 - busy / t_ms:.4f} (kernel device ms: {per}); "
              f"launches {counts}; n_blocks "
              f"{int(grid.n_blocks)} overflow {int(grid.overflow)} "
              f"dropped_rays {int(grid.dropped_rays)}; plain run: counts "
              f"exact, floats within {FLOAT_RTOL:g} (max abs {worst:g}); "
              f"sequential: same blocks, channels within {SHARDED_TOL:g} "
              f"(max abs {sworst:g}) ({smi})")
        del grid, seq
        torch.cuda.empty_cache()


def parallel_phases(kt, kernels, frames, dev, launches, smi):
    """The sharded grid ([sharded fast], [sharded merged], [sharded
    projective], [sharded nccl], [mirror]) and [batched]."""
    from kimera_semantics_tpu_torch.models import fast, merged
    from kimera_semantics_tpu_torch.models import projective as proj
    fcfg, fintr = ray_config(kt, "fast")
    # The dense carve's atlases as float32: the single-device fast path
    # reads the unquantized atlas ([sharded projective] holds the u16 wire).
    fcfg = with_pipeline(fcfg, wire_atlas="f32")
    sg_fast = sharded_phase(kernels, frames, dev, launches, smi,
                            "sharded fast", "fast", fcfg, fintr, fast)
    mcfg, mintr = ray_config(kt, "merged")
    # Anti-grazing keeps the decimated carve jobs in place of the dense
    # carve (models/merged.py _projective_carve): bench.py's merged budgets,
    # sized for the dense carve, drop carve jobs and segments there, so the
    # carve and segment budgets take room for them (PipelineConfig's
    # default segment budget).
    mcfg = with_pipeline(dataclasses.replace(mcfg, tsdf=dataclasses.replace(
        mcfg.tsdf, enable_anti_grazing=True)), segment_budget=1 << 18,
        carve_budget=1 << 17)
    sharded_phase(kernels, frames, dev, launches, smi, "sharded merged",
                  "merged", mcfg, mintr, merged)
    pcfg, pintr = canonical(kt)
    sg_proj = {}
    for wire in ("f32", "u16"):
        c = with_pipeline(pcfg, wire_atlas=wire)
        sg_proj[wire] = sharded_phase(
            kernels, frames, dev, launches, smi, f"sharded projective {wire}",
            "projective", c, pintr, proj, plain=False,
            wire_sim=wire == "u16")
    del sg_proj["f32"]
    nccl_phase(kernels, frames, dev, {
        "fast": ("fast", fcfg, fintr, sg_fast),
        "projective u16": ("projective", with_pipeline(pcfg,
                                                       wire_atlas="u16"),
                           pintr, sg_proj["u16"])}, smi)
    del sg_fast, sg_proj
    mirror_phase(kt, frames, dev, fcfg, fintr, smi)
    batched_phase(kt, kernels, frames, dev, launches, smi)


# -- the block hash table's kernels (H1, H2) and the host syncs -------------

HASH_KERNELS = ("hash_lookup", "hash_insert")
HASH_RUNS = 3            # [hash]: repeated H2 runs that must agree


def probe_work(tk, ts, keys, table_size, rounds):
    """(probed table words, hits) of a lookup of `keys`: the data-dependent
    reads that H1's byte count takes."""
    import torch
    from kimera_semantics_tpu_torch.grid import hash as bhash
    mask = table_size - 1
    idx = (bhash.mix(keys) & mask).long()
    done = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    probes = hits = 0
    for _ in range(rounds):
        k = tk[idx]
        probes += int((~done).sum())
        hit = (k == keys) & ~done
        hits += int(hit.sum())
        done = done | hit | (k == bhash.EMPTY_KEY)
        if bool(done.all()):
            break
        idx = torch.where(done, idx, (idx + 1) & mask)
    return probes, hits


def hash_phase(kernels, dev, report):
    """H1 and H2 against their plain versions on the card, torch.equal on
    every array: 512 keys into an 8192-entry table holding 3000 blocks
    (the frame list's insert at the canonical configuration's table),
    4096 keys in groups of 8 sharing a home position, and 20000 keys
    into a 32768-entry table of capacity 16376 (past the capacity: slot
    overflow and tombstones), then a second batch probing through the
    tombstones. H2 runs HASH_RUNS times from the same state, and every run
    must give the same tables. H1 looks up the inserted keys and as many
    absent ones in MAX_PROBES rounds and in 2 (lookup_bounded's complete
    flag). Times both kernels at the first case (the projective frame's
    shapes) and H2 at the others."""
    import numpy as np
    import torch
    from kimera_semantics_tpu_torch.grid import hash as bhash
    rng = np.random.RandomState(9)
    ext = 512

    def table(T, cap):
        return (torch.full((T,), -1, dtype=torch.int32, device=dev),
                torch.full((T,), -1, dtype=torch.int32, device=dev),
                torch.zeros((cap, 3), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    hash_keys = bhash.sample_keys
    prefill = hash_keys(rng, 3000, 12, ext)
    batch = np.concatenate([prefill[:256], hash_keys(rng, 4000, 12, ext)])
    batch = np.unique(batch)[:512]
    rng.shuffle(batch)
    over = hash_keys(rng, 20000, 20, ext)
    cases = [("512 keys, table 8192, capacity 4096", 8192, 4096,
              [prefill], batch),
             ("4096 colliding keys (8 per home), table 8192, capacity 4096",
              8192, 4096, [],
              bhash.colliding_keys(rng, 4096, 8, 8192, ext)),
             ("20000 keys, table 32768, capacity 16376", 32768, 16376, [],
              over[:20000]),
             ("then 4000 keys probing through its tombstones", 32768, 16376,
              [over[:20000]], np.concatenate([over[16000:18000],
                                              hash_keys(rng, 2000, 20,
                                                        ext)]))]
    names = ("table_keys", "table_slots", "block_coords", "n_blocks",
             "overflow")
    for label, T, cap, before, keys_np in cases:
        state = table(T, cap)
        for k in before:
            state = kernels.hash_insert_plain(
                *state, on(k), torch.ones(len(k), dtype=torch.bool,
                                          device=dev), T, cap, ext)[:4]
        keys = on(keys_np)
        active = on(rng.rand(len(keys_np)) > 0.05)
        args = (*state, keys, active, T, cap, ext)
        runs = [kernels.hash_insert(*args) for _ in range(HASH_RUNS)]
        ref = kernels.hash_insert_plain(*args)
        torch.cuda.synchronize()
        for r in runs:
            for n, a, b in zip(names, r, runs[0]):
                if not torch.equal(a, b):
                    fail(f"[hash] {label}: H2 runs differ in {n}")
        for n, a, b in zip(names, runs[0], ref):
            if not torch.equal(a, b):
                fail(f"[hash] {label}: H2 and its plain version differ in "
                     f"{n}")
        tk, ts = runs[0][0], runs[0][1]
        absent = on(hash_keys(rng, len(keys_np), 40, ext))
        q = torch.cat([keys, absent])
        for rounds in (bhash.MAX_PROBES, 2):
            got = kernels.hash_lookup(tk, ts, q, T, rounds)
            want = kernels.hash_lookup_plain(tk, ts, q, T, rounds)
            if not torch.equal(got[0], want[0]) or \
                    bool(got[1]) != bool(want[1]):
                fail(f"[hash] {label}: H1 and its plain version differ at "
                     f"{rounds} rounds")
        n_tomb = int((tk == bhash.TOMBSTONE_KEY).sum())
        n_found = int((kernels.hash_lookup(tk, ts, keys, T,
                                           bhash.MAX_PROBES)[0] >= 0).sum())
        t = kernel_times("hash_insert", lambda: kernels.hash_insert(*args),
                         lambda: kernels.hash_insert_plain(*args))
        print(f"[hash] {label}: {len(keys_np)} keys, {int(active.sum())} "
              f"active; n_blocks {int(runs[0][3])} overflow "
              f"{int(runs[0][4])} tombstones {n_tomb}, {n_found} keys found; "
              f"{HASH_RUNS} H2 runs identical and equal to the plain version "
              f"(torch.equal on every array), H1 equal at "
              f"{bhash.MAX_PROBES} and 2 rounds (complete "
              f"{bool(kernels.hash_lookup(tk, ts, q, T, 2)[1])} at 2); H2 "
              f"{t['ms']:.5f} ms device ({t['timed_by']}), plain "
              f"{t['plain_ms']:.3f} ms")
        if label.startswith("512"):
            # The kernels line's entries, at the projective frame's shapes.
            # H2 reads the keys and flags, the table words the active keys'
            # probe chains reach, and both table arrays once more for the
            # slot assignment's scan; it writes the claimed positions' keys,
            # each new block's slot and coordinates, and n_blocks and
            # overflow. H1 reads the keys and the words its probes reach.
            claimed = int((tk != state[0]).sum())
            new = int(runs[0][3]) - int(state[3])
            probes, _ = probe_work(tk, ts, keys[active], T, bhash.MAX_PROBES)
            report["hash_insert"] = dict(
                err=0.0, **t,
                bytes=(5 * len(keys_np) + 4 * probes + 8 * T + 4 * claimed
                       + 16 * new + 12),
                ops=len(keys_np) * 40 + T * 4)
            print(f"[hash] H2 at 512 keys: {probes} probes, {claimed} "
                  f"positions claimed, {new} new blocks: "
                  f"{report['hash_insert']['bytes']} bytes moved at least")
            probes, hits = probe_work(tk, ts, keys, T, bhash.MAX_PROBES)
            report["hash_lookup"] = dict(
                err=0.0, **kernel_times(
                    "hash_lookup",
                    lambda: kernels.hash_lookup(tk, ts, keys, T,
                                                bhash.MAX_PROBES),
                    lambda: kernels.hash_lookup_plain(tk, ts, keys, T,
                                                      bhash.MAX_PROBES)),
                bytes=8 * len(keys_np) + 4 * (probes + hits) + 1,
                ops=len(keys_np) * 30 + probes * 4)
            print(f"[hash] H1 at 512 keys: {probes} probes, {hits} hits; "
                  f"{report['hash_lookup']['ms']:.5f} ms device "
                  f"({report['hash_lookup']['timed_by']}), plain "
                  f"{report['hash_lookup']['plain_ms']:.3f} ms")


SYNC_WARM, SYNC_FRAMES = 2, 8     # [syncs]: warm-up and checked frames


def sync_sites(fn):
    """Run fn() under torch.cuda.set_sync_debug_mode("warn") and count the
    synchronizing operations by call site: the innermost frame of the port
    package on the stack (else the warning's own location)."""
    import traceback
    import torch
    pkg = os.path.join(ROOT, "kimera_semantics_tpu_torch") + os.sep
    sites = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        # ("called a synchronizing CUDA operation"; not the mode's own
        # notice that it is a prototype feature)
        text = str(message)
        if "synchroniz" not in text.lower() or "prototype" in text:
            return
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack if f.filename.startswith(pkg)]
        # outside the port: the warning's location and its last callers
        site = (f"{os.path.relpath(ours[-1].filename, ROOT)}:"
                f"{ours[-1].lineno} {ours[-1].name}" if ours
                else f"{filename}:{lineno} via " + " < ".join(
                    f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                    for f in reversed(stack[-6:])))
        sites[site] = sites.get(site, 0) + 1
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def syncs_phase(kt, kernels, frames, dev):
    """The projective frame with no host sync: SYNC_WARM frames, then
    SYNC_FRAMES frames of the canonical configuration under
    torch.cuda.set_sync_debug_mode("error") (inputs already on the card),
    which raises at any synchronizing operation; then the syncs that remain
    per frame, by call site, on the fast, merged and serve frames (warn
    mode over SYNC_FRAMES frames after SYNC_WARM)."""
    import traceback
    import torch
    from kimera_semantics_tpu_torch.grid import blocks
    from kimera_semantics_tpu_torch.models import fast, merged
    from kimera_semantics_tpu_torch.models import projective as proj
    from kimera_semantics_tpu_torch.server import node
    from kimera_semantics_tpu_torch.server.pipeline import (
        SemanticTsdfServer, ServerConfig)
    from kimera_semantics_tpu_torch.utils import syncs
    cfg, intr = canonical(kt)
    warm = frames[:SYNC_WARM]
    checked = frames[SYNC_WARM:SYNC_WARM + SYNC_FRAMES]
    grid = blocks.create(cfg, device=dev)
    for f in warm:
        proj.integrate_frame(grid, f, cfg, intr, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()

    def frames_in_error_mode():
        torch.cuda.set_sync_debug_mode("error")
        try:
            for f in checked:
                proj.integrate_frame(grid, f, cfg, intr, device=dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # Two witnesses of the same frames: the sync debug mode, which raises
    # at a synchronizing operation but is a prototype that does not yet
    # detect all of them, and the profiler's trace of the CUDA runtime
    # calls, which must show launches and no synchronizing call, and must
    # see the one that an .item() makes.
    try:
        found, n_calls = syncs.host_syncs(frames_in_error_mode)
    except RuntimeError:
        fail("[syncs] the projective frame synchronized with the host:\n"
             + traceback.format_exc())
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    control, _ = syncs.host_syncs(
        lambda: torch.ones(4, device=dev).sum().item())
    if not control:
        fail("[syncs] the profiler's trace shows no synchronizing call in "
             "an .item(): it cannot witness the frames")
    if found or n_calls < sum(counts.values()):
        fail(f"[syncs] the profiler's trace of the projective frames: "
             f"synchronizing calls {found}, {n_calls} launch calls for "
             f"{counts}")
    if counts["hash_insert"] != SYNC_FRAMES or \
            counts["hash_lookup"] != SYNC_FRAMES:
        fail(f"[syncs] projective launches {counts}")
    if int(grid.overflow) != 0 or int(grid.n_blocks) <= 0:
        fail(f"[syncs] projective overflow {int(grid.overflow)}")
    print(f"[syncs] projective: {SYNC_FRAMES} frames under "
          "set_sync_debug_mode('error') raised nothing, and their profiler "
          f"trace holds {n_calls} launch calls and no synchronizing call "
          f"(an .item() shows {control}): 0 host syncs per frame; launches "
          f"{counts}; n_blocks {int(grid.n_blocks)}")
    del grid

    def per_frame(label, run):
        sites = sync_sites(run)
        per = {s: c / SYNC_FRAMES for s, c in sorted(sites.items())}
        print(f"[syncs] {label}: {sum(sites.values()) / SYNC_FRAMES:g} per "
              f"frame over {SYNC_FRAMES} frames: {json.dumps(per)}")

    for label, model in (("fast", fast), ("merged", merged)):
        rcfg, rintr = ray_config(kt, label)
        g = blocks.create(rcfg, device=dev)
        for f in warm:
            model.integrate_frame(g, f, rcfg, rintr, device=dev)
        torch.cuda.synchronize()
        per_frame(label, lambda: [model.integrate_frame(
            g, f, rcfg, rintr, device=dev) for f in checked])
        torch.cuda.synchronize()
        del g
    args = node.parse_args(["stream", "unused", "--preset", "demo"])
    with stdout_to_stderr(), contextlib.redirect_stderr(open(os.devnull,
                                                             "w")):
        scfg, lmap = node._build(args)
    tmp = tempfile.mkdtemp(prefix="ksd_syncs_")
    try:
        srv = SemanticTsdfServer(scfg, intr, lmap, ServerConfig(
            mesh_every_n_frames=5,
            live_mesh_path=os.path.join(tmp, "live.ply")), device=dev)
        for f in warm:
            srv.insert_frame(f)
        srv.join_mesh()
        torch.cuda.synchronize()

        def serve():
            for f in checked:
                srv.insert_frame(f)
            srv.join_mesh()
        per_frame("serve", serve)
        torch.cuda.synchronize()
        del srv
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


def plain_run(kernels, model, grid, cfg, intr, frames, dev, **frame_kw):
    """The frames through `model` with every kernel's plain version on the
    card; fails if a kernel launched."""
    import torch
    kernels.reset_launches()
    with plain_kernels(kernels):
        for f in frames:
            model.integrate_frame(grid, f, cfg, intr, device=dev, **frame_kw)
    torch.cuda.synchronize()
    if any(kernels.launches.values()):
        fail("the plain reference run launched a kernel")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, ROOT)
    try:
        import kimera_semantics_tpu_torch as kt
        from kimera_semantics_tpu_torch.grid import blocks
        from kimera_semantics_tpu_torch.io.dataset import SyntheticDataset
        from kimera_semantics_tpu_torch.models import projective as proj
        from kimera_semantics_tpu_torch.ops import _build, kernels
        from kimera_semantics_tpu_torch.ops import mip as mip_ops
        from kimera_semantics_tpu_torch.ops import projective as proj_ops
        from kimera_semantics_tpu_torch.ops import semantic as sem_ops
        from kimera_semantics_tpu_torch.core import transforms
    except ImportError as e:
        fail(f"cannot import the port package next to this script: {e}")
    if any(m == "jax" or m.startswith(("jax.", "jaxlib",
                                       "kimera_semantics_tpu."))
           or m == "kimera_semantics_tpu" for m in sys.modules):
        fail("the port imported JAX or the JAX package")

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # -- 1. build -----------------------------------------------------------
    t0 = time.time()
    paths = _build.build_all()
    print(f"[build] {len(paths)} libraries in {time.time() - t0:.1f} s "
          f"({_build.build_dir()})")
    for name in _build.SOURCES:
        log = os.path.join(_build.build_dir(), f"{name}.log")
        if os.path.exists(log):
            for line in open(log).read().splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line):
                    print(f"[build] {name}: {line.strip()}")
    # Static SASS of the redesigned per-voxel kernels K3, K4 and K5, every
    # instance (tools/sass_stats.py).
    from kimera_semantics_tpu_torch.tools import sass_stats
    for name in ("proj_apply", "proj_sample", "block_rmw"):
        for fn, st in sass_stats.stats(paths[name]).items():
            print(f"[sass] {name}: {fn}: {json.dumps(st)}")

    cfg, intr = canonical(kt)
    plan = proj.make_plan(cfg, intr)
    g = cfg.grid
    n_frames = FRAMES
    label_map = kt.LabelColorMap.random(g.num_labels)
    t0 = time.time()
    ds = SyntheticDataset(num_frames=WARM_FRAMES + n_frames, intr=intr,
                          label_map=label_map, device=dev)
    frames = [ds.frame(i) for i in range(WARM_FRAMES + n_frames)]
    torch.cuda.synchronize()
    print(f"[data] {len(frames)} frames {intr.width}x{intr.height} rendered "
          f"in {time.time() - t0:.1f} s")

    # -- 2. kernels vs plain, at the main path's shapes -----------------------
    # The launch floor: an empty kernel's time, taken as the kernels' are.
    empty = _build.bind("empty", "ksd_empty", (ctypes.c_void_p,))
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def launch_empty():
        if empty(stream) != 0:
            fail("the empty kernel did not launch")
    floor = kernel_times("empty", launch_empty, None)
    floor_ms = floor["ms"]
    print(f"[launch floor] empty kernel: {floor_ms:.5f} ms device "
          f"({floor['timed_by']}; {floor['wrapper_ms']:.5f} ms per call, "
          "events)")

    report = {}
    f0 = frames[0]
    atlas = mip_ops.build_atlas(f0.depth, f0.labels, f0.colors, plan)
    jobs = proj.candidate_jobs(atlas, f0.T_G_C, cfg, intr, plan)
    cfg_b, S, origin3, point3, start3, end3, weights, jvalid = jobs
    R = point3.shape[1]
    # K1 at block granularity: the keys-only instance that the main path
    # runs, then the full instance at the same shapes.
    keys_only = lambda fn: fn(*jobs, keys_only=True)  # noqa: E731
    out_k = keys_only(kernels.dda_job_stream)
    out_p = keys_only(kernels.dda_job_stream_plain)
    torch.cuda.synchronize()
    check_outputs("K1 (keys only)", [out_k[0], out_k[5]],
                  [out_p[0], out_p[5]], ("key", "valid"), ())
    if any(x is not None for i, x in enumerate(out_k) if i not in (0, 5)):
        fail("K1 keys only returned more than key and valid")
    full_k = kernels.dda_job_stream(*jobs)
    full_p = kernels.dda_job_stream_plain(*jobs)
    torch.cuda.synchronize()
    err1 = check_outputs("K1 (full)", full_k, full_p, K1_OUTPUTS,
                         ("w", "wsdf", "wc"))
    MAXR = full_k[6].shape[0]
    del full_k, full_p
    print(f"[K1 dda_job_stream] R={R} S={S} MAXR={MAXR}: keys-only and "
          f"full instances bit-exact (ints), float max abs err {err1:g}")
    report["dda_job_stream"] = dict(
        err=0.0, **kernel_times(
            "dda_job_stream", lambda: keys_only(kernels.dda_job_stream),
            lambda: keys_only(kernels.dda_job_stream_plain)),
        # inputs: start3, end3 and the 1-byte flags; outputs: the (S, R)
        # keys and 1-byte valid flags. ops: estimated per ray and step.
        bytes=4 * 6 * R + R + 5 * S * R, ops=R * (40 + 15 * S),
        full=dict(err=err1, R=R, S=S, **kernel_times(
            "dda_job_stream", lambda: kernels.dda_job_stream(*jobs),
            lambda: kernels.dda_job_stream_plain(*jobs)),
            bytes=k1_full_bytes(R, S, MAXR), ops=R * (60 + 40 * S)))

    grid = blocks.create(cfg, device=dev)
    keys, kvalid = out_k[0], out_k[5]
    grid, fcoords, fslots, freal = proj.insert_candidates(grid, keys, kvalid,
                                                          cfg)
    T_C_G = transforms.inverse(f0.T_G_C)
    meta_k = kernels.block_meta(fcoords, freal, T_C_G, intr, plan,
                                g.block_size)
    meta_p = kernels.block_meta_plain(fcoords, freal, T_C_G, intr, plan,
                                      g.block_size)
    torch.cuda.synchronize()
    if not torch.equal(meta_k, meta_p):
        fail(f"K2 block_meta: kernel and plain differ in "
             f"{int((meta_k != meta_p).any(dim=1).sum())} rows")
    K = fcoords.shape[0]
    print(f"[K2 block_meta] K={K} real={int(freal.sum())}: bit-exact")
    meta_args = (fcoords, freal, T_C_G, intr, plan, g.block_size)
    report["block_meta"] = dict(
        err=0.0, **kernel_times(
            "block_meta", lambda: kernels.block_meta(*meta_args),
            lambda: kernels.block_meta_plain(*meta_args)),
        # coordinates and the 1-byte real flag per block and the 12 pose
        # words read, the 8-int meta row written
        bytes=K * (12 + 1 + 32) + 48, ops=K * 8 * 40)

    lk = sem_ops.make_likelihood_cached(cfg).delta

    def channels(gr):
        return [getattr(gr, c) for c in CHANNELS]

    def k3(fn, chs):
        return fn(*chs, fslots, meta_k, T_C_G, atlas, cfg, intr, plan, lk,
                  with_color=False)

    ck = [t.clone() for t in channels(grid)]
    cp = [t.clone() for t in channels(grid)]
    k3(kernels.projective_apply_fused, ck)
    k3(kernels.projective_apply_fused_plain, cp)
    torch.cuda.synchronize()
    err3 = check_outputs("K3", ck, cp, CHANNELS, ("wsum", "wsdf", "wcolor"))
    del cp
    w, w_sdf, cnt, label, upd, gate, _ = proj_ops.sample_terms(
        meta_k, T_C_G, atlas, cfg, intr, plan)
    # Rows K3 samples: real rows outside the trash group.
    real = (meta_k[:, 2] > 0) & (fslots // 8 != (g.padded_rows - 8) // 8)
    n_real = int(real.sum()) * g.vps3
    n_upd = int(upd[real].sum())
    n_cnt = int((cnt[real] > 0).sum())
    # The distinct atlas pixels K3 loads: the mip padding and the pixels no
    # voxel projects to are never read.
    n_px = atlas_pixels(proj_ops, meta_k, T_C_G, cfg, intr, plan, real)
    print(f"[K3 projective_apply_fused] K={K} V3={g.vps3}: real voxels "
          f"{n_real}, updated {n_upd}, labelled {n_cnt}, atlas pixels read "
          f"{n_px} of {plan.atlas_height * plan.atlas_width}; counts and "
          f"labels bit-exact, float max abs err {err3:g}")
    report["projective_apply_fused"] = dict(
        err=err3, **kernel_times(
            "projective_apply_fused",
            lambda: k3(kernels.projective_apply_fused, ck),
            lambda: k3(kernels.projective_apply_fused_plain, ck)),
        # each updated voxel reads+writes wsum, wsdf; each labelled one
        # sem_count and one sem_delta plane; plus meta, slots and the depth
        # and label of each atlas pixel sampled, each read once
        bytes=16 * n_upd + 16 * n_cnt + K * 36 + 2 * 4 * n_px,
        ops=60 * n_real)
    del ck, grid
    torch.cuda.empty_cache()
    k4 = {"canonical": k4_check(kernels, proj_ops, "canonical", cfg, intr,
                                plan, meta_k, fslots, T_C_G, atlas)}
    # The block hash table's kernels H1 and H2, deterministic and equal to
    # their plain versions.
    hash_phase(kernels, dev, report)

    # -- 3. the main path ---------------------------------------------------
    grid = blocks.create(cfg, device=dev)
    print(f"[grid] channels {grid.channel_bytes() / 2**30:.3f} GiB "
          f"({g.padded_rows} rows x {g.vps3} voxels, {g.num_labels} labels)")
    for f in frames[:WARM_FRAMES]:
        proj.integrate_frame(grid, f, cfg, intr, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n_frames + 1)]
    t0 = time.perf_counter()
    ev[0].record()
    for i, f in enumerate(frames[WARM_FRAMES:]):
        proj.integrate_frame(grid, f, cfg, intr, device=dev)
        ev[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    per_frame = [ev[i].elapsed_time(ev[i + 1]) for i in range(n_frames)]
    for n, c in counts.items():
        if c != (n_frames if n in PROJECTIVE_KERNELS else 0):
            fail(f"{n} launched {c} times over {n_frames} frames")
    launches = {"projective": counts}
    overflow, n_blocks = int(grid.overflow), int(grid.n_blocks)
    if overflow != 0 or n_blocks <= 0:
        fail(f"overflow {overflow}, n_blocks {n_blocks}")
    ms = 1e3 * wall / n_frames
    print(f"[main] {n_frames} frames: {ms:.3f} ms/frame host clock, "
          f"{1e3 / ms:.1f} frames/s; device-event ms/frame median "
          f"{sorted(per_frame)[n_frames // 2]:.3f}; launches {counts}; "
          f"n_blocks {n_blocks} overflow {overflow}")

    # Where the time goes: one torch.profiler trace of the same loop on a
    # fresh grid. Each stage's host time comes from integrate_frame's own
    # profiler ranges (models/projective.py STAGES); the host waits inside
    # a stage (the hash insert's syncs) are part of it. The device's busy
    # time is the union of its activities in the trace.
    traced_profile(proj, cfg, intr, frames, dev, proj.STAGES, ms, "stages")

    # Reference: the same frames through the plain versions on the card.
    ref = blocks.create(cfg, device=dev)
    t0 = time.time()
    plain_run(kernels, proj, ref, cfg, intr, frames, dev)
    worst, n_seen, labels = compare_grids(grid, ref, cfg,
                                          ("sem_count", "sem_delta"),
                                          "projective")
    print(f"[reference] plain run of {len(frames)} frames in "
          f"{time.time() - t0:.1f} s: same {n_blocks} block coordinates; "
          f"channels agree (counts and label planes exact, float max abs "
          f"{worst:g}); observed voxels {n_seen}, labels {labels}")
    del ref
    torch.cuda.empty_cache()

    # No host sync on the projective frame; the syncs left on the others.
    syncs_phase(kt, kernels, frames, dev)

    # The unfused route (fused_apply=False): K4 then K5 per frame, K3
    # never, and the grid of the fused route bit for bit.
    ucfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, fused_apply=False))
    ugrid, counts, ums = drive(proj, ucfg, intr, frames, WARM_FRAMES,
                               n_frames, dev, dict(
                                   dda_job_stream=1, block_meta=1,
                                   projective_sample_update=1,
                                   block_rmw_add=1, **PROJ_HASH))
    launches["unfused"] = counts
    compare_grids(ugrid, grid, cfg, CHANNELS, "unfused vs fused")
    print(f"[unfused] {n_frames} frames: {ums:.3f} ms/frame host clock, "
          f"{1e3 / ums:.1f} frames/s; launches {counts}; grid bit-identical "
          f"to the fused route's, block for block")
    del grid, ugrid
    torch.cuda.empty_cache()

    # The unfused route at an odd vps: K5's generic instance.
    k4_odd, k5_generic = odd_vps_phase(kernels, proj, proj_ops, cfg, intr,
                                       frames, dev, launches)
    k4.update(k4_odd)

    # The u16 wire atlas codec: wire_sim=True on the canonical frames.
    wire_phase(kernels, proj, mip_ops, cfg, intr, frames, dev, launches)

    # -- 4. the ray integrators' kernels vs plain, at the fast path's shapes
    ray_kernel_checks(kt, frames, dev, report)

    # -- 5. the fast integrator at bench.py's fast configuration ------------
    from kimera_semantics_tpu_torch.models import fast, merged
    fcfg, fintr = ray_config(kt, "fast")
    per_frame_ray = dict(dda_job_stream=2, block_meta=1,
                         projective_apply_fused=1, slot_resolve_stream=1,
                         block_rmw_add=1, **RAY_HASH)
    grid, counts, fms = drive(fast, fcfg, fintr, frames, WARM_FRAMES,
                              n_frames, dev, per_frame_ray)
    launches["fast"] = counts
    print(f"[fast] {n_frames} frames: {fms:.3f} ms/frame host clock, "
          f"{1e3 / fms:.1f} frames/s; launches {counts}; n_blocks "
          f"{int(grid.n_blocks)} overflow {int(grid.overflow)} dropped_rays "
          f"{int(grid.dropped_rays)}")
    traced_profile(fast, fcfg, fintr, frames, dev, fast.STAGES, fms,
                   "fast stages", outer="carve")
    ref = blocks.create(fcfg, device=dev)
    t0 = time.time()
    plain_run(kernels, fast, ref, fcfg, fintr, frames, dev)
    worst, n_seen, labels = compare_grids(grid, ref, fcfg, ("sem_count",),
                                          "fast")
    print(f"[fast reference] plain run of {len(frames)} frames in "
          f"{time.time() - t0:.1f} s: same {int(grid.n_blocks)} block "
          f"coordinates and counters; channels agree (counts exact, floats "
          f"within {FLOAT_RTOL:g} relative, max abs {worst:g}); observed "
          f"voxels {n_seen}, labels {labels}")
    del grid, ref
    torch.cuda.empty_cache()

    # -- 6. the merged integrator at bench.py's merged configuration --------
    mcfg, mintr = ray_config(kt, "merged")
    grid, counts, mms = drive(merged, mcfg, mintr, frames, MERGED_WARM,
                              MERGED_FRAMES, dev, per_frame_ray)
    launches["merged"] = counts
    print(f"[merged] {MERGED_FRAMES} frames: {mms:.3f} ms/frame host clock, "
          f"{1e3 / mms:.1f} frames/s; launches {counts}; n_blocks "
          f"{int(grid.n_blocks)} overflow {int(grid.overflow)} dropped_rays "
          f"{int(grid.dropped_rays)}")
    mframes = frames[:MERGED_WARM + MERGED_FRAMES]
    ref = blocks.create(mcfg, device=dev)
    t0 = time.time()
    plain_run(kernels, merged, ref, mcfg, mintr, mframes, dev)
    worst, n_seen, labels = compare_grids(grid, ref, mcfg, ("sem_count",),
                                          "merged")
    print(f"[merged reference] plain run of {len(mframes)} frames in "
          f"{time.time() - t0:.1f} s: same {int(grid.n_blocks)} block "
          f"coordinates and counters; channels agree (counts exact, floats "
          f"within {FLOAT_RTOL:g} relative, max abs {worst:g}); observed "
          f"voxels {n_seen}, labels {labels}")
    del grid, ref
    torch.cuda.empty_cache()
    traced_profile(merged, mcfg, mintr, frames[:WARM_FRAMES + MERGED_FRAMES],
                   dev, fast.STAGES, mms, "merged stages", outer="carve")

    # -- 7. the serving output: K4 at 32^3, the CLI, the stream server,
    # sim-eval --------------------------------------------------------------
    # K4 at V3 = 32768 (32^3 literal storage), then K5 on its deltas: the
    # cli_vps32 route's pair
    k4["32^3 literal"], k5_wide = k4_k5_pair(
        kernels, proj, proj_ops, literal32_config(kt, cfg), intr, frames[0],
        dev, "32^3 literal", True)
    report["block_rmw_add"]["variants"] = {"onehot, cli_vps32": k5_wide,
                                           **k5_generic}
    report["projective_sample_update"] = dict(k4["canonical"], variants=k4)
    cli_phase(kt, kernels, intr, label_map, dev, launches)
    serve_phase(kt, kernels, intr, frames, dev, launches)
    sim_eval_phase()

    # -- 8. the rosbag batch slice: K7 and the scatter tool, the plain
    # scatter modes, the bag batch with the ESDF, ICP ----------------------
    k7_check(kernels, dev, report)
    scatter_phase(kernels, dev, launches)
    modes_phase(kt, kernels, frames, dev, launches)
    bag_icp_phase(kt, kernels, intr, dev, launches)

    # -- 9. the sharded grid and the batched integrate_frames --------------
    parallel_phases(kt, kernels, frames, dev, launches, smi)

    # -- 10. report ----------------------------------------------------------
    src, tpu = "kimera_semantics_tpu_torch/csrc/", \
        "kimera_semantics_tpu/ops/pallas_kernels.py:"
    sources = {"dda_job_stream": (src + "dda.cu", tpu + "142"),
               "block_meta": (src + "block_meta.cu", tpu + "345"),
               "projective_apply_fused": (src + "proj_apply.cu", tpu + "822"),
               "projective_sample_update": (src + "proj_sample.cu",
                                            tpu + "734"),
               "slot_resolve_stream": (src + "slot_resolve.cu", tpu + "472"),
               "block_rmw_add": (src + "block_rmw.cu", tpu + "936"),
               "add_f32": (src + "add.cu",
                           "scripts/profile_scatter_r4.py:106"),
               # no TPU kernel: the JAX package's device-side probe loops
               "hash_lookup": (src + "hash.cu",
                               "kimera_semantics_tpu/grid/hash.py:72"),
               "hash_insert": (src + "hash.cu",
                               "kimera_semantics_tpu/grid/hash.py:105")}
    # bound_ms is the larger of the bytes' and the operations' time; the
    # measured launch floor rides beside it, and the least time a launch of
    # the kernel can take is the larger of bound_ms and launch_floor_ms.
    # "launches" counts the run of the kernel's own slice's main path
    # (MAIN_PATH), each driven with the counts set to 0 just before and
    # read just after; "launches_by_path" has every path's run.
    for name, path in MAIN_PATH.items():
        if launches[path][name] <= 0:
            fail(f"{name} was not launched on its main path ({path})")

    def bound_of(r):
        t_bytes = 1e3 * r["bytes"] / BANDWIDTH
        t_ops = 1e3 * r["ops"] / FP32_PEAK
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
            else "operations"

    def line(name, r, shape):
        bound, by = bound_of(r)
        least = max(bound, floor_ms)
        print(f"[kernel] {name}{shape}: {r['ms']:.5f} ms device "
              f"({r['timed_by']}; {r['wrapper_ms']:.4f} ms per wrapper call, "
              f"events); plain {r['plain_ms']:.3f} ms; bound {bound:.5f} ms "
              f"by {by} ({r['bytes']} B, {r['ops']} ops); least with the "
              f"launch floor {least:.5f} ms, kernel at "
              f"{r['ms'] / least:.2f}x")
        cold = {}
        if "cold_ms" in r:
            cold = dict(cold_ms=r["cold_ms"])
            print(f"[kernel] {name}{shape}: {r['cold_ms']:.5f} ms device "
                  f"with the L2 flushed before each launch, "
                  f"{r['cold_ms'] / least:.2f}x the least")
        return dict(ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=bound,
                    bound_by=by, **cold)

    table = []
    for name, r in report.items():
        entry = {"name": name, "route": "cuda", "source": sources[name][0],
                 "replaces": sources[name][1],
                 "launches": launches[MAIN_PATH[name]][name],
                 "main_path": MAIN_PATH[name],
                 "max_abs_err": r["err"], **line(name, r, ""),
                 "library_ms": r.get("library_ms"),
                 "launch_floor_ms": floor_ms,
                 "launches_by_path": {p: c[name] for p, c in
                                      launches.items()}}
        if "rounds" in r:
            entry["rounds"] = r["rounds"]
        if "full" in r:
            v = r["full"]
            entry["full_instance"] = dict(
                R=v["R"], S=v["S"], max_abs_err=v["err"],
                **line(name, v, f" (full instance, block walk, R={v['R']} "
                                f"S={v['S']})"))
        if "voxel" in r:
            v = r["voxel"]
            entry["voxel_granularity"] = dict(
                R=v["R"], S=v["S"], max_abs_err=v["err"],
                **line(name, v, f" (voxel granularity, R={v['R']} "
                                f"S={v['S']})"))
        if "forms" in r:
            entry["forms"] = {f: dict(max_abs_err=v["err"],
                                      **line(name, v, f" ({f})"))
                              for f, v in r["forms"].items()}
        if "variants" in r:
            entry["variants"] = {
                f: dict(K=v["K"], V3=v["V3"], max_abs_err=v["err"],
                        **line(name, v, f" ({f}, K={v['K']} V3={v['V3']})"))
                for f, v in r["variants"].items()}
        table.append(entry)
    print(f"[profiler] traces taken again for want of a kernel's device "
          f"spans: {json.dumps(TRACE_RETRIES) if TRACE_RETRIES else 'none'}")
    print(json.dumps({"kernels": table}))
    print(smi)
    # The last line: the one card this script used.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
