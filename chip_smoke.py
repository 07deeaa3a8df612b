#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kimera_semantics_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must complete:
  1. build the CUDA kernels from kimera_semantics_tpu_torch/csrc (nvcc, one
     process per source, in parallel);
  2. hold each kernel of the projective main path (K1-K3, and K4 at the
     same frame list) against its plain PyTorch version on the card, at
     the main path's shapes, and time both, and time an empty kernel
     (csrc/empty.cu) for the launch floor;
  3. drive the projective main path (models/projective.py integrate_frame)
     at the canonical configuration of bench.py (projective method,
     640x480, 0.05 m voxels, 16^3 blocks) over 4 warm-up and 24 timed
     synthetic frames, check that every kernel launched once per frame and
     that no block overflowed; trace the same loop on a fresh grid with
     torch.profiler for the time of each stage of integrate_frame and the
     device's busy share; re-run the same frames through the plain
     versions on the card and compare the grids block by block; then drive
     them with fused_apply=False (K4 then K5 per frame, K3 never) and hold
     that grid to the fused one bit for bit;
  4. capture the inputs of the ray integrators' kernels from one frame of
     the fast integrator at bench.py's fast configuration (K1 at voxel
     granularity, K6 slot_resolve_stream, K5 block_rmw_add in packed
     staging, and K5 in dense and onehot form at the same rows), hold each
     against its plain version on the card and time both;
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
     its plain version; the CLI (`node batch --preset demo --method
     projective --storage-vps 32`) over 4 + 24 frames written with
     save_directory_dataset, with its launches, overflow, PLY and a .vxblx
     that reloads to the grid's TSDF voxels; the stream server at the demo
     preset with pipelined meshing every 5 frames (frames/s, cycle ms,
     stall), the snapshot check of the async cycle, the mesh cache against
     generate_mesh (its seams counted, then every block re-meshed), and a
     .ksdv round trip; `sim-eval --preset eval`
     against the JAX package's CPU values;
  8. the rosbag batch slice: K7 add_f32 bit-exact against its plain
     version and timed beside torch.add; the scatter-strategy profiling
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
  9. report per-stage times, the kernel table (one JSON line), the card's
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


def device_time(fn, symbol: str, reps: int):
    """Mean device ms of the CUDA kernel `symbol` per call of fn(), from a
    torch.profiler trace of `reps` calls; None if the trace shows no device
    time for it."""
    fn()

    def run():
        for _ in range(reps):
            fn()
    spans = [e.time_range.elapsed_us() for e in device_events(trace(run))
             if symbol in e.name]
    if not spans or sum(spans) <= 0:
        return None
    return sum(spans) / 1e3 / reps


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


def kernel_times(name, fn, plain_fn):
    """The kernel's device ms per launch (profiler; CUDA events around the
    wrapper calls where the trace shows no device time), the wrapper's ms
    per call and, given plain_fn, the plain version's ms per call (both
    CUDA events)."""
    wrapper = cuda_time(fn, REPS)
    dev = device_time(fn, KERNEL_SYMBOLS[name], REPS)
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


def drive(model, cfg, intr, frames, warm, n, dev, expect):
    """Integrate frames[:warm], then time frames[warm:warm + n] on the
    host clock (ending in a synchronize) with every launch count set to 0
    just before; fail unless the counts equal `expect` (per frame) and no
    block overflowed. Returns (grid, counts, ms per frame)."""
    import torch
    from kimera_semantics_tpu_torch.grid import blocks
    from kimera_semantics_tpu_torch.ops import kernels
    grid = blocks.create(cfg, device=dev)
    for f in frames[:warm]:
        model.integrate_frame(grid, f, cfg, intr, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for f in frames[warm:warm + n]:
        model.integrate_frame(grid, f, cfg, intr, device=dev)
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
        bytes=4 * (3 * 4 * R + 2 * R) + 4 * (7 * S * R + MAXR * R),
        ops=R * (60 + 40 * S))
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
                                                        .sum())),
        "dense": (dict(d_sem=dense), None, 4 * n_live * V3 * (3 + L),
                  8 * nz(dense.transpose(0, 1))),
        "onehot": ({}, d_lab, 4 * n_live * V3 * 4, 8 * nz(d_cnt)),
    }
    base = [getattr(grid, c) for c in CHANNELS]
    k5 = {}
    for form, (kw, lab, delta_bytes, vote_bytes) in forms.items():
        args = lambda chs: (*chs, slots, d_w, d_wsdf, d_cnt, lab, d_wc)  # noqa
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
        k5[form] = dict(
            err=err, **kernel_times(
                "block_rmw_add",
                lambda: kernels.block_rmw_add(*args(ck), lk, **kw),
                lambda: kernels.block_rmw_add_plain(*args(ck), lk, **kw)),
            # the live tiles' deltas read once, the slots, and one read and
            # one write of each grid word a nonzero delta or a vote adds to
            bytes=delta_bytes + 4 * Kb + rmw_base + vote_bytes,
            ops=n_live * V3 * (12 + 4 * (P if form == "packed" else
                                         L if form == "dense" else 1)))
        del ck
        torch.cuda.empty_cache()
        print(f"[K5 block_rmw_add, {form}] Kb={Kb} V3={V3} live rows "
              f"{n_live}: counts and label planes bit-exact, float max abs "
              f"err {err:g}")
    report["block_rmw_add"] = dict(k5["packed"], forms=k5)
    del grid, base
    torch.cuda.empty_cache()



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


PROJECTIVE_KERNELS = ("dda_job_stream", "block_meta", "projective_apply_fused")
# Each kernel's slice and the path of that slice whose run gives its
# "launches": the projective main path (K1-K3), the fast integrator (K5,
# K6), the serving output's CLI at 32^3 literal storage (K4) and the
# scatter-strategy profiling tool's warm-kernel probe (K7).
MAIN_PATH = {"dda_job_stream": "projective", "block_meta": "projective",
             "projective_apply_fused": "projective",
             "projective_sample_update": "cli_vps32",
             "slot_resolve_stream": "fast", "block_rmw_add": "fast",
             "add_f32": "scatter_profile"}


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


def k4_wide_check(kt, kernels, proj, proj_ops, cfg, intr, frame, dev):
    """K4 at V3 = 32768 (32^3 literal storage), on one frame's list."""
    import torch
    from kimera_semantics_tpu_torch.core import transforms
    from kimera_semantics_tpu_torch.grid import blocks
    from kimera_semantics_tpu_torch.ops import mip as mip_ops
    c32 = literal32_config(kt, cfg)
    plan = proj.make_plan(c32, intr)
    atlas = mip_ops.build_atlas(frame.depth, frame.labels, frame.colors,
                                plan)
    grid = blocks.create(c32, device=dev)
    _, fcoords, fslots, freal = proj.allocate_from_atlas(
        grid, atlas, frame.T_G_C, c32, intr, plan)
    del grid
    T_C_G = transforms.inverse(frame.T_G_C)
    meta = kernels.block_meta(fcoords, freal, T_C_G, intr, plan,
                              c32.grid.block_size)
    out = k4_check(kernels, proj_ops, "32^3 literal", c32, intr, plan, meta,
                   fslots, T_C_G, atlas)
    torch.cuda.empty_cache()
    return out


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
        with stdout_to_stderr():
            srv, out = node.cmd_batch(args, streaming=False)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        launches["cli_vps32"] = counts
        want = {k: (n if k in ("dda_job_stream", "block_meta",
                               "projective_sample_update", "block_rmw_add")
                    else 0) for k in counts}
        if counts != want:
            fail(f"cli: launches {counts}, expected {want}")
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
        want = dict(dda_job_stream=streams + (mode == "projective"),
                    block_meta=int(mode == "projective"),
                    projective_apply_fused=int(mode == "projective"),
                    slot_resolve_stream=streams, block_rmw_add=1)
        want = {k: want.get(k, 0) * n for k in counts}
        if counts != want:
            fail(f"serve: launches {counts}, expected {want}")
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
              f"{counts}")
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


def k7_check(kernels, dev, report):
    """K7 add_f32 at the probe's shape, (8, 128) float32, bit-exact against
    its plain version, timed beside torch.add on the same tensors."""
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
    lib = device_time(lambda: torch.add(x, y), "add", REPS)
    report["add_f32"] = dict(
        err=0.0, **kernel_times("add_f32", lambda: kernels.add_f32(x, y),
                                lambda: kernels.add_f32_plain(x, y)),
        library_ms=lib if lib is not None else cuda_time(
            lambda: torch.add(x, y), REPS),
        # two inputs read and one output written once; one add each
        bytes=3 * 4 * x.numel(), ops=x.numel())
    print(f"[K7 add_f32] (8, 128) float32: bit-exact against x + y; "
          f"torch.add {report['add_f32']['library_ms']:.5f} ms device")


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
                                    slot_resolve_stream=1, block_rmw_add=1))
    line = [f"segment {1e3 / seg_ms:.1f}"]
    for mode in ("direct", "sorted"):
        cfg = dataclasses.replace(fcfg, pipeline=dataclasses.replace(
            fcfg.pipeline, scatter_mode=mode))
        # The plain tail: hash-resolved slots and indexed adds, no K5 or
        # K6; the projective carve keeps K1, K2 and K3.
        grid, counts, ms = drive(fast, cfg, fintr, frames, MERGED_WARM,
                                 MERGED_FRAMES, dev, dict(
                                     dda_job_stream=2, block_meta=1,
                                     projective_apply_fused=1))
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
        with stdout_to_stderr():
            srv, out = node.cmd_batch(args, streaming=False)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        launches["bag"] = counts
        cfg, res = srv.cfg, srv.esdf
        esdf_s = timing.get("esdf/batch")[0] - esdf0
        # Per frame (carve_mode "decimated", the preset's): K1 and K6 for
        # the band and the carve jobs, K5 once.
        want = {k: n * dict(dda_job_stream=2, slot_resolve_stream=2,
                            block_rmw_add=1).get(k, 0) for k in counts}
        if counts != want:
            fail(f"bag: launches {counts}, expected {want}")
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


def plain_run(kernels, model, grid, cfg, intr, frames, dev):
    """The frames through `model` with every kernel's plain version on the
    card; fails if a kernel launched."""
    import torch
    kernels.reset_launches()
    with plain_kernels(kernels):
        for f in frames:
            model.integrate_frame(grid, f, cfg, intr, device=dev)
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
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")

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
    out_k = kernels.dda_job_stream(*jobs)
    out_p = kernels.dda_job_stream_plain(*jobs)
    torch.cuda.synchronize()
    err1 = check_outputs("K1", out_k, out_p, K1_OUTPUTS, ("w", "wsdf", "wc"))
    MAXR = out_k[6].shape[0]
    print(f"[K1 dda_job_stream] R={R} S={S} MAXR={MAXR}: ints bit-exact, "
          f"float max abs err {err1:g}")
    report["dda_job_stream"] = dict(
        err=err1, **kernel_times(
            "dda_job_stream", lambda: kernels.dda_job_stream(*jobs),
            lambda: kernels.dda_job_stream_plain(*jobs)),
        # inputs: 4 (3, R) planes, weights, flags; outputs: 7 (S, R) planes
        # and the (MAXR, R) run keys. ops: estimated flops per ray and step.
        bytes=4 * (3 * 4 * R + 2 * R) + 4 * (7 * S * R + MAXR * R),
        ops=R * (60 + 40 * S))

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
        bytes=K * (12 + 4 + 32) + 48, ops=K * 8 * 40)

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

    # The unfused route (fused_apply=False): K4 then K5 per frame, K3
    # never, and the grid of the fused route bit for bit.
    ucfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, fused_apply=False))
    ugrid, counts, ums = drive(proj, ucfg, intr, frames, WARM_FRAMES,
                               n_frames, dev, dict(
                                   dda_job_stream=1, block_meta=1,
                                   projective_sample_update=1,
                                   block_rmw_add=1))
    launches["unfused"] = counts
    compare_grids(ugrid, grid, cfg, CHANNELS, "unfused vs fused")
    print(f"[unfused] {n_frames} frames: {ums:.3f} ms/frame host clock, "
          f"{1e3 / ums:.1f} frames/s; launches {counts}; grid bit-identical "
          f"to the fused route's, block for block")
    del grid, ugrid
    torch.cuda.empty_cache()

    # -- 4. the ray integrators' kernels vs plain, at the fast path's shapes
    ray_kernel_checks(kt, frames, dev, report)

    # -- 5. the fast integrator at bench.py's fast configuration ------------
    from kimera_semantics_tpu_torch.models import fast, merged
    fcfg, fintr = ray_config(kt, "fast")
    per_frame_ray = dict(dda_job_stream=2, block_meta=1,
                         projective_apply_fused=1, slot_resolve_stream=1,
                         block_rmw_add=1)
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
    k4["32^3 literal"] = k4_wide_check(kt, kernels, proj, proj_ops, cfg,
                                       intr, frames[0], dev)
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

    # -- 9. report ----------------------------------------------------------
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
                           "scripts/profile_scatter_r4.py:106")}
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
        return dict(ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=bound,
                    bound_by=by)

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
    print(json.dumps({"kernels": table}))
    print(smi)
    # The last line: the one card this script used.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
