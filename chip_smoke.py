#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kimera_semantics_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must complete:
  1. build the CUDA kernels from kimera_semantics_tpu_torch/csrc (nvcc, one
     process per source, in parallel);
  2. hold each kernel of the projective main path against its plain PyTorch
     version on the card, at the main path's shapes, and time both, and
     time an empty kernel (csrc/empty.cu) for the launch floor;
  3. drive the main path (models/projective.py integrate_frame) at the
     canonical configuration of bench.py (projective method, 640x480,
     0.05 m voxels, 16^3 blocks) over 4 warm-up and 24 timed synthetic
     frames, check that every kernel launched once per frame and that no
     block overflowed; trace the same loop on a fresh grid with
     torch.profiler for the time of each stage of integrate_frame and the
     device's busy share; then re-run the same frames through the plain
     versions on the card and compare the grids block by block;
  4. report per-stage times, the kernel table (one JSON line), the card's
     name and power limit, and last the one-line JSON result.

Exits non-zero, with no result line, on any failure, including when no
CUDA device is present or the package is missing.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
BANDWIDTH = 3.35e12      # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
FP32_PEAK = 67e12        # H100 SXM float32 outside the tensor cores, FLOP/s
WARM_FRAMES = 4          # integrated before the timed frames
FRAMES = 24              # timed frames of the main path
REPS = 50                # launches per kernel timing

# Tolerances of the kernel-vs-plain checks. Both sides run the same float32
# operations in the same order (fused multiply-adds at the same places), so
# integer outputs must be bit-exact; float outputs are held to 1e-6 relative
# (only the order of the K3 adds into the grid could differ, and it does not).
FLOAT_RTOL = 1e-6


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
                  "empty": "empty_kernel"}


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
    names = ("dda_job_stream", "block_meta", "projective_apply_fused")
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
    names = ("key", "local", "w", "wsdf", "wc", "valid", "run_key", "run_idx")
    err1 = 0.0
    for n, a, b in zip(names, out_k, out_p):
        if n in ("w", "wsdf", "wc"):
            e = max_abs_err(a, b)
            if e > 0 and max_rel_err(a, b) > FLOAT_RTOL:
                fail(f"K1 {n}: kernel and plain differ (max abs {e})")
            err1 = max(err1, e)
        elif not torch.equal(a, b):
            fail(f"K1 {n}: kernel and plain differ at "
                 f"{int((a != b).sum())} entries")
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
    chans = ("wsum", "wsdf", "sem_count", "sem_delta", "wcolor")

    def channels(gr):
        return [getattr(gr, c) for c in chans]

    def k3(fn, chs):
        return fn(*chs, fslots, meta_k, T_C_G, atlas, cfg, intr, plan, lk,
                  with_color=False)

    ck = [t.clone() for t in channels(grid)]
    cp = [t.clone() for t in channels(grid)]
    k3(kernels.projective_apply_fused, ck)
    k3(kernels.projective_apply_fused_plain, cp)
    torch.cuda.synchronize()
    err3 = 0.0
    for n, a, b in zip(chans, ck, cp):
        if n in ("sem_count", "sem_delta"):
            if not torch.equal(a, b):
                fail(f"K3 {n}: kernel and plain differ at "
                     f"{int((a != b).sum())} voxels")
        else:
            e = max_abs_err(a, b)
            if e > 0 and max_rel_err(a, b) > FLOAT_RTOL:
                fail(f"K3 {n}: kernel and plain differ (max abs {e})")
            err3 = max(err3, e)
    del cp
    w, w_sdf, cnt, label, upd, gate, _ = proj_ops.sample_terms(
        meta_k, T_C_G, atlas, cfg, intr, plan)
    # Rows K3 samples: real rows outside the trash group.
    real = (meta_k[:, 2] > 0) & (fslots // 8 != (g.padded_rows - 8) // 8)
    n_real = int(real.sum()) * g.vps3
    n_upd = int(upd[real].sum())
    n_cnt = int((cnt[real] > 0).sum())
    # The distinct atlas pixels K3 loads (depth and label of every voxel
    # whose sample falls inside its block's window): the mip padding and
    # the pixels no voxel projects to are never read.
    _, _, _, _, _, row, col = proj_ops.voxel_pixels(meta_k, T_C_G, cfg, intr,
                                                    plan)
    inwin = ((row >= 0) & (row < plan.row_window) & (col >= 0)
             & (col < plan.col_window) & real[:, None])
    pixel = ((meta_k[:, :1] + row) * plan.atlas_width + meta_k[:, 1:2] + col)
    n_px = int(torch.unique(pixel[inwin]).numel())
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

    # -- 3. the main path ---------------------------------------------------
    grid = blocks.create(cfg, device=dev)
    print(f"[grid] channels {grid.channel_bytes() / 2**30:.3f} GiB "
          f"({g.padded_rows} rows x {g.vps3} voxels, {g.num_labels} labels)")
    for f in frames[:4]:
        proj.integrate_frame(grid, f, cfg, intr, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n_frames + 1)]
    t0 = time.perf_counter()
    ev[0].record()
    for i, f in enumerate(frames[4:]):
        proj.integrate_frame(grid, f, cfg, intr, device=dev)
        ev[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    per_frame = [ev[i].elapsed_time(ev[i + 1]) for i in range(n_frames)]
    for n, c in counts.items():
        if c != n_frames:
            fail(f"{n} launched {c} times over {n_frames} frames")
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
    tgrid = blocks.create(cfg, device=dev)
    for f in frames[:WARM_FRAMES]:
        proj.integrate_frame(tgrid, f, cfg, intr, device=dev)
    torch.cuda.synchronize()
    traced = {}

    def traced_loop():
        t0 = time.perf_counter()
        for f in frames[WARM_FRAMES:]:
            proj.integrate_frame(tgrid, f, cfg, intr, device=dev)
        torch.cuda.synchronize()
        traced["ms"] = 1e3 * (time.perf_counter() - t0) / n_frames
    events = trace(traced_loop)
    traced_ms = traced["ms"]
    del tgrid
    from torch.autograd import DeviceType
    stages = {k: sum(e.time_range.elapsed_us() for e in events
                     if e.name == f"integrate_frame/{k}"
                     and e.device_type == DeviceType.CPU) / 1e3 / n_frames
              for k in proj.STAGES}
    dev_ms = {n: sum(e.time_range.elapsed_us()
                     for e in device_events(events) if sym in e.name)
              / 1e3 / n_frames
              for n, sym in KERNEL_SYMBOLS.items() if n != "empty"}
    busy = busy_ms(events) / n_frames
    print(f"[stages] host ms/frame under the profiler ({traced_ms:.3f} "
          "ms/frame traced): " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in stages.items()))
    print(f"[device] busy {busy:.3f} ms/frame (trace), idle share "
          f"{1 - busy / ms:.4f} of the untraced {ms:.3f} ms/frame; kernel "
          "device ms/frame in the loop: " + ", ".join(
              f"{n} {v:.5f}" for n, v in dev_ms.items()))

    # Reference: the same frames through the plain versions on the card.
    ref = blocks.create(cfg, device=dev)
    kernels.reset_launches()
    t0 = time.time()
    with plain_kernels(kernels):
        for f in frames:
            proj.integrate_frame(ref, f, cfg, intr, device=dev)
    torch.cuda.synchronize()
    if any(kernels.launches.values()):
        fail("the plain reference run launched a kernel")
    n_ref = int(ref.n_blocks)
    coords = grid.block_coords[:n_blocks]
    if n_ref != n_blocks or int(ref.overflow) != overflow:
        fail(f"plain run: n_blocks {n_ref} overflow {int(ref.overflow)}")
    s_k = blocks.lookup_slots(grid, coords, g).long()
    s_p = blocks.lookup_slots(ref, coords, g).long()
    if bool((s_p >= g.block_capacity).any()):
        fail("plain run allocated another block set")
    worst = 0.0
    for c in chans:
        a, b = getattr(grid, c), getattr(ref, c)
        a, b = (a[:, s_k], b[:, s_p]) if a.dim() == 3 else (a[s_k], b[s_p])
        if not bool(torch.isfinite(a).all()):
            fail(f"{c}: non-finite values")
        if c in ("sem_count", "sem_delta"):
            if not torch.equal(a, b):
                fail(f"{c}: kernel run and plain run differ")
        elif max_abs_err(a, b) > 0 and max_rel_err(a, b) > FLOAT_RTOL:
            fail(f"{c}: kernel run and plain run differ")
        else:
            worst = max(worst, max_abs_err(a, b))
    upd_k = grid.updated[s_k]
    if not torch.equal(upd_k, ref.updated[s_p]) or not bool(upd_k.any()):
        fail("updated flags differ")
    dist = blocks.tsdf_distance(grid, cfg.tsdf.truncation_distance)[s_k]
    labs = blocks.mle_labels(grid)[s_k]
    seen = grid.wsum[s_k] > 0
    if not bool(torch.isfinite(dist).all()) or int(labs.max()) >= g.num_labels:
        fail("readouts out of range")
    print(f"[reference] plain run of {len(frames)} frames in "
          f"{time.time() - t0:.1f} s: same {n_blocks} block coordinates; "
          f"channels agree (counts and label planes exact, float max abs "
          f"{worst:g}); observed voxels {int(seen.sum())}, labels "
          f"{sorted(set(labs[seen].tolist()))}")

    # -- 4. report ----------------------------------------------------------
    sources = {"dda_job_stream": ("kimera_semantics_tpu_torch/csrc/dda.cu",
                                  "kimera_semantics_tpu/ops/pallas_kernels.py:142"),
               "block_meta": ("kimera_semantics_tpu_torch/csrc/block_meta.cu",
                              "kimera_semantics_tpu/ops/pallas_kernels.py:345"),
               "projective_apply_fused": (
                   "kimera_semantics_tpu_torch/csrc/proj_apply.cu",
                   "kimera_semantics_tpu/ops/pallas_kernels.py:822")}
    # bound_ms is the larger of the bytes' and the operations' time; the
    # measured launch floor rides beside it, and the least time a launch of
    # the kernel can take is the larger of bound_ms and launch_floor_ms.
    table = []
    for name, r in report.items():
        t_bytes = 1e3 * r["bytes"] / BANDWIDTH
        t_ops = 1e3 * r["ops"] / FP32_PEAK
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        table.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": counts[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "launch_floor_ms": floor_ms})
        least = max(bound, floor_ms)
        print(f"[kernel] {name}: {r['ms']:.5f} ms device ({r['timed_by']}; "
              f"{r['wrapper_ms']:.4f} ms per wrapper call, events); plain "
              f"{r['plain_ms']:.3f} ms; bound {bound:.5f} ms by {by} "
              f"({r['bytes']} B, {r['ops']} ops); least with the launch "
              f"floor {least:.5f} ms, kernel at {r['ms'] / least:.2f}x; "
              f"{counts[name]} launches over {n_frames} frames")
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
