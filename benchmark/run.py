#!/usr/bin/env python3
"""The benchmark of kimera_semantics_tpu_torch, one cell a run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. A cell of
BENCHMARK.json names a configuration (benchmark/configs/<name>.json) and a
traffic mix (benchmark/traffic/<name>.json). The run:

  set-up   renders the mix's F frames of the configuration's scene with
           sensor noise drawn from the seed (the camera's work, not the
           port's), builds the port's SemanticTsdfServer, and hands it one
           full loop of the frames (every shape warmed, the kernels built,
           the map grown to its size);
  window   hands the port the loop's frames for --seconds in a closed
           loop, through the mix's entry point (`run`, the offline replay,
           or `insert_frame` with the pipelined mesh cycle), each frame as
           host arrays that the port uploads itself;
  trace    with --trace 1, the mix's trace_frames more frames under
           torch.profiler, for the per-layer metrics;
  check    the port's fused grid against the configuration's plain
           reference (kbench/reference.py, or benchmark/references/
           <name>.py where the configuration names one), once the
           program's state is freed.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), device, breakdown (--trace 1) and checks (each
compared number with its limit, also the last lines of standard error).

`--readings N` runs N seeds from --seed in one process and prints each
seed's compared numbers (and, with --control, the bfloat16 control's);
no result line. It serves the limits in kbench/check.py, not the check.
"""

from __future__ import annotations

import json
import os
import sys
import time

T_START = time.perf_counter()
THREADS = 1
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
             "NUMEXPR_NUM_THREADS"):
    os.environ[_var] = str(THREADS)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (HERE, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FORBIDDEN = ("jax", "jaxlib", "flax", "kimera_semantics_tpu")


def parse(argv):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--readings", type=int, default=0)
    p.add_argument("--control", action="store_true")
    return p.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def host_line(torch, device):
    """The host's CPUs and load, the thread counts, the card and its
    power limit."""
    info = {"cpus": os.cpu_count(), "loadavg": list(os.getloadavg()),
            "threads": THREADS, "torch": torch.__version__}
    if device.type == "cuda":
        import subprocess
        info["card"] = torch.cuda.get_device_name(device)
        try:
            q = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=20)
            info["nvidia_smi"] = q.stdout.strip()
        except (OSError, subprocess.SubprocessError):
            info["nvidia_smi"] = None
    print("host " + json.dumps(info), flush=True)


def warm(srv, feed):
    """One full loop of the trajectory: every shape warmed, every kernel
    built, the map at its size. Returns each trajectory frame's overflow
    plus dropped rays (a host sync a frame, outside the window)."""
    from kbench import port
    incr = []
    prev = port.counters(srv)
    for _ in range(len(feed.frames)):
        srv.insert_frame(feed.to_frame(feed.take()))
        now = port.counters(srv)
        incr.append(now[0] - prev[0] + now[1] - prev[1])
        prev = now
    srv.join_mesh()
    return incr


def one_run(args, seed, bench, w, conf, traffic, device, root):
    """Set-up, window, trace and check of one seed. Returns (result dict,
    compared numbers, control's numbers or None)."""
    import gc
    import types

    import torch

    from kbench import check, port, scene, spec, stats
    from kbench.trace import traced

    marks = [("start", time.perf_counter())]
    frames = scene.frames(conf, traffic, seed, device)
    colors = scene.label_colors(conf["fusion"]["num_labels"],
                                conf["label_colors_seed"])
    marks.append(("render", time.perf_counter()))
    srv = port.build_server(conf, traffic, colors, device)
    feed = port.Feed(frames, device)
    marks.append(("server", time.perf_counter()))
    incr = warm(srv, feed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gc.collect()
    gc.freeze()
    marks.append(("warm_loop", time.perf_counter()))

    published = []
    srv.mesh_callbacks.append(published.append)
    cyc0, stall0 = len(srv.mesh_cycle_s), srv.mesh_stall_s
    first = len(feed.stamps)
    t_setup = time.perf_counter() - T_START
    window_s, t_end, n = port.drive(srv, feed, traffic,
                                    seconds=args.seconds)
    obs = types.SimpleNamespace(
        frame_s=port.frame_times(feed.stamps[first:], t_end), frames=n,
        window_s=window_s, mesh_cycle_s=srv.mesh_cycle_s[cyc0:],
        mesh_stall_s=srv.mesh_stall_s - stall0, traced=None)
    failed = sum(1 for f in feed.order[first:] if incr[f] > 0)
    if args.trace:
        from kimera_semantics_tpu_torch.ops import kernels
        from kimera_semantics_tpu_torch.utils.syncs import is_host_sync
        obs.is_host_sync = is_host_sync
        obs.traced = traced(lambda: port.drive(
            srv, feed, traffic, frames=traffic["trace_frames"])[2],
            device, kernels, os.path.join(root, "benchmark",
                                          "kernel_counts"))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # The program's output; its state freed before the reference runs.
    out = port.output(srv)
    tiles = {"tiles_allocated": int(out["blocks"].shape[0]),
             "tiles_capacity": srv.grid.block_coords.shape[0],
             "storage_voxels_per_side": conf["fusion"][
                 "storage_voxels_per_side"]}
    mesh = published[-1] if published else None
    cycles = srv.mesh_cycles
    del srv, published
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    nums, cnums, work = check.judge(
        out, mesh, cycles, frames, feed.order, conf, colors,
        traffic["mesh_every_n_frames"], device, args.control,
        reference=spec.reference(root, conf))
    del out, mesh

    def span(key):
        vals = [x[key] for x in work]
        return [min(vals), max(vals)]
    print("work " + json.dumps({
        "seed": seed, "frames_in_loop": len(frames),
        "per_frame_min_max": {k: span(k) for k in (
            "rays", "carve_jobs", "entries", "segments", "touched_blocks",
            "staging_rows", "dropped_rays", "segment_overflow",
            "rank_overflow", "outside")},
        "port_overflow_plus_dropped_per_frame_max": max(incr),
        "map_at_the_close": tiles}), flush=True)
    print("window " + json.dumps({
        "setup_s_by_phase": {
            "imports_and_card": marks[0][1] - T_START,
            **{b[0]: b[1] - a[1] for a, b in zip(marks[:-1], marks[1:])}},
        "frames": n, "seconds": window_s,
        "mesh_cycles": len(obs.mesh_cycle_s),
        "frame_ms_p5_p25_p50_p75_p95_max": [
            1e3 * stats.percentile(obs.frame_s, p)
            for p in (5, 25, 50, 75, 95, 100)]}), flush=True)

    if args.trace:
        from kbench.roofline import roofline_share
        if obs.traced.device:
            share, report = roofline_share(obs.traced.launches,
                                           obs.traced.device,
                                           **obs.traced.kernels)
            print("kernels " + json.dumps({"roofline_pct": share,
                                           **report}), flush=True)
        metrics = {}
        for m in spec.metrics_of(bench, w["name"], "per_layer"):
            v = spec.reader(root, m["name"])(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"frames_per_s": n / window_s, "setup_s": t_setup}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.metrics_of(bench, w["name"], "end_to_end")}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": w["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": check.passes(nums), "attempted": n,
              "failed": failed, "metrics": metrics, "device": dev}
    if obs.traced is not None:
        dev["busy_s"] = obs.traced.busy_s()
        dev["window_s"] = obs.traced.window_s
        result["breakdown"] = {"device_ops": obs.traced.device_ops(),
                               "idle_gaps": obs.traced.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in nums.items()}
    return result, nums, cnums


def main(argv=None, device=None, root=ROOT) -> int:
    """Run the benchmark; `device` other than None (tests) skips the look
    for a card and runs there."""
    args = parse(argv)
    import torch
    torch.set_num_threads(THREADS)
    from kbench import check, spec
    bench = spec.load(root)
    w, conf, traffic = spec.cell(bench, root, args.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < w["chips"]:
            log(f"error: the cell needs {w['chips']} CUDA card(s); "
                f"cuda available {torch.cuda.is_available()}, "
                f"cards {torch.cuda.device_count()}")
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device(device)
    host_line(torch, device)

    if args.readings:
        for i in range(args.readings):
            seed = args.seed + i
            result, nums, cnums = one_run(args, seed, bench, w, conf,
                                          traffic, device, root)
            print("readings " + json.dumps({
                "seed": seed, "attempted": result["attempted"],
                "failed": result["failed"], "port": nums,
                "port_passes": check.passes(nums), "control": cnums,
                "control_passes": (check.passes(cnums) if cnums else None),
                "metrics": result["metrics"]}), flush=True)
        return 0

    result, nums, _ = one_run(args, args.seed, bench, w, conf, traffic,
                              device, root)
    bad = forbidden_modules()
    if bad:
        log(f"error: the process holds {', '.join(bad)} once the window "
            "has closed")
        return 3
    for k, v in result["checks"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
