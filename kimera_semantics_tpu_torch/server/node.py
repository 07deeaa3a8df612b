"""CLI entry points, the reference's three binaries.

Counterpart: kimera_semantics_tpu/server/node.py, with the same flags and
one more, --device (default cuda; cpu runs the kernels' plain versions):

  python -m kimera_semantics_tpu_torch.server.node stream <dataset> ...
      live-streaming server (periodic incremental meshing while frames
      arrive)
  python -m kimera_semantics_tpu_torch.server.node batch <dataset> ...
      offline batch reconstruction (PLY mesh, map save; with a .bag,
      --esdf and a .vxblx --map-out, the reference's rosbag batch and its
      tsdf_esdf.vxblx)
  python -m kimera_semantics_tpu_torch.server.node sim-eval ...
      synthetic-world evaluation (one JSON line)

<dataset> is a directory of frame_*.npz files or a ROS1 .bag (image
topics, or an organised PointCloud2 with --pointcloud-topic; TF, and
static extrinsics from --static-tf-csv). Not ported yet (slice E), and
refused with a message rather than ignored: --devices > 1.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

SLICE_E = "not ported yet (slice E)"


def _add_common(p):
    p.add_argument("--preset", default=None,
                   help="named launch-file parameter set "
                        "(server/presets.py); explicit flags override")
    p.add_argument("--cfg-dir", default=None,
                   help="directory holding the label CSVs named by presets "
                        "(default: $KIMERA_CFG_DIR, then the reference cfg/)")
    p.add_argument("--voxel-size", type=float, default=0.05)
    p.add_argument("--voxels-per-side", type=int, default=16,
                   help="layer block side (reference launch uses 32); sides "
                        ">16 that are a multiple of 16 run on 16^3 storage "
                        "tiles internally (identical voxel state; .vxblx "
                        "interop regroups to true blocks) unless "
                        "--storage-vps forces literal storage")
    p.add_argument("--storage-vps", type=int, default=0,
                   help="force the internal storage block side (0 = auto: "
                        "16 for multiples of 16, else literal)")
    p.add_argument("--block-capacity", type=int, default=4096)
    p.add_argument("--truncation", type=float, default=0.1)
    p.add_argument("--max-ray-length", type=float, default=5.0)
    p.add_argument("--no-carving", dest="carving", action="store_false",
                   help="disable voxel carving (update only the truncation "
                        "band; launch:102 enables carving)")
    p.add_argument("--carve-mode", default=None,
                   choices=["decimated", "projective", "full"],
                   help="free-space carving strategy for the ray-centric "
                        "integrators (TsdfConfig.carve_mode; default keeps "
                        "the config default)")
    p.add_argument("--const-weight", action="store_true",
                   help="constant ray weight instead of 1/z^2 "
                        "(use_const_weight, launch:104 GT runs)")
    p.add_argument("--max-weight", type=float, default=10000.0,
                   help="voxel weight saturation (voxblox max_weight)")
    p.add_argument("--min-ray-length", type=float, default=0.1)
    p.add_argument("--enable-anti-grazing", action="store_true",
                   help="merged integrator: skip traversed voxels owned by "
                        "other bundles (voxblox enable_anti_grazing, "
                        "_merged.cpp:306-313)")
    p.add_argument("--method",
                   choices=["fast", "merged", "simple", "projective"],
                   default="fast",
                   help="integrator type (ros_params.cpp:24)")
    p.add_argument("--band-density", default="octave",
                   choices=["octave", "matched"],
                   help="banded-mode ray selection density: 'matched' thins "
                        "octave candidates to the reference's exact "
                        "1-per-dedup-cell rate (TsdfConfig.band_density — "
                        "~2x smaller band streams, temporally dithered)")
    p.add_argument("--semantic-csv", default=None,
                   help="label,color CSV (semantic_label_2_color_csv_filepath)")
    p.add_argument("--num-labels", type=int, default=None,
                   help="label-space size (default: from the CSV, min 21; "
                        "the reference hard-codes 21 at compile time — "
                        "common.h:24-26). Grid memory scales linearly in it")
    p.add_argument("--measurement-probability", type=float, default=0.9)
    p.add_argument("--color-mode", default="semantic",
                   choices=["color", "semantic", "semantic_probability"])
    p.add_argument("--dynamic-labels", type=int, nargs="*", default=[20])
    p.add_argument("--semantic-near-surface-only", action="store_true",
                   help="restrict semantic votes to the truncation band "
                        "(beyond-reference quality option; the reference "
                        "votes along the whole ray, "
                        "semantic_integrator_base.cpp:153-158)")
    p.add_argument("--max-rays", type=int, default=32768)
    p.add_argument("--devices", type=int, default=1,
                   help="spatial sharding over N devices: not ported yet "
                        "(slice E); only 1 is accepted")
    p.add_argument("--alloc-stride", type=int, default=4,
                   help="projective: pixel subsampling for block allocation")
    p.add_argument("--block-budget", type=int, default=512,
                   help="projective: touched-block list size per frame")
    p.add_argument("--scatter-mode", default="segment",
                   choices=["direct", "sorted", "segment"],
                   help="grid update strategy (PipelineConfig.scatter_mode); "
                        "'segment' is the TPU-fast sorted-compaction path")
    p.add_argument("--mesh-out", default="mesh.ply")
    p.add_argument("--mesh-normals", action="store_true",
                   help="write per-vertex TSDF-gradient normals into the PLY")
    p.add_argument("--connected-mesh", action="store_true",
                   help="vertex-deduplicated (connected) mesh output — "
                        "voxblox MeshLayer getConnectedMesh (~6x smaller "
                        "PLYs)")
    p.add_argument("--live-mesh", default="",
                   help="stream mode: atomically rewrite this PLY with the "
                        "full growing mesh at each periodic update (rviz "
                        "incremental-mesh topic equivalent)")
    p.add_argument("--live-mesh-keep", type=int, default=0,
                   help="also keep N rotating live-mesh snapshots")
    p.add_argument("--live-port", type=int, default=-1,
                   help=">=0: serve the live mesh over HTTP (/ viewer, "
                        "/mesh.ply, /stats.json); 0 picks a free port")
    p.add_argument("--map-out", default=None)
    p.add_argument("--map-in", default=None,
                   help="load a saved map (.vxblx or .ksdv) before "
                        "integrating — checkpoint/resume, the reference's "
                        "LoadBlocksFromFile kReplace path "
                        "(semantic_simulation_server.cpp:57-89)")
    p.add_argument("--esdf", action="store_true",
                   help="batch ESDF after reconstruction (CS2 tail)")
    p.add_argument("--esdf-max-dist", type=float, default=4.0,
                   help="ESDF saturation distance in meters (voxblox "
                        "esdf_max_distance_m)")
    p.add_argument("--esdf-every", type=int, default=0,
                   help="refresh the ESDF every N frames while streaming "
                        "(voxblox EsdfServer update cycle)")
    p.add_argument("--enable-icp", action="store_true",
                   help="scan-to-map TSDF alignment before each integration "
                        "(voxblox enable_icp, launch:111)")
    p.add_argument("--icp-iters", type=int, default=6,
                   help="Gauss-Newton iterations (voxblox icp iterations)")
    p.add_argument("--icp-subsample", type=int, default=16,
                   help="feed every Nth backprojected pixel to the solver")
    p.add_argument("--icp-no-refine-roll-pitch", action="store_true",
                   help="constrain refinement to yaw+translation (voxblox "
                        "icp_refine_roll_pitch=false; gravity-aligned rigs)")
    p.add_argument("--icp-damping", type=float, default=1e-3,
                   help="Levenberg damping on the Gauss-Newton Hessian")
    p.add_argument("--icp-min-match-ratio", type=float, default=0.1,
                   help="reject refinement when fewer than this fraction of "
                        "points hit observed in-band TSDF")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--depth-topic", default="/depth/image_raw",
                   help=".bag datasets: depth image topic")
    p.add_argument("--semantic-topic", default="/semantic/image_raw",
                   help=".bag datasets: semantic image topic ('' = none)")
    p.add_argument("--cam-info-topic", default="/depth/camera_info",
                   help=".bag datasets: CameraInfo topic")
    p.add_argument("--pointcloud-topic", default=None,
                   help=".bag datasets: organized XYZRGB PointCloud2 topic "
                        "(the live node's input surface; overrides "
                        "--depth-topic)")
    p.add_argument("--world-frame", default="world",
                   help=".bag datasets: TF world/global frame")
    p.add_argument("--sensor-frame", default=None,
                   help=".bag datasets: camera TF frame "
                        "(default: the image header's frame_id)")
    p.add_argument("--static-tf-csv", default=None,
                   help=".bag datasets: static extrinsics CSV "
                        "(child,x,y,z,qx,qy,qz,qw rows — the reference's "
                        "cfg/*_static_tfs*.csv; resolved like label CSVs)")
    p.add_argument("--static-tf-parent", default="base_link",
                   help="parent frame the static-TF CSV rows hang off")
    p.add_argument("--log-every", type=int, default=0,
                   help="progress lines to stderr every N frames "
                        "(the reference's per-frame glog progress)")
    p.add_argument("--stats-jsonl", default="",
                   help="write one JSON metrics line per frame to this path")
    p.add_argument("--surface-pc", default="",
                   help="write the near-surface voxel pointcloud (colored "
                        "PLY) — the surface_pointcloud topic")
    p.add_argument("--freespace-pc", default="",
                   help="write the free-space voxel pointcloud (PLY) — the "
                        "freespace_pointcloud topic Kimera uses for planning")
    p.add_argument("--trace-dir", default="",
                   help="capture a torch.profiler trace of the run into "
                        "this directory (a Chrome/Perfetto trace file)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the grid and the kernels: the "
                        "card (default) or 'cpu' (the kernels' plain "
                        "versions)")
    p.add_argument("--validate", action="store_true",
                   help="audit hash-table/voxel invariants after the run "
                        "(utils/checks.py — the reference's CHECK contract "
                        "surface)")


def _resolve_cfg_file(name, cfg_dir):
    """Resolve a bare cfg filename against --cfg-dir/$KIMERA_CFG_DIR (the
    launch files' cfg/ convention); explicit paths pass through. Returns the
    path or None (callers decide whether that's a warning or an error)."""
    if not name:
        return None
    if name.startswith("/") or name.startswith("."):
        return name
    from . import presets
    return presets.resolve_csv(name, cfg_dir)


def _build(args):
    from ..config import (ColorMode, FusionConfig, GridConfig, IntegratorType,
                          PipelineConfig, SemanticConfig, TsdfConfig)
    from ..core.color import LabelColorMap
    csv = _resolve_cfg_file(args.semantic_csv, args.cfg_dir)
    if args.semantic_csv and csv is None:
        print(f"warning: label CSV {args.semantic_csv!r} not found (see "
              "--cfg-dir); using a random colormap", file=sys.stderr)
    if csv:
        lmap = LabelColorMap.from_csv(csv, num_labels=args.num_labels)
    else:
        lmap = LabelColorMap.random(args.num_labels or 21)
    # Storage tiling: user block sides >16 map to 16^3 storage tiles (the
    # voxel state is identical — GridConfig.io_voxels_per_side doc) unless
    # --storage-vps forces the literal side. Capacity scales so the same
    # voxel volume fits.
    storage_vps = args.storage_vps or (
        16 if (args.voxels_per_side > 16 and args.voxels_per_side % 16 == 0)
        else args.voxels_per_side)
    io_vps = args.voxels_per_side if storage_vps != args.voxels_per_side else 0
    cap_scale = (args.voxels_per_side // storage_vps) ** 3
    block_capacity = args.block_capacity * cap_scale
    # The segment-scatter / cube-LUT fast paths need the combined
    # (voxel, label) key — ((capacity+1) * vps^3) << ceil(log2(L)) — to fit
    # int32 (ops/integrate.py). A silently disabled fast path is a 10x+
    # perf cliff, so clamp the auto-scaled capacity to the key budget and
    # say so (ADVICE r2).
    lab_shift = max(1, (max(2, lmap.num_labels) - 1).bit_length())
    cap_budget = ((2 ** 31 >> lab_shift) // storage_vps ** 3 - 1) // 8 * 8
    if block_capacity > cap_budget > 0:
        print(f"warning: block_capacity={block_capacity} (auto-scaled x"
              f"{cap_scale} for storage tiling) exceeds the int32 "
              f"(voxel,label) segment-key budget with {lmap.num_labels} "
              f"labels — clamping to {cap_budget} to keep the "
              "segment-scatter/cube-LUT fast paths enabled "
              "(--block-capacity to override the pre-scale value)",
              file=sys.stderr)
        block_capacity = cap_budget
    sem_gb = (lmap.num_labels * (block_capacity + 8)
              * storage_vps ** 3 * 4 / 2 ** 30)
    if sem_gb > 8.0:
        print(f"warning: num_labels={lmap.num_labels} at this grid size "
              f"needs ~{sem_gb:.0f} GB for the semantic channel — consider "
              "--num-labels or a smaller --block-capacity", file=sys.stderr)
    cfg = FusionConfig(
        grid=GridConfig(voxel_size=args.voxel_size,
                        voxels_per_side=storage_vps,
                        io_voxels_per_side=io_vps,
                        block_capacity=block_capacity,
                        num_labels=lmap.num_labels),
        tsdf=TsdfConfig(truncation_distance=args.truncation,
                        max_ray_length_m=args.max_ray_length,
                        min_ray_length_m=args.min_ray_length,
                        max_weight=args.max_weight,
                        use_const_weight=args.const_weight,
                        voxel_carving_enabled=args.carving,
                        enable_anti_grazing=args.enable_anti_grazing,
                        band_density=args.band_density,
                        **({"carve_mode": args.carve_mode}
                           if args.carve_mode else {})),
        semantic=SemanticConfig(
            semantic_measurement_probability=args.measurement_probability,
            color_mode=ColorMode(args.color_mode),
            dynamic_labels=tuple(args.dynamic_labels),
            update_near_surface_only=args.semantic_near_surface_only),
        pipeline=PipelineConfig(max_rays=args.max_rays,
                                scatter_mode=args.scatter_mode,
                                alloc_stride=args.alloc_stride,
                                block_budget=args.block_budget),
        integrator=IntegratorType(args.method),
    )
    return cfg, lmap


def _refuse_slice_d(args):
    """Exit with a message for the options not ported yet: the sharded
    runs of slice E (--devices > 1)."""
    if args.devices > 1:
        raise SystemExit(f"--devices {args.devices}: {SLICE_E} in "
                         "kimera_semantics_tpu_torch")


@contextlib.contextmanager
def _trace(trace_dir: str, device):
    """A torch.profiler trace of the block into `trace_dir`."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def _dataset(args, lmap, dev):
    """The CLI's dataset: a ROS1 .bag (the reference's rosbag front door,
    kimera_semantics_rosbag.cpp) or a directory of npz frames."""
    from ..io.dataset import DirectoryDataset
    if not args.dataset.endswith(".bag"):
        return DirectoryDataset(args.dataset, label_map=lmap, device=dev)
    from ..io.rosbag import RosbagDataset
    tf_csv = _resolve_cfg_file(args.static_tf_csv, args.cfg_dir)
    if args.static_tf_csv and tf_csv is None:
        # Dropped extrinsics would corrupt every pose: a hard error, unlike
        # the label CSV's fallback (colours are cosmetic).
        raise SystemExit(
            f"static-TF CSV {args.static_tf_csv!r} not found "
            "(see --cfg-dir / $KIMERA_CFG_DIR)")
    common = dict(cam_info_topic=args.cam_info_topic,
                  world_frame=args.world_frame,
                  sensor_frame=args.sensor_frame, label_map=lmap,
                  static_tf_csv=tf_csv,
                  static_tf_parent=args.static_tf_parent, device=dev)
    if args.pointcloud_topic:
        return RosbagDataset(args.dataset,
                             pointcloud_topic=args.pointcloud_topic,
                             **common)
    return RosbagDataset(args.dataset, depth_topic=args.depth_topic,
                         semantic_topic=args.semantic_topic or None,
                         **common)


def cmd_batch(args, streaming: bool):
    """stream/batch; prints the JSON line and returns (server, its
    dict). In the reference's order (kimera_semantics_rosbag.cpp:148-167):
    integrate, mesh, then with --esdf the batch ESDF, then the map, the
    ESDF layer appended to a .vxblx."""
    from ..device import resolve
    from ..ops import esdf as esdf_ops
    from ..server.pipeline import SemanticTsdfServer, ServerConfig
    from ..utils import timing

    cfg, lmap = _build(args)
    dev = resolve(args.device)
    ds = _dataset(args, lmap, dev)
    srv = SemanticTsdfServer(
        cfg, ds.intr, lmap,
        ServerConfig(mesh_every_n_frames=5 if streaming else 0,
                     mesh_filename=args.mesh_out,
                     mesh_normals=args.mesh_normals,
                     mesh_connected=args.connected_mesh,
                     log_every_n_frames=args.log_every,
                     stats_jsonl=args.stats_jsonl,
                     esdf_every_n_frames=args.esdf_every,
                     esdf_max_dist=args.esdf_max_dist,
                     live_mesh_path=args.live_mesh,
                     live_mesh_keep=args.live_mesh_keep,
                     live_mesh_port=args.live_port,
                     enable_icp=args.enable_icp,
                     icp_iters=args.icp_iters,
                     icp_subsample=args.icp_subsample,
                     icp_refine_roll_pitch=not args.icp_no_refine_roll_pitch,
                     icp_damping=args.icp_damping,
                     icp_min_match_ratio=args.icp_min_match_ratio),
        device=dev)
    if srv.live_streamer is not None:
        print(f"live mesh: http://127.0.0.1:{srv.live_streamer.port}/",
              file=sys.stderr)
    if args.map_in:
        srv.load_map(args.map_in)
    t_run = timing.Timer("run")
    with _trace(args.trace_dir, dev):
        n = srv.run(ds, max_frames=args.max_frames)
    t_run.stop(sync=srv.grid.wsum)
    mesh = srv.generate_mesh(args.mesh_out)
    out = {"frames": n, "triangles": mesh.num_triangles, **srv.stats(),
           "frames_per_s": n / t_run.elapsed}
    if args.surface_pc:
        import numpy as np
        from ..io import ply as ply_io
        pts, cols = srv.surface_pointcloud()
        ply_io.write_ply(args.surface_pc, pts, cols,
                         np.zeros((0, 3), np.int32))
        out["surface_points"] = len(pts)
    if args.freespace_pc:
        import numpy as np
        from ..io import ply as ply_io
        pts = srv.freespace_pointcloud()
        ply_io.write_ply(args.freespace_pc, pts,
                         np.full((len(pts), 3), 255, np.uint8),
                         np.zeros((0, 3), np.int32))
        out["freespace_points"] = len(pts)
    if args.validate:
        from ..utils import checks
        out["invariants"] = checks.validate_grid(srv.grid, cfg)
    res = None
    if args.esdf:
        with timing.Timer("esdf/batch"):
            res = srv.esdf = esdf_ops.compute_esdf_blocked(
                srv.grid, cfg, max_dist=args.esdf_max_dist)
        out["esdf_voxels"] = int(res.distance.size)
    if args.map_out:
        srv.save_map(args.map_out, esdf=res)
    print(timing.report(), file=sys.stderr)
    print(json.dumps(out))
    return srv, out


def cmd_sim_eval(args):
    """sim-eval; prints the JSON line and returns (server, its dict)."""
    from ..core.camera import PinholeIntrinsics
    from ..device import resolve
    from ..io.dataset import SyntheticDataset
    from ..server.pipeline import SemanticTsdfServer
    from ..sim import eval as sim_eval

    cfg, lmap = _build(args)
    dev = resolve(args.device)
    intr = PinholeIntrinsics(fx=160.0, fy=160.0, cx=159.5, cy=119.5,
                             width=320, height=240)
    ds = SyntheticDataset(num_frames=args.num_viewpoints, intr=intr,
                          label_map=lmap, device=dev)
    srv = SemanticTsdfServer(cfg, intr, lmap, device=dev)
    with _trace(args.trace_dir, dev):
        srv.run(ds)
    errs = sim_eval.compare_to_world(srv.grid, cfg, ds.world,
                                     surface_band=cfg.tsdf.truncation_distance)
    mesh = srv.generate_mesh(args.mesh_out)
    mesh_err = sim_eval.mesh_surface_error(mesh.vertices, ds.world)
    out = {
        "rmse_tsdf": errs.rmse_tsdf, "mae_tsdf": errs.mae_tsdf,
        "label_accuracy": errs.label_accuracy, "compared": errs.num_compared,
        "mesh_error": mesh_err, **srv.stats()}
    if args.validate:
        from ..utils import checks
        out["invariants"] = checks.validate_grid(srv.grid, cfg)
    print(json.dumps(out))
    return srv, out


def parse_args(argv=None):
    """The CLI's arguments, with a --preset's values as defaults that
    explicit flags override."""
    ap = argparse.ArgumentParser(prog="kimera_semantics_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("stream", "batch"):
        p = sub.add_parser(name)
        p.add_argument("dataset")
        _add_common(p)
    p = sub.add_parser("sim-eval")
    p.add_argument("--num-viewpoints", type=int, default=50)
    _add_common(p)
    args, _ = ap.parse_known_args(argv)
    if getattr(args, "preset", None):
        from . import presets
        # argparse defaults updated per-subparser, then a full re-parse so
        # explicit flags still win (roslaunch arg-override semantics).
        for sp in sub.choices.values():
            presets.apply_preset(sp, args.preset)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run one command; returns the dict of its JSON line."""
    args = parse_args(argv)
    _refuse_slice_d(args)
    if args.cmd in ("stream", "batch"):
        return cmd_batch(args, streaming=args.cmd == "stream")[1]
    return cmd_sim_eval(args)[1]


if __name__ == "__main__":
    main()
