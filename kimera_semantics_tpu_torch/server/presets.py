"""Named configuration presets — the reference's launch-file parameter sets.

Counterpart: kimera_semantics_tpu/server/presets.py; the six presets are
copied unchanged. Label CSVs resolve against --cfg-dir, then
$KIMERA_CFG_DIR.

Each preset reproduces the `<param>` tree of one reference launch file
(kimera_semantics_ros/launch/*.launch) as a set of CLI-argument defaults for
server/node.py (`--preset NAME`; explicit flags still override, exactly like
`roslaunch` arg overrides). The two stereo-matching launch files
(stereo_depth.launch, disparity_to_depth.launch) configure ROS image_proc
nodelets that *produce* the depth image upstream of the mapper; this
framework ingests depth images directly (io/dataset.py), so they have no
preset — their output is the `depth` input here.

Label CSVs are the reference's own cfg/ files (same format —
core/color.py); `semantic_csv` holds the canonical filename, resolved
against --cfg-dir / $KIMERA_CFG_DIR so deployments can point at their copy
of the reference's cfg directory (or any CSV in that format).
"""

from __future__ import annotations

import os

# name -> (description, {cli_dest: default}), provenance in comments.
PRESETS = {
    # kimera_semantics.launch:3-4,96-132 — the canonical demo operating
    # point (TESSE office scene, 5 Hz frames, 1 s incremental meshing).
    "demo": {
        "depth_topic": "/tesse/depth_cam/mono/image_raw",
        "semantic_topic": "/tesse/seg_cam/rgb/image_raw",
        "cam_info_topic": "/tesse/depth_cam/camera_info",
        "voxel_size": 0.05, "voxels_per_side": 32, "max_ray_length": 5.0,
        "method": "fast", "color_mode": "semantic",
        "measurement_probability": 0.8, "dynamic_labels": [20],
        "semantic_csv": "tesse_multiscene_office1_segmentation_mapping.csv",
    },
    # kimera_semantics_rosbag.launch:3-19,45-70 — offline uHumans2 batch
    # reconstruction (apartment scene CSV, GT poses, dynamic masking).
    "rosbag": {
        "depth_topic": "/tesse/depth_cam/mono/image_raw",
        "semantic_topic": "/tesse/seg_cam/rgb/image_raw",
        "cam_info_topic": "/tesse/depth_cam/camera_info",
        "voxel_size": 0.05, "voxels_per_side": 32, "max_ray_length": 5.0,
        "method": "fast", "color_mode": "semantic",
        "measurement_probability": 0.8, "dynamic_labels": [20],
        "semantic_csv": "tesse_multiscene_archviz1_segmentation_mapping.csv",
    },
    # kimera_semantics_uHumans2.launch:3-4,20 — live uHumans2 (longer rays,
    # office2 scene CSV); includes kimera_semantics.launch for the rest.
    "uhumans2": {
        "depth_topic": "/tesse/depth_cam/mono/image_raw",
        "semantic_topic": "/tesse/seg_cam/rgb/image_raw",
        "cam_info_topic": "/tesse/depth_cam/camera_info",
        "voxel_size": 0.05, "voxels_per_side": 32, "max_ray_length": 10.0,
        "method": "fast", "color_mode": "semantic",
        "measurement_probability": 0.8, "dynamic_labels": [20],
        "semantic_csv": "tesse_multiscene_office2_segmentation_mapping.csv",
    },
    # kimera_semantics_eval.launch:19-59 — synthetic-world evaluation
    # (0.1 m voxels, 16 vps, 0.4 m truncation, 15 m rays, 50 viewpoints).
    "eval": {
        "voxel_size": 0.1, "voxels_per_side": 16, "max_ray_length": 15.0,
        "truncation": 0.4, "method": "fast", "color_mode": "semantic",
        "measurement_probability": 0.8, "dynamic_labels": [20],
        "num_viewpoints": 50,
        "semantic_csv": "simulation.csv",
    },
    # kimera_semantics_euroc.launch:3-17 — metric-only EuRoC mapping
    # (no semantics: metric_semantic_reconstruction=false -> plain TSDF
    # server; labels stay unknown and color_mode=color keeps measured RGB).
    "euroc": {
        "voxel_size": 0.10, "voxels_per_side": 32, "max_ray_length": 5.0,
        "method": "fast", "color_mode": "color",
        "dynamic_labels": [], "semantic_csv": None,
    },
    # kimera_metric_realsense.launch:5-9 — RealSense D435i close-range
    # mapping with Mask-RCNN labels (includes kimera_semantics.launch).
    "realsense": {
        "depth_topic": "/depth_camera/aligned_depth_to_color/image_raw",
        "semantic_topic": "/depth_camera/color/semantic_image",
        "cam_info_topic": "/depth_camera/aligned_depth_to_color/camera_info",
        "voxel_size": 0.05, "voxels_per_side": 32, "max_ray_length": 2.5,
        "method": "fast", "color_mode": "semantic",
        "measurement_probability": 0.8, "dynamic_labels": [20],
        "semantic_csv": "maskrcnn_mapping.csv",
    },
}



def resolve_csv(name, cfg_dir=None):
    """Resolve a preset's CSV filename against --cfg-dir, then
    $KIMERA_CFG_DIR.

    Returns an absolute path, or None when the file (or name) is absent —
    callers then fall back to the random colormap, with a warning."""
    if not name:
        return None
    if os.path.isabs(name) and os.path.exists(name):
        return name
    for d in (cfg_dir, os.environ.get("KIMERA_CFG_DIR", "")):
        if d and os.path.exists(os.path.join(d, name)):
            return os.path.join(d, name)
    return None


def apply_preset(parser, name):
    """Install preset values as argparse defaults (explicit flags win)."""
    if name not in PRESETS:
        raise SystemExit(f"unknown preset {name!r}; available: "
                         f"{', '.join(sorted(PRESETS))}")
    known = {a.dest for a in parser._actions}
    parser.set_defaults(**{k: v for k, v in PRESETS[name].items()
                           if k in known})
