"""Dataset conversion CLI: rosbag <-> directory fixtures.

Counterpart: kimera_semantics_tpu/io/convert.py, with one more flag,
--device (default cuda), the device the frames pass through.

  python -m kimera_semantics_tpu_torch.io.convert bag-to-dir in.bag out_dir \
      [--depth-topic ... --semantic-topic ... --cam-info-topic ...]
  python -m kimera_semantics_tpu_torch.io.convert dir-to-bag in_dir out.bag \
      [--compression bz2]

Thin front door over io.dataset.save_directory_dataset and
io.rosbag.write_dataset_bag so users can move between the reference's bag
workflow and the .npz directory format without writing code.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kimera_semantics_tpu_torch.io.convert")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b2d = sub.add_parser("bag-to-dir")
    b2d.add_argument("bag")
    b2d.add_argument("out_dir")
    b2d.add_argument("--depth-topic", default="/tesse/depth_cam/mono/image_raw")
    b2d.add_argument("--semantic-topic", default="/tesse/seg_cam/rgb/image_raw")
    b2d.add_argument("--cam-info-topic", default="/tesse/depth_cam/camera_info")
    b2d.add_argument("--world-frame", default="world")
    b2d.add_argument("--sensor-frame", default=None)
    b2d.add_argument("--max-frames", type=int, default=None)
    b2d.add_argument("--semantic-csv", default=None,
                     help="label,color CSV so color<->id decoding matches "
                          "the mapping used to record the bag")

    d2b = sub.add_parser("dir-to-bag")
    d2b.add_argument("in_dir")
    d2b.add_argument("bag")
    d2b.add_argument("--compression", default="none", choices=["none", "bz2"])
    d2b.add_argument("--rate-hz", type=float, default=5.0)
    d2b.add_argument("--max-frames", type=int, default=None)
    d2b.add_argument("--semantic-csv", default=None,
                     help="label,color CSV used to encode label ids as the "
                          "semantic color image")

    for p in (b2d, d2b):
        p.add_argument("--device", default="cuda",
                       help="torch device the frames pass through (the "
                            "card, or 'cpu')")
    args = ap.parse_args(argv)
    lmap = None
    if args.semantic_csv:
        from ..core.color import LabelColorMap
        lmap = LabelColorMap.from_csv(args.semantic_csv)
    if args.cmd == "bag-to-dir":
        from .dataset import save_directory_dataset
        from .rosbag import RosbagDataset
        ds = RosbagDataset(args.bag, depth_topic=args.depth_topic,
                           semantic_topic=args.semantic_topic or None,
                           cam_info_topic=args.cam_info_topic,
                           world_frame=args.world_frame,
                           sensor_frame=args.sensor_frame,
                           label_map=lmap, device=args.device)
        n = (min(args.max_frames, len(ds)) if args.max_frames is not None
             else len(ds))
        save_directory_dataset(args.out_dir, ds, num_frames=n)
        print(f"wrote {n} frames to {args.out_dir}")
    else:
        from .dataset import DirectoryDataset
        from .rosbag import write_dataset_bag
        ds = DirectoryDataset(args.in_dir, label_map=lmap,
                              device=args.device)
        n = (min(args.max_frames, len(ds)) if args.max_frames is not None
             else len(ds))
        write_dataset_bag(args.bag, ds, num_frames=n,
                          compression=args.compression, rate_hz=args.rate_hz)
        print(f"wrote {n} frames to {args.bag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
