#!/usr/bin/env python3
"""The second witness of the output check's reference, at a cell's size:
the reference's frozen float32 walk against an exact float64 walk
(kbench/witness.py) over every band ray and carve job of some of the
cell's frames.

    python3 benchmark/witness.py --workload uhumans2.batch --seed 7 \
        --frames 0,15,30,45

Prints one JSON line a frame and a last line with the totals; exits 1
where a job not in doubt differs. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

# The largest gap of a step's value over its job's weight that float32
# rounding leaves (the distance's rounding at 10 m, over the drop-off's
# 0.05 m).
VALUE_LIMIT = 1e-4


def main(argv=None, device=None, root=ROOT) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--frames", default="0")
    args = p.parse_args(argv)
    import torch

    from kbench import scene, spec, witness
    if device is None:
        if not torch.cuda.is_available():
            print("error: the witness runs on a CUDA card", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    bench = spec.load(root)
    _, conf, traffic = spec.cell(bench, root, args.workload)
    frames = scene.frames(conf, traffic, args.seed, device)
    total = {}
    for f in (int(x) for x in args.frames.split(",")):
        rep = witness.frame_report(frames[f], conf, device)
        print("frame " + json.dumps({"frame": f, **rep}), flush=True)
        for stream, r in rep.items():
            t = total.setdefault(stream, dict.fromkeys(r, 0))
            for k, v in r.items():
                t[k] = max(t[k], v) if k in ("w", "wsdf", "gate") \
                    else t[k] + v
    bad = any(t["count_differs"] or t["voxel_differs"]
              or max(t["w"], t["wsdf"], t["gate"]) > VALUE_LIMIT
              for t in total.values())
    print("total " + json.dumps({"agrees": not bad,
                                 "value_limit": VALUE_LIMIT, **total}),
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
