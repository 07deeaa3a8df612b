#!/usr/bin/env python3
"""The budget sweep: the per-frame work of a configuration's frames over
many seeds, by the configuration's plain reference alone (no port), and
the least budgets at which no frame drops a ray or a carve job or spills
a segment.

    python3 benchmark/sweep.py --config uhumans2 --traffic batch \
        --seed 1000 --seeds 24

The configuration is BENCHMARK.json's entry of that name (under --root,
the checkout's root by default), its reference kbench/spec.py's
`reference`.

Prints one JSON line a seed (the largest per-frame count of each kind) and
a last line with the largest over all seeds and the least budgets: rays
and carve jobs each on a 512 grain, segments on a 4096 grain, each at
least the largest count plus four times the spread of the per-seed
largest counts (the margin for seeds the sweep did not draw), and the
stream's active share at those budgets (the reference's stream_length).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--root", default=ROOT)
    args = p.parse_args(argv)
    import torch

    from kbench import reference as ref
    from kbench import scene, spec
    if not torch.cuda.is_available():
        print("error: the sweep runs on a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    entry = {c["name"]: c for c in spec.load(args.root)["configs"]}[
        args.config]
    with open(os.path.join(args.root, entry["file"])) as f:
        conf = json.load(f)
    with open(os.path.join(args.root, "benchmark", "traffic",
                           args.traffic + ".json")) as f:
        traffic = json.load(f)
    reference = spec.reference(args.root, conf)
    fu, bu = conf["fusion"], conf["budgets"]
    # Budgets large enough that the reference keeps every ray and job:
    # the counts are then the frames' own.
    conf["budgets"] = dict(bu, max_rays=1 << 30, carve_budget=1 << 30)
    box = ref.Box(conf["scene"]["bounds"], fu["voxel_size"], dev)
    keys = ("rays", "carve_jobs", "segments", "entries", "touched_blocks",
            "rank_overflow", "outside")
    per_seed = []
    for i in range(args.seeds):
        seed = args.seed + i
        frames = scene.frames(conf, traffic, seed, dev)
        most = {k: 0 for k in keys}
        for fr in frames:
            u = reference.frame_update(fr, conf, box, dev)
            for k in keys:
                most[k] = max(most[k], getattr(u, k))
            del u
        per_seed.append(most)
        print("seed " + json.dumps({"seed": seed, **most}), flush=True)

    def least(k, grain):
        vals = [s[k] for s in per_seed]
        need = max(vals) + 4 * (max(vals) - min(vals))
        return grain * math.ceil(need / grain)
    rays, carve = least("rays", 512), least("carve_jobs", 512)
    segs = least("segments", 4096)
    n_stream = reference.stream_length(dict(conf, budgets=dict(
        bu, max_rays=rays, carve_budget=carve)))
    entries = max(s["entries"] for s in per_seed)
    print("least " + json.dumps({
        "max": {k: max(s[k] for s in per_seed) for k in keys},
        "min_of_max": {k: min(s[k] for s in per_seed) for k in keys},
        "max_rays": rays, "carve_budget": carve, "segment_budget": segs,
        "stream_entries_max": entries, "stream_length": n_stream,
        "active_share_max": entries / n_stream}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
