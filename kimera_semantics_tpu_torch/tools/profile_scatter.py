"""Post-reduce grid-scatter strategies, timed on the card.

Counterpart: scripts/profile_scatter_r4.py, with its own copy of what it
took from scripts/profile_reduce_r4.py (bench_cfg, INTR). After the segment
reduce of a fast frame, the grid receives each (voxel, label) segment
once; this tool times the ways to add a realistic segment list into the
grid channels, each strategy chained `frames` + 1 times in place on its own
zeroed targets:

  A    wsum walk alone: indexed add of the sorted segment voxels
       (budget B, the trash past the segments)
  A'   the same through index_put_ with accumulate (the reference's
       unique-index promise)
  B    all three voxel-channel walks (wsum, wsdf, sem_count)
  C    the sem_delta scatter (unsorted, over the L label planes)
  F    the sem_delta scatter with label-major sorted keys
  D    A at budgets 32768 and 24576 (the live segments are ~19k)
  E    staged fusion: ONE (B, 8)-row payload add into a (rows * V3, 8)
       staging buffer, then dense adds into the channels
  G    compact staging over the touched rows (512): indexed adds into a
       (512 * V3,) staging, then one row add per channel

The segment list is the script's: nseg segments over ~460 touched slots,
seeded (numpy seed 0), sorted, TRASH_KEY beyond. Full size (the default):
capacity 4096, V3 4096, L 21, B 98304, nseg 18885; --smoke gives the
script's CPU sizes (512, 512, 21, 16384, 1200).

Differences from the reference, none of which changes a result:
  - torch has no `mode="drop"`, and on CUDA an out-of-range index is a
    device-side assert. The dropped trash of C and F (key L * rows * V3,
    one past the label planes) lands in one trash word the target carries
    past its end.
  - torch has no sortedness or uniqueness promise. The reference's
    uniqueness promise (A', C, F) is not even true of its list: segments
    of one voxel with other labels repeat a voxel, and a few (voxel,
    label) keys repeat. So A, B, D, E and G add with index_add_ (atomics
    on CUDA) and A', C and F with index_put_(accumulate=True), torch's
    other accumulate route.
  - F's promise in the reference is made over keys that are voxel-major,
    not label-major (a timing lie there, profile_scatter_r4.py:310-318);
    torch has no promise to lie with, so F sorts its keys first, as the
    reference's comment says a real implementation would.

Probes (the reference's environment switches), each run through the
port's own modules before the strategies:
  --ballast-gb X   hold X GiB of live tensors on the device
  --warm-kernel    the WARM_PALLAS probe: launch K7 (ops/kernels.py
                   add_f32, csrc/add.cu) once on (8, 128) float32. The
                   reference runs its kernel under a raised scoped-VMEM
                   limit (100 MB); the card has no such limit to raise.
  --warm-mode M    one isolated pipeline piece: grid, dda, sorts, lookup,
                   raceset, whileset, probe, insert or carve
  --warm-pipe      two real fast frames at bench_cfg

    python -m kimera_semantics_tpu_torch.tools.profile_scatter \
        [--frames 64] [--smoke] [--device cuda] [probes]

`run()` returns each strategy's ms per call and its final channels, which
equal (frames + 1) times one indexed add of the live segments (every value
is 1 or 0.5, so those sums are exact in any order).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..config import (FusionConfig, GridConfig, PipelineConfig,
                      SemanticConfig, TsdfConfig)
from ..core.camera import PinholeIntrinsics
from ..device import resolve
from ..ops.reduce import TRASH_KEY

WARM_MODES = ("grid", "dda", "sorts", "lookup", "raceset", "whileset",
              "probe", "insert", "carve")
# The strategies in the order they run, and the channels each writes.
CHANNELS = {"A": ("wsum",), "A'": ("wsum",), "B": ("wsum", "wsdf", "cnt"),
            "C": ("sem_delta",), "F": ("sem_delta",), "D32768": ("wsum",),
            "D24576": ("wsum",), "E": ("wsum", "wsdf", "cnt"),
            "G": ("wsum", "wsdf", "cnt")}
STRATEGIES = tuple(CHANNELS)


def intrinsics(smoke: bool) -> PinholeIntrinsics:
    """INTR of scripts/profile_reduce_r4.py."""
    if smoke:
        return PinholeIntrinsics(fx=32.0, fy=32.0, cx=31.5, cy=23.5,
                                 width=64, height=48)
    return PinholeIntrinsics(fx=320.0, fy=320.0, cx=319.5, cy=239.5,
                             width=640, height=480)


def bench_cfg(smoke: bool) -> FusionConfig:
    """bench_cfg of scripts/profile_reduce_r4.py: bench.py's fast
    configuration (or its CPU shakeout size)."""
    if smoke:
        return FusionConfig(
            grid=GridConfig(voxel_size=0.2, voxels_per_side=8,
                            block_capacity=512),
            tsdf=TsdfConfig(truncation_distance=0.4, max_ray_length_m=4.0,
                            carve_mode="projective", band_density="matched"),
            semantic=SemanticConfig(semantic_measurement_probability=0.8),
            pipeline=PipelineConfig(max_rays=4096, dedup_table_size=1 << 14,
                                    segment_budget=1 << 14, block_budget=128))
    return FusionConfig(
        grid=GridConfig(voxel_size=0.05, voxels_per_side=16,
                        block_capacity=4096),
        tsdf=TsdfConfig(truncation_distance=0.1, max_ray_length_m=5.0,
                        voxel_carving_enabled=True, use_const_weight=False,
                        carve_mode="projective", band_density="matched"),
        semantic=SemanticConfig(semantic_measurement_probability=0.8),
        pipeline=PipelineConfig(max_rays=28672, dedup_table_size=1 << 20,
                                segment_budget=98304, alloc_stride=8,
                                block_budget=512))


def sizes(smoke: bool):
    """(cap, V3, L, B, nseg) of the reference script."""
    return (512, 512, 21, 1 << 14, 1200) if smoke else \
        (4096, 4096, 21, 98304, 18885)


def segments(smoke: bool, dev):
    """The script's seeded segment list: a dict of the sorted voxel
    indices, their values and label keys, and the touched slots."""
    cap, v3, L, B, nseg = sizes(smoke)
    rows = cap + 8
    n_flat = (cap + 1) * v3
    row_flat = rows * v3
    lab_shift = max(1, (L - 1).bit_length())
    rng = np.random.default_rng(0)
    n_touched = 60 if smoke else 460
    slots = np.sort(rng.choice(cap, size=n_touched, replace=False))
    seg_slot = rng.choice(slots, size=nseg)
    seg_local = rng.integers(0, v3, size=nseg)
    seg_lab = rng.integers(1, L, size=nseg)
    vox_np = seg_slot.astype(np.int64) * v3 + seg_local
    k2 = np.sort((vox_np << lab_shift) | seg_lab).astype(np.int32)
    ok = np.full((B,), TRASH_KEY, np.int32)
    ok[:nseg] = k2
    ok = torch.as_tensor(ok, device=dev)
    seg_valid = ok != TRASH_KEY
    tw = torch.where(seg_valid, 1.0, 0.0)
    vox = torch.where(seg_valid, ok >> lab_shift, n_flat).long()
    lab = (ok & ((1 << lab_shift) - 1)).long()
    sem_key = torch.where(seg_valid, lab * row_flat + vox, L * row_flat)
    return dict(cap=cap, v3=v3, L=L, B=B, nseg=nseg, rows=rows,
                slots=slots, seg_valid=seg_valid, vox=vox, tw=tw,
                tsdf_s=tw * 0.5, tcnt=tw, sem_key=sem_key)


def reference(seg) -> dict:
    """One indexed add of the live segments into zeroed channels: what
    each strategy adds per call."""
    rows, v3, L = seg["rows"], seg["v3"], seg["L"]
    live = seg["seg_valid"]
    dev = seg["vox"].device
    out = {}
    for name, vals in (("wsum", seg["tw"]), ("wsdf", seg["tsdf_s"]),
                       ("cnt", seg["tcnt"])):
        t = torch.zeros(rows * v3, device=dev)
        t.index_add_(0, seg["vox"][live], vals[live])
        out[name] = t.view(rows, v3)
    sd = torch.zeros(L * rows * v3, device=dev)
    sd.index_add_(0, seg["sem_key"][live], seg["tcnt"][live])
    out["sem_delta"] = sd.view(L, rows, v3)
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def chain(name, step, state, n, dev, log):
    """In-place state threaded through `step` once, then n timed times;
    returns (ms per call, state)."""
    step(*state)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        step(*state)
    _sync(dev)
    ms = 1e3 * (time.perf_counter() - t0) / n
    log(f"{name:<52} {ms:8.3f} ms")
    return ms, state


def warm_up(mode, smoke, dev, log):
    """One isolated pipeline piece (--warm-mode), through the port's
    modules."""
    from ..grid import blocks as gblocks
    from ..grid import hash as bhash
    cfgp = bench_cfg(smoke)
    g = cfgp.grid
    if mode == "grid":
        gr = gblocks.create(cfgp, device=dev)
        _sync(dev)
        del gr
    elif mode == "dda":
        from ..ops import kernels
        R = cfgp.pipeline.max_rays
        S = cfgp.pipeline.resolved_band_steps(g, cfgp.tsdf)
        z3 = torch.zeros((3, R), device=dev)
        o = kernels.dda_job_stream(cfgp, S, z3, z3 + 1.0, z3, z3 + 1.0,
                                   torch.ones((R,), device=dev),
                                   torch.ones((R,), dtype=torch.bool,
                                              device=dev))
        _sync(dev)
        del o
    elif mode == "sorts":
        ks = torch.arange(143360, dtype=torch.int32, device=dev) % 997
        sk = torch.sort(ks)[0]
        first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                           sk[1:] != sk[:-1]])
        torch.sort(torch.where(first, sk, TRASH_KEY))
    elif mode == "lookup":
        gr = gblocks.create(cfgp, device=dev)
        uk = torch.arange(4096, dtype=torch.int32, device=dev)
        bhash.lookup(gr.table_keys, gr.table_slots, uk, g.table_size)
        del gr
    elif mode in ("raceset", "whileset"):
        tkeys = torch.full((g.table_size,), -1, dtype=torch.int32,
                           device=dev)
        ks = torch.arange(512, dtype=torch.int32, device=dev)
        idx = (bhash.mix(ks) & (g.table_size - 1)).long()
        for _ in range(1 if mode == "raceset" else 2):
            tkeys[idx] = ks
            idx = (idx + 1) & (g.table_size - 1)
    elif mode in ("probe", "insert"):
        gr = gblocks.create(cfgp, device=dev)
        if mode == "probe":
            uk = torch.arange(512, dtype=torch.int32, device=dev)
            bhash.insert(gr.table_keys, gr.table_slots, gr.block_coords,
                         gr.n_blocks, uk, uk >= 0, g.table_size,
                         g.block_capacity, g.world_extent_blocks)
        else:
            ks = torch.arange(143360, dtype=torch.int32, device=dev) % 997
            bhash.insert_compacted(gr.table_keys, gr.table_slots,
                                   gr.block_coords, gr.n_blocks, ks,
                                   ks >= 0, g.table_size, g.block_capacity,
                                   g.world_extent_blocks)
        del gr
    elif mode == "carve":
        from ..core.color import LabelColorMap
        from ..io.dataset import SyntheticDataset
        from ..models import fast as fast_mod
        intr = intrinsics(smoke)
        ds = SyntheticDataset(num_frames=2, intr=intr,
                              label_map=LabelColorMap.random(21),
                              device=dev)
        gr = gblocks.create(cfgp, device=dev)
        fast_mod._maybe_projective_carve(gr, ds.frame(0), cfgp, intr)
        del gr
    else:
        raise ValueError(f"unknown warm mode {mode!r} (one of {WARM_MODES})")
    _sync(dev)
    log(f"warm: mode={mode} ran")


def run(frames: int = 64, smoke: bool = False, device="cuda",
        ballast_gb: float = 0.0, warm_kernel: bool = False,
        warm_mode: str = "", warm_pipe: bool = False, log=print) -> dict:
    """Time every strategy; returns {"segments": the segment list,
    "ms": {strategy: ms per call}, "channels": {strategy: {channel: final
    tensor}}, "frames": n}."""
    dev = resolve(device)
    n = frames
    cap, v3, L, B, nseg = sizes(smoke)
    log(f"device={dev} cap={cap} v3={v3} B={B} nseg={nseg} frames={n}")

    ballast = []
    left = ballast_gb
    while left > 0:
        chunk = min(left, 0.5)
        ballast.append(torch.ones((int(chunk * (1 << 28)),), device=dev))
        left -= chunk
    if ballast:
        _sync(dev)
        log(f"ballast: {sum(b.numel() * 4 for b in ballast) / 2**30:.2f} "
            "GiB")
    if warm_kernel:
        from ..ops import kernels
        x = torch.ones((8, 128), dtype=torch.float32, device=dev)
        o = kernels.add_f32(x, x)
        _sync(dev)
        if not torch.equal(o, x + x):
            raise RuntimeError("warm kernel: add_f32 gave a wrong sum")
        log("warm: K7 add_f32 (8, 128) ran")
    if warm_mode:
        warm_up(warm_mode, smoke, dev, log)
    if warm_pipe:
        from ..core.color import LabelColorMap
        from ..grid import blocks as gblocks
        from ..io.dataset import SyntheticDataset
        from ..models import fast as fast_mod
        cfgp, intr = bench_cfg(smoke), intrinsics(smoke)
        ds = SyntheticDataset(num_frames=3, intr=intr,
                              label_map=LabelColorMap.random(21),
                              device=dev)
        gr = gblocks.create(cfgp, device=dev)
        for i in range(2):
            fast_mod.integrate_frame(gr, ds.frame(i), cfgp, intr, device=dev)
        _sync(dev)
        del gr
        log("warm: 2 real fast frames ran")

    seg = segments(smoke, dev)
    rows, vox, tw, tsdf_s, tcnt = (seg["rows"], seg["vox"], seg["tw"],
                                   seg["tsdf_s"], seg["tcnt"])
    sem_key = seg["sem_key"]
    _sync(dev)

    def mk(k=1):
        return [torch.zeros((rows, v3), device=dev) for _ in range(k)]

    def mkd():
        # The label planes plus one trash word past their end.
        return torch.zeros((L * rows * v3 + 1,), device=dev)

    ms, out = {}, {}

    def add_walk(t, v, x):
        t.view(-1).index_add_(0, v, x)

    def put_walk(t, v, x):
        t.view(-1).index_put_((v,), x, accumulate=True)

    def keep(name, state):
        out[name] = dict(zip(CHANNELS[name], state))

    # --- A: single budget walk
    ms["A"], st = chain("A  wsum walk alone (sorted)", add_walk,
                        (mk()[0], vox, tw), n, dev, log)
    keep("A", st[:1])
    ms["A'"], st = chain("A' wsum walk (index_put_ accumulate)", put_walk,
                         (mk()[0], vox, tw), n, dev, log)
    keep("A'", st[:1])

    # --- B: all three voxel walks
    def three(a, b, c, v, x, y, z):
        add_walk(a, v, x)
        add_walk(b, v, y)
        add_walk(c, v, z)
    ms["B"], st = chain("B  three voxel walks", three,
                        (*mk(3), vox, tw, tsdf_s, tcnt), n, dev, log)
    keep("B", st[:3])

    # --- C: semd scatter; F: with label-major sorted keys
    ms["C"], st = chain("C  semd scatter (index_put_, unsorted)",
                        put_walk, (mkd(), sem_key, tcnt), n, dev, log)
    out["C"] = {"sem_delta": st[0][:-1].view(L, rows, v3)}
    sk, perm = torch.sort(sem_key)
    ms["F"], st = chain("F  semd walk (label-major sorted keys)",
                        put_walk, (mkd(), sk, tcnt[perm]), n, dev, log)
    out["F"] = {"sem_delta": st[0][:-1].view(L, rows, v3)}

    # --- D: small-budget variants
    for Bs in (32768, 24576):
        name = f"D{Bs}"
        ms[name], st = chain(f"D  wsum walk at budget {Bs}", add_walk,
                             (mk()[0], vox[:Bs], tw[:Bs]), n, dev, log)
        keep(name, st[:1])

    # --- E: staged row-payload fusion
    zero = torch.zeros_like(tw)
    pay = torch.stack([tw, tsdf_s, tcnt, tcnt, zero, zero, zero, zero],
                      dim=1)

    def staged(a, b, c, v, p):
        st8 = torch.zeros((rows * v3, 8), device=dev)
        st8.index_add_(0, v, p)
        a.view(-1).add_(st8[:, 0])
        b.view(-1).add_(st8[:, 1])
        c.view(-1).add_(st8[:, 2])
    ms["E"], st = chain("E  staged (B,8) row scatter + dense adds", staged,
                        (*mk(3), vox, pay), n, dev, log)
    keep("E", st[:3])

    # --- G: compact staging over the touched rows
    slots = seg["slots"]
    lut_np = np.full((cap + 1,), 511, np.int32)
    lut_np[slots[:511]] = np.arange(min(511, len(slots)))
    lut = torch.as_tensor(lut_np, device=dev).long()
    rvox = torch.where(seg["seg_valid"],
                       lut[torch.clamp(vox // v3, max=cap)] * v3 + vox % v3,
                       512 * v3)
    fslots = torch.as_tensor(np.concatenate(
        [slots[:511], [cap] * (512 - min(511, len(slots)))]).astype(
            np.int64), device=dev)

    def compactstage(a, b, c, v, x, y, z):
        st4 = torch.zeros((512 * v3 + 1, 4), device=dev)
        st4.index_add_(0, v, torch.stack([x, y, z, z], dim=1))
        stf = st4[:512 * v3].view(512, v3, 4)
        a.index_add_(0, fslots, stf[:, :, 0])
        b.index_add_(0, fslots, stf[:, :, 1])
        c.index_add_(0, fslots, stf[:, :, 2])
    ms["G"], st = chain("G  compact staging (512 rows) + row adds",
                        compactstage, (*mk(3), rvox, tw, tsdf_s, tcnt), n,
                        dev, log)
    keep("G", st[:3])
    del ballast
    return {"segments": seg, "ms": ms, "channels": out, "frames": n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="kimera_semantics_tpu_torch.tools.profile_scatter",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=64,
                    help="timed calls per strategy (after one warm call)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference script's CPU shakeout sizes")
    ap.add_argument("--device", default="cuda",
                    help="torch device: the card (default) or 'cpu'")
    ap.add_argument("--ballast-gb", type=float, default=0.0)
    ap.add_argument("--warm-kernel", action="store_true",
                    help="launch K7 add_f32 once on (8, 128) first")
    ap.add_argument("--warm-mode", default="", choices=("",) + WARM_MODES)
    ap.add_argument("--warm-pipe", action="store_true")
    a = ap.parse_args(argv)
    res = run(frames=a.frames, smoke=a.smoke, device=a.device,
              ballast_gb=a.ballast_gb, warm_kernel=a.warm_kernel,
              warm_mode=a.warm_mode, warm_pipe=a.warm_pipe)
    ref = reference(res["segments"])
    k = res["frames"] + 1
    for name, chans in res["channels"].items():
        for c, t in chans.items():
            if not torch.equal(t, k * ref[c]):
                print(f"{name}: {c} differs from {k} x the reference "
                      "scatter", file=sys.stderr)
                return 1
    print(f"every strategy's channels equal {k} x one indexed add of the "
          "live segments")
    return 0


if __name__ == "__main__":
    sys.exit(main())
