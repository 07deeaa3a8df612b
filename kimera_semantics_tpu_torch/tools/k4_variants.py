"""K4's design variants and ablations, timed on the card (no JAX
counterpart: a measurement tool for csrc/proj_sample.cu).

    python -m kimera_semantics_tpu_torch.tools.k4_variants \
        [--parent CHECKOUT] [--only NAME,NAME] [--rounds 3]

Each variant is K4's source with text substitutions (`variants`). Every
variant is built by its own nvcc process with the port's flags into
../_build/k4_variants/<name>/, bound with ctypes, held to
projective_sample_update_plain on the live tiles bit for bit (the
ablations, which compute something else, are not), and timed with
torch.profiler over 50 launches in alternating rounds at chip_smoke.py's
K4 shapes: the canonical projective frame (K 512, V3 4096), 32^3 literal
storage (V3 32768), and vps 5 and 21. `--parent` adds another checkout's
K4 as "parent". Prints one line per shape (median and range of each
variant, the byte bound) and one JSON object of every time. Needs a CUDA
card and nvcc; run from the repository root.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

from ..ops import _build

CHOSEN = "chosen"

_POSE_SHARED = ("  __shared__ Pose c;  // read by every thread: not held in "
                "registers\n"
                "  if (threadIdx.x < 3) {\n"
                "    const int i = threadIdx.x;\n")
_POSE_REGISTERS = """  Pose c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
"""
_TERMS = """    t[j] = proj_terms(P[j][0], P[j][1], P[j][2], px[j], depth[j],
                      (int)rintf(labw[j]), p);"""
_NO_TERMS = """    t[j].upd = depth[j] > 0.f;
    t[j].w = depth[j];
    t[j].w_sdf = P[j][2];
    t[j].vote = true;
    t[j].label = (int)labw[j];
    t[j].gate = false;
    t[j].a = px[j].a;"""
_GRID = "const int grid = min(n_items, per_sm * sms);"
# The generic instance's coordinates by a multiply-high with m =
# floor((2^32 - 1) / d) + 1, exact for n * d < 2^32 (vps <= 84 here).
_DIV = """      const float hx = (float)(it.m[5] * vps + vox[j] / (vps * vps)) + 0.5f;
      const float hy = (float)(it.m[6] * vps + (vox[j] / vps) % vps) + 0.5f;
      const float hz = (float)(it.m[7] * vps + vox[j] % vps) + 0.5f;"""
_MULHI = """      const int lx = (int)__umulhi((unsigned)vox[j],
                                   0xFFFFFFFFu / (vps * vps) + 1);
      const int r = vox[j] - lx * vps * vps;
      const int ly = (int)__umulhi((unsigned)r, 0xFFFFFFFFu / vps + 1);
      const float hx = (float)(it.m[5] * vps + lx) + 0.5f;
      const float hy = (float)(it.m[6] * vps + ly) + 0.5f;
      const float hz = (float)(it.m[7] * vps + r - ly * vps) + 0.5f;"""
_VPT = "static constexpr int VPT = VPS ? 4 : 1;"
# The 16^3/32^3 part with its VPT voxels TPI apart (4-byte stores, each
# warp store on 32 neighbouring words) instead of consecutive along z.
_STRIDED = """template <int VPS>
__device__ __forceinline__ void sample_part(const SamplePtrs& a,
                                            const ProjParams& p,
                                            const Pose& c, const Item& it,
                                            int t) {
  constexpr int V3 = VPS * VPS * VPS, PART = Shape<VPS>::PART;
  constexpr int VPT = Shape<VPS>::VPT, TPI = Shape<VPS>::TPI;
  int vox[VPT];
  bool in[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    vox[j] = it.q * PART + j * TPI + t;
    in[j] = true;
  }
  Out o[VPT];
  if (it.m[2] == 0) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) zero_out(o[j]);
  } else {
    float P[VPT][3];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const float hx = (float)(it.m[5] * VPS + vox[j] / (VPS * VPS)) + 0.5f;
      const float hy = (float)(it.m[6] * VPS + (vox[j] / VPS) % VPS) + 0.5f;
      const float hz = (float)(it.m[7] * VPS + vox[j] % VPS) + 0.5f;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        P[j][i] = point(hz, c.T2[i], __fmaf_rn(hx, c.T0[i], hy * c.T1[i]),
                        c.T3[i]);
    }
    sample_voxels(P, in, it, a.atlas, p, o);
  }
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const size_t e = (size_t)it.k * V3 + vox[j];
    a.d_w[e] = o[j].w;
    a.d_wsdf[e] = o[j].wsdf;
    a.d_cnt[e] = o[j].cnt;
    a.d_lab[e] = o[j].lab;
    if (p.with_color) {
      const size_t c0 = (size_t)it.k * 3 * V3 + vox[j];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        a.d_wc[c0 + (size_t)ch * V3] = o[j].wc[ch];
    }
  }
}

"""
# Colour mode as a template parameter of every instance.
_COLOUR_TEMPLATE = [
    ("template <int VPT>\n__device__ __forceinline__ void sample_voxels(",
     "template <int VPT, bool COLOR>\n"
     "__device__ __forceinline__ void sample_voxels("),
    ("  if (p.with_color) {\n    float rgw[VPT], bw[VPT];",
     "  if constexpr (COLOR) {\n    float rgw[VPT], bw[VPT];"),
    ("template <int VPS>\n__device__ __forceinline__ void sample_part(",
     "template <int VPS, bool COLOR>\n"
     "__device__ __forceinline__ void sample_part("),
    ("    sample_voxels(P, in, it, a.atlas, p, o);",
     "    sample_voxels<VPT, COLOR>(P, in, it, a.atlas, p, o);"),
    ("    if (p.with_color) {\n      const size_t c0 = (size_t)it.k * 3 * V3"
     " + v0 + g;",
     "    if constexpr (COLOR) {\n      const size_t c0 = (size_t)it.k * 3 *"
     " V3 + v0 + g;"),
    ("template <>\n__device__ __forceinline__ void sample_part<0>(",
     "template <bool COLOR>\n"
     "__device__ __forceinline__ void sample_part_any("),
    ("    if (p.with_color) {\n      const size_t c0 = (size_t)it.k * 3 * V3"
     " + vox[j];",
     "    if constexpr (COLOR) {\n      const size_t c0 = (size_t)it.k * 3 *"
     " V3 + vox[j];"),
    ("template <int VPS>\n__global__", "template <int VPS, bool COLOR>\n"
     "__global__"),
    ("      sample_part<VPS>(a, p, c, list[i], threadIdx.x % TPI);",
     "      if constexpr (VPS != 0)\n"
     "        sample_part<VPS, COLOR>(a, p, c, list[i], threadIdx.x % TPI);\n"
     "      else\n"
     "        sample_part_any<COLOR>(a, p, c, list[i], threadIdx.x % TPI);"),
    ("template <int VPS>\nint launch(", "template <int VPS, bool COLOR>\n"
     "int launch("),
    ("  auto kernel = proj_sample_kernel<VPS>;",
     "  auto kernel = proj_sample_kernel<VPS, COLOR>;"),
    ("  if (p.vps == 16 && vec) return launch<16>(a, p, s);\n"
     "  if (p.vps == 32 && vec) return launch<32>(a, p, s);\n"
     "  return launch<0>(a, p, s);",
     "  if (p.with_color) {\n"
     "    if (p.vps == 16 && vec) return launch<16, true>(a, p, s);\n"
     "    if (p.vps == 32 && vec) return launch<32, true>(a, p, s);\n"
     "    return launch<0, true>(a, p, s);\n  }\n"
     "  if (p.vps == 16 && vec) return launch<16, false>(a, p, s);\n"
     "  if (p.vps == 32 && vec) return launch<32, false>(a, p, s);\n"
     "  return launch<0, false>(a, p, s);"),
]


def _sub(src: str, *pairs) -> str:
    for old, new in pairs:
        if src.count(old) < 1:
            raise ValueError(f"K4 source has no {old.splitlines()[0]!r}")
        src = src.replace(old, new)
    return src


def _strided(src: str) -> str:
    i = src.index("// 16^3 and 32^3: thread t takes")
    j = src.index("// Any vps: lane t takes")
    return src[:i] + _STRIDED + src[j:]


def variants(src: str) -> dict:
    """{name: source} of K4's variants, from its source `src`. Names
    starting with "ablation" compute something else than K4."""
    return {
        CHOSEN: src,
        "threads256": _sub(src, ("constexpr int THREADS = 128;",
                                 "constexpr int THREADS = 256;")),
        "threads64": _sub(src, ("constexpr int THREADS = 128;",
                                "constexpr int THREADS = 64;")),
        "pose_in_registers": _sub(src, (_POSE_SHARED, _POSE_REGISTERS)),
        "colour_template": _sub(src, *_COLOUR_TEMPLATE),
        "launch_bounds_64_registers": _sub(
            src, ("__launch_bounds__(THREADS)",
                  "__launch_bounds__(THREADS, 8)")),
        "strided_4B_stores": _strided(src),
        "strided_vpt2": _sub(_strided(src),
                             (_VPT, _VPT.replace("4 :", "2 :"))),
        "vpt8": _sub(src, (_VPT, _VPT.replace("4 :", "8 :"))),
        "warp_items": _sub(src, (
            "static constexpr int TPI = VPS ? THREADS : 32;",
            "static constexpr int TPI = 32;")),
        "grid_half": _sub(src, (_GRID, "const int grid = min(n_items, "
                                "(per_sm * sms + 1) / 2);")),
        "grid_quarter": _sub(src, (_GRID, "const int grid = min(n_items, "
                                   "(per_sm * sms + 3) / 4);")),
        "one_cta_per_item": _sub(src, (_GRID, "const int grid = n_items;")),
        "generic_vpt2": _sub(src, (_VPT, _VPT.replace(": 1", ": 2"))),
        "generic_vpt4": _sub(src, (_VPT, _VPT.replace(": 1", ": 4"))),
        "generic_multiply_high": _sub(src, (_DIV, _MULHI)),
        "ablation_zeros_only": _sub(src, (
            "  if (it.m[2] == 0) {  // padding row: no update",
            "  if (true) {  // padding row: no update")),
        "ablation_no_update_terms": _sub(src, (_TERMS, _NO_TERMS)),
    }


def _build_all(sources: dict, include: dict) -> dict:
    """Compile each source (one nvcc each, all at once); {name: entry}."""
    from ..ops import kernels
    out = os.path.join(_build.BUILD, "k4_variants")
    procs = {}
    for name, src in sources.items():
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        cu = os.path.join(d, "proj_sample.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", include.get(name,
                                                               _build.CSRC),
             "-o", os.path.join(d, "lib.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [ln.split("Used ")[1].split(",")[0] for ln in log.splitlines()
                if "Used " in ln and "registers" in ln]
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        print(f"[build] {name}: {', '.join(regs)}"
              f"{'; ' + '; '.join(spills) if spills else ''}")
        fn = ctypes.CDLL(os.path.join(out, name, "lib.so")) \
            .ksd_projective_sample_update
        fn.argtypes = [ctypes.c_void_p] * 9 + [kernels.ProjParams,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout whose K4 is timed "
                    "beside the variants")
    ap.add_argument("--only", help="comma-separated variant names")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k4_variants: needs a CUDA card", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(_build.CSRC.rstrip(os.sep)))
    sys.path.insert(0, root)
    import chip_smoke as cs

    import kimera_semantics_tpu_torch as kt
    from ..core import transforms
    from ..grid import blocks
    from ..io.dataset import SyntheticDataset
    from ..models import projective as proj
    from ..ops import kernels
    from ..ops import mip as mip_ops
    from ..ops import projective as proj_ops
    with open(os.path.join(_build.CSRC, "proj_sample.cu")) as f:
        sources = variants(f.read())
    if args.only:
        keep = args.only.split(",")
        sources = {n: s for n, s in sources.items() if n in keep}
    include = {}
    if args.parent:
        csrc = os.path.join(args.parent, "kimera_semantics_tpu_torch", "csrc")
        with open(os.path.join(csrc, "proj_sample.cu")) as f:
            sources = {"parent": f.read(), **sources}
        include["parent"] = csrc
    fns = _build_all(sources, include)
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)} | {cs.nvidia_smi_line()}")
    cfg, intr = cs.canonical(kt)
    f0 = SyntheticDataset(num_frames=1, intr=intr,
                          label_map=kt.LabelColorMap.random(
                              cfg.grid.num_labels), device=dev).frame(0)
    shapes = {"16^3": cfg, "32^3": cs.literal32_config(kt, cfg)}
    for vps, _ in cs.ODD_VPS:
        shapes[f"vps{vps}"] = dataclasses.replace(
            cfg, grid=dataclasses.replace(cfg.grid, voxels_per_side=vps,
                                          voxel_size=0.8 / vps))
    stream = torch.cuda.current_stream(dev).cuda_stream
    result = {}
    for tag, c in shapes.items():
        plan = proj.make_plan(c, intr)
        atlas = mip_ops.build_atlas(f0.depth, f0.labels, f0.colors, plan)
        _, fcoords, fslots, freal = proj.allocate_from_atlas(
            blocks.create(c, device=dev), atlas, f0.T_G_C, c, intr, plan)
        torch.cuda.empty_cache()
        T_C_G = transforms.inverse(f0.T_G_C)
        meta = kernels.block_meta(fcoords, freal, T_C_G, intr, plan,
                                  c.grid.block_size)
        K, V3 = meta.shape[0], c.grid.vps3
        tcg = T_C_G[:3, :4].contiguous()
        p = kernels._proj_params(c, intr, plan, K, c.grid.num_labels, False,
                                 "all", 0.0)
        ref = kernels.projective_sample_update_plain(meta, fslots, T_C_G,
                                                     atlas, c, intr, plan)
        live = (torch.div(fslots, 8, rounding_mode="floor")
                != c.grid.block_capacity // 8)
        real = live & (meta[:, 2] > 0)
        n_px = cs.atlas_pixels(proj_ops, meta, T_C_G, c, intr, plan, real)
        # chip_smoke.py k4_check's count: the live tiles' four delta planes,
        # meta and slots, the depth and label of each atlas pixel sampled
        bound_us = 1e6 * (16 * int(live.sum()) * V3 + K * 36 + 8 * n_px) \
            / cs.BANDWIDTH
        outs = [torch.empty((K, V3), dtype=d, device=dev) for d in
                (torch.float32,) * 3 + (torch.int32,)]

        def call(fn):
            rc = fn(*(x.data_ptr() for x in outs), None, fslots.data_ptr(),
                    meta.data_ptr(), tcg.data_ptr(), atlas.data_ptr(), p,
                    stream)
            if rc != 0:
                raise RuntimeError(f"K4 variant launch failed: {rc}")
        for name, fn in fns.items():
            for x in outs:
                x.fill_(-7)
            call(fn)
            torch.cuda.synchronize()
            if not name.startswith("ablation") and not all(
                    torch.equal(a[live], b[live]) for a, b in zip(outs, ref)):
                raise RuntimeError(f"{name} differs from the plain version "
                                   f"at {tag}")
        times = {n: [] for n in fns}
        for r in range(args.rounds):
            for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                ms = cs.device_time(lambda: call(fns[name]),
                                    "proj_sample_kernel", cs.REPS)
                if ms is None:
                    raise RuntimeError(f"no device time for {name}")
                times[name].append(1e3 * ms)
        result[tag] = dict(K=K, V3=V3, live_rows=int(live.sum()),
                           bound_us=bound_us,
                           us={n: sorted(t) for n, t in times.items()})
        print(f"[{tag}] K={K} V3={V3} live rows {int(live.sum())}, bound "
              f"{bound_us:.3f} us: " + ", ".join(
                  f"{n} {sorted(t)[len(t) // 2]:.3f} us ({min(t):.3f}-"
                  f"{max(t):.3f})" for n, t in times.items()))
        del outs, ref, atlas, meta
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
