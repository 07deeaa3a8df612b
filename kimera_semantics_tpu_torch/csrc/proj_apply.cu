// K3: fused projective sample + apply, in place on the grid channels.
//
// Replaces the Pallas kernel projective_apply_fused / _proj_fused_kernel +
// _proj_tile of kimera_semantics_tpu/ops/pallas_kernels.py:784-881 and
// :610-728. For each voxel of each real row whose tile group is not the
// trash group: project the voxel centre, sample depth and label from the
// row's atlas window, compute the TSDF and vote terms (proj_common.cuh,
// shared with K4) and add them into wsum, wsdf, sem_count and the label's
// sem_delta plane (and wcolor in colour mode). Tile groups of the frame
// list are distinct by construction (grid/hash.py insert_frame_list), so
// every grid word has one writer and no atomics are needed.
//
// Bound on this card: latency and instruction issue, far above its byte
// bound (16 B per updated and per labelled voxel, the meta rows, 8 B per
// atlas pixel). Per voxel the arithmetic keeps every IEEE division and sqrt
// and every explicit __fmaf_rn of the plain version (--fmad=false,
// core/fp.py), so those stay. The first design (one thread per voxel in a
// grid of K/8 x 8 V3/256 CTAs) added five run-time integer divisions per
// voxel, reloaded the meta row, slot and pose in every thread, ran one
// dependent chain (meta -> atlas -> grid) per thread, and spent most of its
// 8192 CTAs on trash groups and padding rows: 13.06 us at the projective
// path's first frame (K 512, V3 4096), 8.8x its byte bound (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md).
//
// This design: a CTA takes one part (PART voxels) of one meta row, and
// loads the row's slot, its group's slot, the meta row and the pose in one
// round trip; a trash group or a padding row exits as a whole CTA. The
// kernel is instantiated for 16^3 and 8^3 blocks (every configuration that
// reaches K3, and the tests), where voxel coordinates come from shifts and
// masks, and for any other vps through division. Each thread takes VPT = 2
// voxels THREADS apart, so neighbouring lanes sit on neighbouring voxels
// (coalesced grid words) and a thread's voxels share y and z: the products
// T_ij * voxel_size and h_y * (T_i1 * voxel_size) are taken once, with the
// same operands and so the same rounding. Both atlas samples are issued
// before any update, then both voxels' grid reads, then their writes. A
// voxel whose sample is invalid skips the sqrt and divisions (it takes no
// update whatever they give). Measured alternatives, all bit-exact and
// slower at this shape (NVIDIA H100 80GB HBM3, 700 W): 1, 4 or 8 voxels a
// thread; 128 or 512 threads; persistent CTAs over the live rows (listed
// per CTA, or strided); the grid words read with the samples; the row
// staged through shared memory. chip_smoke.py measured it at 8.22-8.24 us
// at the projective path's first frame, against the first design's
// 13.05-13.06 us in the same run (NVIDIA H100 80GB HBM3, 700 W): 5.6x its
// byte bound, short of half the first design's time. What remains is the
// per-CTA chain of three dependent round trips (row, sample, grid) and the
// round trip each dead CTA (about 70% of the grid here) holds a slot for.
//
// Atlas reads go through the read-only path (__ldg). There is no TMA stage
// for them: a row's window is up to 128 x 256 pixels, 128 KB for each of
// the depth and label planes, more than fits beside what a CTA needs in
// 227 KB, and the whole atlas (4 planes, a few MB) stays in the 50 MB L2.
#include "proj_common.cuh"

// A CTA takes one part of PART = THREADS x VPT voxels of one meta row;
// voxel j of thread t in part q is q * PART + j * THREADS + t.
template <int VPS>
struct ApplyShape {             // 16^3 and 8^3: a thread keeps its y and z
  static constexpr int THREADS = VPS * VPS;
  static constexpr int VPT = 2;
};
template <>
struct ApplyShape<0> {          // any vps: coordinates by division
  static constexpr int THREADS = 256;
  static constexpr int VPT = 2;
};

// The CTA's constants: T_C_G's columns times voxel_size, and (known vps)
// the thread's own y and z in the block.
struct PoseConsts {
  float T0[3], T1[3], T2[3], T3[3];
  int ty, tz;
};

// One meta row: [v0, u0_atlas, real, lvl, u0_level, bx, by, bz] and slot.
struct Row {
  int m[8], slot;
};

template <int VPS>
__device__ __forceinline__ void apply_part(
    float* __restrict__ wsum, float* __restrict__ wsdf,
    float* __restrict__ sem_count, float* __restrict__ sem_delta,
    float* __restrict__ wcolor, const float* __restrict__ atlas,
    const ProjParams& p, const PoseConsts& c, const Row& row, int q) {
  constexpr int THREADS = ApplyShape<VPS>::THREADS;
  constexpr int VPT = ApplyShape<VPS>::VPT;
  const int v0 = row.m[0], u0a = row.m[1], lvl = row.m[3], u0l = row.m[4];
  const int vps = VPS ? VPS : p.vps;
  const int V3 = VPS ? VPS * VPS * VPS : p.V3;
  const int t = threadIdx.x;
  const size_t rows = (size_t)p.rows_total;
  const size_t row0 = (size_t)row.slot * V3;
  const size_t plane = (size_t)p.atlas_height * p.atlas_width;
  const int ox = row.m[5] * vps, oy = row.m[6] * vps, oz = row.m[7] * vps;
  // With a known vps the thread's voxels share y and z, and h_y * T_i1
  // (the same operands, so the same rounding) is taken once.
  const float hy = (float)(oy + c.ty) + 0.5f, hz = (float)(oz + c.tz) + 0.5f;
  float hyT[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) hyT[i] = hy * c.T1[i];
  float P[VPT][3];
  Pixel px[VPT];
  bool in[VPT];
  int vox[VPT];
  // Project every voxel of the part.
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    vox[j] = q * THREADS * VPT + j * THREADS + t;
    in[j] = VPS ? true : vox[j] < V3;
    if constexpr (VPS != 0) {  // x by a shift
      const float x = (float)(ox + vox[j] / (VPS * VPS)) + 0.5f;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        P[j][i] = __fmaf_rn(hz, c.T2[i], __fmaf_rn(x, c.T0[i], hyT[i])) +
                  c.T3[i];
    } else {
      const float x = (float)(ox + vox[j] / (vps * vps)) + 0.5f;
      const float y = (float)(oy + (vox[j] / vps) % vps) + 0.5f;
      const float z = (float)(oz + vox[j] % vps) + 0.5f;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        P[j][i] = __fmaf_rn(z, c.T2[i], __fmaf_rn(x, c.T0[i], y * c.T1[i])) +
                  c.T3[i];
    }
    px[j] = proj_pixel(P[j][0], P[j][1], P[j][2], v0, u0a, lvl, u0l, p);
  }
  // Every sample of the part in flight at once.
  float depth[VPT], labw[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const bool s = in[j] && px[j].inwin;
    depth[j] = s ? __ldg(atlas + px[j].a) : 0.f;
    labw[j] = s ? __ldg(atlas + plane + px[j].a) : 0.f;
  }
  VoxelTerms tv[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    tv[j] = proj_terms(P[j][0], P[j][1], P[j][2], px[j], depth[j],
                       (int)rintf(labw[j]), p);
    tv[j].upd = tv[j].upd && in[j];
  }
  // Every grid word the part changes read, then written.
  float ow[VPT], os[VPT], oc[VPT], od[VPT];
  bool lab_ok[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const size_t e = row0 + vox[j];
    lab_ok[j] = tv[j].upd && tv[j].vote && tv[j].label >= 0 &&
                tv[j].label < p.L;
    if (tv[j].upd) {
      ow[j] = wsum[e];
      os[j] = wsdf[e];
      if (tv[j].vote) oc[j] = sem_count[e];
      if (lab_ok[j]) od[j] = sem_delta[(size_t)tv[j].label * rows * V3 + e];
    }
  }
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (!tv[j].upd) continue;
    const size_t e = row0 + vox[j];
    wsum[e] = ow[j] + tv[j].w;
    wsdf[e] = os[j] + tv[j].w_sdf;
    if (tv[j].vote) sem_count[e] = oc[j] + 1.f;
    if (lab_ok[j])
      sem_delta[(size_t)tv[j].label * rows * V3 + e] = od[j] + p.lk_delta;
  }
  if (p.with_color) {
    const size_t cs = rows * V3;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (!(tv[j].upd && tv[j].gate)) continue;
      const size_t e = row0 + vox[j];
      float rgb[3];
      proj_rgb(__ldg(atlas + 2 * plane + tv[j].a),
               __ldg(atlas + 3 * plane + tv[j].a), rgb);
      wcolor[e] += tv[j].w * rgb[0];
      wcolor[cs + e] += tv[j].w * rgb[1];
      wcolor[2 * cs + e] += tv[j].w * rgb[2];
    }
  }
}

__device__ __forceinline__ Row load_row(const int* __restrict__ slots,
                                       const int* __restrict__ meta, int k) {
  Row row;
#pragma unroll
  for (int i = 0; i < 8; ++i) row.m[i] = __ldg(meta + 8 * k + i);
  row.slot = __ldg(slots + k);
  return row;
}

template <int VPS>
__device__ __forceinline__ PoseConsts load_pose(const float* __restrict__ tcg,
                                                const ProjParams& p) {
  PoseConsts c = {};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    c.T0[i] = __ldg(tcg + 4 * i) * p.voxel_size;
    c.T1[i] = __ldg(tcg + 4 * i + 1) * p.voxel_size;
    c.T2[i] = __ldg(tcg + 4 * i + 2) * p.voxel_size;
    c.T3[i] = __ldg(tcg + 4 * i + 3);
  }
  if constexpr (VPS != 0) {
    c.ty = (threadIdx.x / VPS) % VPS;
    c.tz = threadIdx.x % VPS;
  }
  return c;
}

template <int VPS>
__global__ void __launch_bounds__(ApplyShape<VPS>::THREADS)
    proj_apply_kernel(float* __restrict__ wsum, float* __restrict__ wsdf,
                      float* __restrict__ sem_count,
                      float* __restrict__ sem_delta,
                      float* __restrict__ wcolor,
                      const int* __restrict__ slots,
                      const int* __restrict__ meta,
                      const float* __restrict__ tcg,
                      const float* __restrict__ atlas, ProjParams p) {
  constexpr int THREADS = ApplyShape<VPS>::THREADS;
  constexpr int PART = THREADS * ApplyShape<VPS>::VPT;
  const int V3 = VPS ? VPS * VPS * VPS : p.V3;
  const int parts = (V3 + PART - 1) / PART;
  const int k = blockIdx.x / parts;
  // One round trip for everything the part reads besides the atlas and the
  // grid: its tile group's slot, its meta row and slot, and the pose.
  const int group_slot = __ldg(slots + 8 * (k >> 3));
  const Row row = load_row(slots, meta, k);
  const PoseConsts c = load_pose<VPS>(tcg, p);
  // A trash group or a padding row: nothing to add.
  if (group_slot / 8 == p.trash_group || row.m[2] == 0) return;
  apply_part<VPS>(wsum, wsdf, sem_count, sem_delta, wcolor, atlas, p, c, row,
                  blockIdx.x - k * parts);
}

template <int VPS>
static int launch(float* wsum, float* wsdf, float* sem_count,
                  float* sem_delta, float* wcolor, const int* slots,
                  const int* meta, const float* tcg, const float* atlas,
                  const ProjParams& p, cudaStream_t stream) {
  constexpr int THREADS = ApplyShape<VPS>::THREADS;
  constexpr int PART = THREADS * ApplyShape<VPS>::VPT;
  const int parts = (p.V3 + PART - 1) / PART;
  proj_apply_kernel<VPS><<<p.K * parts, THREADS, 0, stream>>>(
      wsum, wsdf, sem_count, sem_delta, wcolor, slots, meta, tcg, atlas, p);
  return (int)cudaGetLastError();
}

extern "C" int ksd_proj_apply_fused(float* wsum, float* wsdf, float* sem_count,
                                    float* sem_delta, float* wcolor,
                                    const int* slots, const int* meta,
                                    const float* tcg, const float* atlas,
                                    ProjParams p, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (p.vps == 16)
    return launch<16>(wsum, wsdf, sem_count, sem_delta, wcolor, slots, meta,
                      tcg, atlas, p, s);
  if (p.vps == 8)
    return launch<8>(wsum, wsdf, sem_count, sem_delta, wcolor, slots, meta,
                     tcg, atlas, p, s);
  return launch<0>(wsum, wsdf, sem_count, sem_delta, wcolor, slots, meta,
                   tcg, atlas, p, s);
}
