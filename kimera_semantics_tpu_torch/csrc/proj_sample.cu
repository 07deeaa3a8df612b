// K4: projective sample + update terms, written out as delta planes.
//
// Replaces the Pallas kernel projective_sample_update / _proj_kernel +
// _proj_tile of kimera_semantics_tpu/ops/pallas_kernels.py:734-781,
// :577-607 and :610-728. K5 (block_rmw.cu, onehot votes) then adds the
// planes into the grid; this is the projective route for fused_apply=False
// and for blocks past the fused kernel's V3 (32^3 literal storage).
//
// Contract: every voxel of every live tile (slot group not the trash group)
// is written, zeros included, since K5 reads whole tiles; the tiles K5
// skips (the frame list's trash tiles, wherever they stand) stay
// unwritten. Per voxel the arithmetic is K3's (proj_common.cuh): every
// IEEE division and sqrt and every explicit __fmaf_rn of the plain version
// (--fmad=false), so each output equals projective_sample_update_plain bit
// for bit.
//
// Bound on this card: bytes. Each live tile writes 16 B per voxel (d_w,
// d_wsdf, d_cnt, d_lab; 12 B more in colour mode), which K5 reads back;
// the atlas window a row samples stays hot in L2. The first design (one
// thread per voxel in a grid of K/8 x 8 V3/256 CTAs) spent 70% (16^3) to
// 92% (32^3) of its CTAs on trash tiles, divided by the run-time vps three
// times per voxel, reloaded the meta row and the pose in every thread, and
// ran one dependent chain (meta -> sample -> four scalar stores) a voxel:
// 12.5 us at K 512 / V3 4096 and 39.4 us at V3 32768, 4.1x and 6.2x its
// byte bound (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// This design: a persistent grid (the occupancy API's CTAs per SM times the
// SMs) strides over work items, an item being one part of one frame-list
// row. A CTA first lists its live items in one round trip: thread j loads
// the tile's group slot and the meta row of the CTA's j-th item, and the
// live ones go to shared memory; a trash tile costs that one load, and a
// trash tile anywhere in the list is skipped. The pose times voxel_size is
// computed once per CTA into shared memory, with the operands of the plain
// version, so the bits do not change. A padding row stores zeros and skips
// the projection; a sample outside the window or with an invalid depth
// skips the sqrt and the divisions of the update terms. For 16^3 (the
// unfused route) and 32^3 blocks (literal storage) an item is 512 voxels
// taken by the whole CTA, 4 consecutive voxels along z a thread: they
// share x and y, so coordinates come from shifts and masks, h_x * T_i0 +
// h_y * T_i1 is taken once (the same operands, so the same rounding), the
// thread issues its 8 atlas loads before any store, and each plane takes
// 16-byte stores. Any other vps (5, 21, 8) takes the generic instance: an
// item is 32 voxels of a row taken by one warp, one voxel a lane,
// coordinates by division, 4-byte stores. chip_smoke.py measured it at
// 7.7 us (16^3) and 11.8-12.1 us (32^3), 2.5x and 1.9x the byte bound, and
// at 2.9 us (vps 5) and 18.6-19.7 us (vps 21) (NVIDIA H100 80GB HBM3, 700
// W). At 16^3 the launch, the listing round trip and the stores alone take
// about 4 us (an ablation storing zeros only), and the projection with its
// samples and the update terms (four IEEE divisions and a sqrt per sample)
// add about 1.6 and 2 us that the stores do not hide.
//
// Measured alternatives (tools/k4_variants.py; NVIDIA H100 80GB HBM3,
// 700 W; PERF.md ranks them), all bit-exact and none faster at 16^3 and
// 32^3: one CTA per item instead of the persistent grid (2.7x slower at
// 32^3: its dead CTAs cost what they did); half or a quarter of the
// persistent grid; 256 or 64 threads; 8 or 2 voxels a thread; the 4
// voxels 128 apart with 4-byte stores; 64 registers forced by launch
// bounds (spills); colour mode as a template parameter (56-64 registers);
// the pose held in registers; warp-sized items for 16^3 and 32^3. In the
// generic instance 2 or 4 voxels a lane were slower at vps 5, and a
// multiply-high division in place of the run-time one stayed within 3%.
#include "proj_common.cuh"

namespace {

constexpr int THREADS = 128;

// The threads that take one item (TPI), the voxels a thread takes (VPT)
// and the voxels of an item: for 16^3 and 32^3 the whole CTA, 4 voxels a
// thread; for any other vps one warp, 1 voxel a lane, so that small blocks
// (vps 5: 125 voxels a row) keep every lane busy.
template <int VPS>
struct Shape {
  static constexpr int TPI = VPS ? THREADS : 32;
  static constexpr int VPT = VPS ? 4 : 1;
  static constexpr int PART = TPI * VPT;
};

struct SamplePtrs {
  float* d_w;
  float* d_wsdf;
  float* d_cnt;
  int* d_lab;
  float* d_wc;  // (K, 3, V3), colour mode only
  const int* slots;
  const int* meta;
  const float* tcg;
  const float* atlas;
};

// T_C_G's columns times voxel_size (translation as is): h_j * T_ij below
// is the reassociated, fused form of ops/projective.py centers_to_camera.
struct Pose {
  float T0[3], T1[3], T2[3], T3[3];
};

// One listed item: its row, its part and the row's meta words [v0,
// u0_atlas, real, lvl, u0_level, bx, by, bz].
struct Item {
  int k, q, m[8];
};

// One voxel's outputs.
struct Out {
  float w, wsdf, cnt;
  int lab;
  float wc[3];
};

__device__ __forceinline__ void zero_out(Out& o) {
  o.w = o.wsdf = o.cnt = 0.f;
  o.lab = 0;
  o.wc[0] = o.wc[1] = o.wc[2] = 0.f;
}

// The voxels v[j] of one real row, projected from camera-frame points
// P[j]: samples first (every load of the thread in flight at once), then
// the update terms.
template <int VPT>
__device__ __forceinline__ void sample_voxels(const float (&P)[VPT][3],
                                              const bool (&in)[VPT],
                                              const Item& it,
                                              const float* __restrict__ atlas,
                                              const ProjParams& p,
                                              Out (&o)[VPT]) {
  const size_t plane = (size_t)p.atlas_height * p.atlas_width;
  Pixel px[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j)
    px[j] = proj_pixel(P[j][0], P[j][1], P[j][2], it.m[0], it.m[1], it.m[3],
                       it.m[4], p);
  float depth[VPT], labw[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const bool s = in[j] && px[j].inwin;
    depth[j] = s ? __ldg(atlas + px[j].a) : 0.f;
    labw[j] = s ? __ldg(atlas + plane + px[j].a) : 0.f;
  }
  VoxelTerms t[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    t[j] = proj_terms(P[j][0], P[j][1], P[j][2], px[j], depth[j],
                      (int)rintf(labw[j]), p);
    o[j].w = t[j].upd ? t[j].w : 0.f;
    o[j].wsdf = t[j].upd ? t[j].w_sdf : 0.f;
    o[j].cnt = (t[j].upd && t[j].vote) ? 1.f : 0.f;
    o[j].lab = t[j].upd ? t[j].label : 0;
  }
  if (p.with_color) {
    float rgw[VPT], bw[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const bool c = t[j].upd && t[j].gate && t[j].w > 0.f;
      rgw[j] = c ? __ldg(atlas + 2 * plane + t[j].a) : 0.f;
      bw[j] = c ? __ldg(atlas + 3 * plane + t[j].a) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const float wc = (t[j].upd && t[j].gate) ? t[j].w : 0.f;
      float rgb[3];
      proj_rgb(rgw[j], bw[j], rgb);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        o[j].wc[ch] = wc > 0.f ? wc * rgb[ch] : 0.f;
    }
  }
}

// The camera-frame point of the voxel at (x, y, z) + 0.5 in voxel units of
// the grid, as h_z * T_i2 + (h_x * T_i0 + h_y * T_i1) + T_i3.
__device__ __forceinline__ float point(float hz, float T2, float xy,
                                       float T3) {
  return __fmaf_rn(hz, T2, xy) + T3;
}

// 16^3 and 32^3: thread t takes voxels v0 .. v0 + VPT - 1 of the part,
// consecutive along z (one z line holds VPS / VPT threads), and stores
// each plane 16 bytes at a time.
template <int VPS>
__device__ __forceinline__ void sample_part(const SamplePtrs& a,
                                            const ProjParams& p,
                                            const Pose& c, const Item& it,
                                            int t) {
  constexpr int V3 = VPS * VPS * VPS, PART = Shape<VPS>::PART;
  constexpr int VPT = Shape<VPS>::VPT;
  static_assert(V3 % PART == 0 && VPS % VPT == 0 && VPT % 4 == 0,
                "a part is whole z lines of float4 groups");
  const int v0 = it.q * PART + VPT * t;
  const size_t e = (size_t)it.k * V3 + v0;
  Out o[VPT];
  if (it.m[2] == 0) {  // padding row: no update
#pragma unroll
    for (int j = 0; j < VPT; ++j) zero_out(o[j]);
  } else {
    const int lx = v0 / (VPS * VPS), ly = (v0 / VPS) % VPS, lz = v0 % VPS;
    const float hx = (float)(it.m[5] * VPS + lx) + 0.5f;
    const float hy = (float)(it.m[6] * VPS + ly) + 0.5f;
    float xy[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) xy[i] = __fmaf_rn(hx, c.T0[i], hy * c.T1[i]);
    float P[VPT][3];
    bool in[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const float hz = (float)(it.m[7] * VPS + lz + j) + 0.5f;
#pragma unroll
      for (int i = 0; i < 3; ++i) P[j][i] = point(hz, c.T2[i], xy[i], c.T3[i]);
      in[j] = true;
    }
    sample_voxels(P, in, it, a.atlas, p, o);
  }
#pragma unroll
  for (int g = 0; g < VPT; g += 4) {
    const Out* u = o + g;
    *reinterpret_cast<float4*>(a.d_w + e + g) =
        make_float4(u[0].w, u[1].w, u[2].w, u[3].w);
    *reinterpret_cast<float4*>(a.d_wsdf + e + g) =
        make_float4(u[0].wsdf, u[1].wsdf, u[2].wsdf, u[3].wsdf);
    *reinterpret_cast<float4*>(a.d_cnt + e + g) =
        make_float4(u[0].cnt, u[1].cnt, u[2].cnt, u[3].cnt);
    *reinterpret_cast<int4*>(a.d_lab + e + g) =
        make_int4(u[0].lab, u[1].lab, u[2].lab, u[3].lab);
    if (p.with_color) {
      const size_t c0 = (size_t)it.k * 3 * V3 + v0 + g;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        *reinterpret_cast<float4*>(a.d_wc + c0 + (size_t)ch * V3) =
            make_float4(u[0].wc[ch], u[1].wc[ch], u[2].wc[ch], u[3].wc[ch]);
    }
  }
}

// Any vps: lane t takes voxels q * PART + j * 32 + t (neighbouring lanes
// on neighbouring words), coordinates by division, 4-byte stores.
template <>
__device__ __forceinline__ void sample_part<0>(const SamplePtrs& a,
                                               const ProjParams& p,
                                               const Pose& c, const Item& it,
                                               int t) {
  constexpr int TPI = Shape<0>::TPI, VPT = Shape<0>::VPT;
  constexpr int PART = Shape<0>::PART;
  const int vps = p.vps, V3 = p.V3;
  int vox[VPT];
  bool in[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    vox[j] = it.q * PART + j * TPI + t;
    in[j] = vox[j] < V3;
  }
  Out o[VPT];
  if (it.m[2] == 0) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) zero_out(o[j]);
  } else {
    float P[VPT][3];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const float hx = (float)(it.m[5] * vps + vox[j] / (vps * vps)) + 0.5f;
      const float hy = (float)(it.m[6] * vps + (vox[j] / vps) % vps) + 0.5f;
      const float hz = (float)(it.m[7] * vps + vox[j] % vps) + 0.5f;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        P[j][i] = point(hz, c.T2[i], __fmaf_rn(hx, c.T0[i], hy * c.T1[i]),
                        c.T3[i]);
    }
    sample_voxels(P, in, it, a.atlas, p, o);
  }
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (!in[j]) continue;
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

template <int VPS>
__global__ void __launch_bounds__(THREADS)
    proj_sample_kernel(SamplePtrs a, ProjParams p) {
  constexpr int TPI = Shape<VPS>::TPI, PART = Shape<VPS>::PART;
  const int V3 = VPS ? VPS * VPS * VPS : p.V3;
  const int parts = (V3 + PART - 1) / PART;
  const int n_items = p.K * parts;
  __shared__ Item list[THREADS];
  __shared__ int n_list;
  __shared__ Pose c;  // read by every thread: not held in registers
  if (threadIdx.x < 3) {
    const int i = threadIdx.x;
    c.T0[i] = __ldg(a.tcg + 4 * i) * p.voxel_size;
    c.T1[i] = __ldg(a.tcg + 4 * i + 1) * p.voxel_size;
    c.T2[i] = __ldg(a.tcg + 4 * i + 2) * p.voxel_size;
    c.T3[i] = __ldg(a.tcg + 4 * i + 3);
  }
  // Item j of this CTA is blockIdx.x + j * gridDim.x; THREADS of them are
  // listed per round.
  for (int first = blockIdx.x; first < n_items;
       first += THREADS * gridDim.x) {
    if (threadIdx.x == 0) n_list = 0;
    __syncthreads();
    const int item = first + threadIdx.x * gridDim.x;
    if (item < n_items) {
      Item it;
      it.k = item / parts;
      it.q = item - it.k * parts;
      const int g = floor_div(__ldg(a.slots + (it.k & ~7)), 8);
#pragma unroll
      for (int i = 0; i < 8; ++i) it.m[i] = __ldg(a.meta + 8 * it.k + i);
      if (g >= 0 && g < p.trash_group) list[atomicAdd(&n_list, 1)] = it;
    }
    __syncthreads();
    const int n = n_list;
    for (int i = threadIdx.x / TPI; i < n; i += THREADS / TPI)
      sample_part<VPS>(a, p, c, list[i], threadIdx.x % TPI);
    __syncthreads();  // the list is rewritten next round
  }
}

template <int VPS>
int launch(const SamplePtrs& a, const ProjParams& p, cudaStream_t stream) {
  auto kernel = proj_sample_kernel<VPS>;
  // Per instance: the CTAs per SM and the SMs, asked once.
  static int per_sm = 0, sms = 0;
  if (per_sm == 0) {
    cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    int dev = 0;
    cudaGetDevice(&dev);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  constexpr int PART = Shape<VPS>::PART;
  const int V3 = VPS ? VPS * VPS * VPS : p.V3;
  const int n_items = p.K * ((V3 + PART - 1) / PART);
  const int grid = min(n_items, per_sm * sms);
  if (grid <= 0) return 0;
  kernel<<<grid, THREADS, 0, stream>>>(a, p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* x) { return ((size_t)x & 15) == 0; }

}  // namespace

extern "C" int ksd_projective_sample_update(float* d_w, float* d_wsdf,
                                            float* d_cnt, int* d_lab,
                                            float* d_wc, const int* slots,
                                            const int* meta, const float* tcg,
                                            const float* atlas, ProjParams p,
                                            void* stream) {
  const SamplePtrs a{d_w, d_wsdf, d_cnt, d_lab, d_wc, slots, meta, tcg, atlas};
  const cudaStream_t s = (cudaStream_t)stream;
  // The 16-byte stores need 16-byte aligned planes.
  const bool vec = aligned16(d_w) && aligned16(d_wsdf) && aligned16(d_cnt) &&
                   aligned16(d_lab) && (!p.with_color || aligned16(d_wc));
  if (p.vps == 16 && vec) return launch<16>(a, p, s);
  if (p.vps == 32 && vec) return launch<32>(a, p, s);
  return launch<0>(a, p, s);
}
