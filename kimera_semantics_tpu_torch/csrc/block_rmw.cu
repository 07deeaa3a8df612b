// K5: block read-modify-write add of 8-row delta tiles into the grid.
//
// Replaces the Pallas kernel block_rmw_add / _rmw_kernel of
// kimera_semantics_tpu/ops/pallas_kernels.py:888-1032. There, one grid step
// fetches a whole (8, V3) channel tile group, adds the aligned delta tile
// and writes every semantic plane back; the votes are expanded against a
// label iota. Here nothing is a product, so no tensor core is involved: the
// vote of a voxel goes straight to its label's plane.
//
// Bound on this card: bytes. Every delta word of a live tile is read once
// (3 + P planes, colour too where d_wc is given); a grid word is read and
// written only where a delta touches it. The first design (one voxel per
// thread, 4-byte loads, the vote form and rank count read at run time, a
// CTA for every tile) kept only a few loads in flight per thread and ran
// at 4.7x its byte bound (62.9 us packed at the fast path's shape, NVIDIA
// H100 80GB HBM3, 700 W, PERF.md), latency-bound with its inputs warm in L2.
//
// This design:
//  - the vote form, colour and the rank count are template parameters
//    (instances for P 4 and 8 and for dense L 21, and a generic one), so the
//    rank loop unrolls;
//  - a work item is RPI = 4 rows of one live tile over one chunk of C = 512
//    voxels (256 dense); a persistent grid of CTAs (as many as fit on the
//    card) strides over the items, so a trash tile costs one slot read and
//    no CTA. Tiles may come in any order and are skipped, never ended on;
//  - one thread issues cp.async.bulk copies (the TMA's 1-D form) of a row's
//    delta planes for the chunk into a ring of STAGES = 2 buffers in dynamic
//    shared memory, with completion on an mbarrier; the CTA works on one
//    row while the next is in flight;
//  - each thread owns 4 consecutive voxels: 16-byte reads of its deltas from
//    shared memory, and a 16-byte read-modify-write of a grid word (wsum,
//    wsdf, sem_count, a dense label plane, a colour plane) when any of its
//    four deltas is nonzero (adding +0.0 to the other three is what the
//    plain version does for every word). Votes of the onehot and packed
//    forms go to each voxel's own label plane, one lane at a time; ranks of
//    one voxel that name the same label add in rank order, as in the plain
//    version. The grid words' loads go out with the first vote batch's; the
//    later batches (RB = 2 ranks, DB = 4 dense planes) only where a word of
//    theirs is nonzero, which keeps the registers few (90 for packed P 8)
//    and the CTAs many.
// At the fast path's shape (NVIDIA H100 80GB HBM3, 700 W) the other shapes
// tried (1, 2 or 8 rows an item, 3-6 stages, chunks of 256 or 1024, 1 or 4
// ranks a batch) were bit-exact and none faster by more than the spread
// between runs. chip_smoke.py measured it (packed) at 20.15-20.52 us with
// its inputs warm and 28.10-28.27 us with the L2 flushed before each
// launch, against the first design's 61.72-61.74 us warm in the same run
// (NVIDIA H100 80GB HBM3, 700 W): 1.5x and 2.1x its byte bound. The
// dependent grid read-modify-write of each row stays exposed between the
// ring's refills. PERF.md has the other forms.
//
// V3 % 8 != 0 (an odd vps: the unfused projective route at vps 5, or vps 21
// past the fused kernel's V3 limit) and tensors off a 16-byte boundary take
// a generic instance (block_rmw_kernel_generic, below) with the same rules.
#include <stdint.h>

#include "ksd_common.cuh"

struct RmwParams {
  int K, V3, L, P, rows_total, trash_group, sem_mode;
  float lk;
};

struct RmwPtrs {
  float *wsum, *wsdf, *sem_count, *sem_delta, *wcolor;
  const int* slots;
  const float *d_w, *d_wsdf, *d_cnt;
  const int* d_lab;
  const float *d_sem, *d_wc;
};

constexpr int STAGES = 2;  // row buffers in the shared-memory ring
constexpr int C_SPARSE = 512;  // chunk of the onehot and packed forms
constexpr int C_DENSE = 256;   // and of the dense form (24 planes a row)
constexpr int RPI = 4;         // rows of one tile in a work item
constexpr int NG = 8 / RPI;    // row groups per tile
constexpr int RB = 2;          // packed ranks per vote batch
constexpr int DB = 4;          // dense label planes per vote batch
constexpr int BAR_BYTES = 128;  // the ring's mbarriers, ahead of the buffers

enum { ONEHOT = 0, DENSE = 1, PACKED = 2 };

__device__ __forceinline__ bool any_nz(float4 d) {
  return d.x != 0.f || d.y != 0.f || d.z != 0.f || d.w != 0.f;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float lane(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ int lane(int4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The vote planes a row carries in the ring: d_lab (onehot), L dense planes
// or P rank planes.
template <int MODE, int NR>
__device__ __host__ __forceinline__ int vote_planes(const RmwParams& p) {
  return MODE == ONEHOT ? 1 : (NR ? NR : p.P);
}

// One row of one chunk for this thread's 4 voxels: `st` holds the row's
// planes (C floats each), `q` is the thread's first voxel in the chunk and
// `dst` its first grid word. The loads of the grid words and of the first
// batch of vote words are issued together; the other vote batches (RB
// packed ranks or DB dense planes each) follow only where one of their
// words is nonzero.
template <int MODE, int NR, bool COLOR, int C>
__device__ __forceinline__ void rmw_row(const RmwPtrs& a, const RmwParams& p,
                                        const float* st, int q, size_t dst,
                                        int nr) {
  constexpr int B = MODE == DENSE ? DB : RB;
  const size_t plane = (size_t)p.rows_total * p.V3;
  const float lk = p.lk;
  float* sd = a.sem_delta + dst;  // this thread's words of label plane 0
  auto ld4 = [&](int plane_row) {
    return *reinterpret_cast<const float4*>(st + plane_row * C + q);
  };
  const float4 dw = ld4(0), ds = ld4(1), dc = ld4(2);
  const bool hw = any_nz(dw), hs = any_nz(ds), hc = any_nz(dc);
  float4 ow, os, oc, dcol[3], ocol[3];
  bool hcol[3];
  if (hw) ow = *reinterpret_cast<const float4*>(a.wsum + dst);
  if (hs) os = *reinterpret_cast<const float4*>(a.wsdf + dst);
  if (hc) oc = *reinterpret_cast<const float4*>(a.sem_count + dst);
  if (COLOR) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      dcol[ch] = ld4(3 + nr + ch);
      hcol[ch] = any_nz(dcol[ch]);
      if (hcol[ch])
        ocol[ch] = *reinterpret_cast<const float4*>(a.wcolor + ch * plane +
                                                    dst);
    }
  }
  auto store_grid = [&]() {
    if (hw) *reinterpret_cast<float4*>(a.wsum + dst) = add4(ow, dw);
    if (hs) *reinterpret_cast<float4*>(a.wsdf + dst) = add4(os, ds);
    if (hc) *reinterpret_cast<float4*>(a.sem_count + dst) = add4(oc, dc);
    if (COLOR) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        if (hcol[ch])
          *reinterpret_cast<float4*>(a.wcolor + ch * plane + dst) =
              add4(ocol[ch], dcol[ch]);
    }
  };

  if (MODE == ONEHOT) {
    const int4 lab = *reinterpret_cast<const int4*>(
        reinterpret_cast<const int*>(st) + 3 * C + q);
    float old[4];
    bool act[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = lane(lab, i);
      act[i] = lane(dc, i) != 0.f && l >= 0 && l < p.L;
      if (act[i]) old[i] = sd[l * plane + i];
    }
    store_grid();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (act[i]) sd[lane(lab, i) * plane + i] = old[i] + lane(dc, i) * lk;
  } else if (MODE == DENSE && NR > 0) {
    // Dense label planes are distinct words: a batch's loads, then its
    // fused multiply-adds and stores.
#pragma unroll
    for (int b0 = 0; b0 < NR; b0 += B) {
      float4 old[B];
      bool has[B];
#pragma unroll
      for (int j = 0; j < B && b0 + j < NR; ++j) {
        has[j] = any_nz(ld4(3 + b0 + j));
        if (has[j])
          old[j] = *reinterpret_cast<const float4*>(sd + (b0 + j) * plane);
      }
      if (b0 == 0) store_grid();
#pragma unroll
      for (int j = 0; j < B && b0 + j < NR; ++j) {
        if (!has[j]) continue;
        const float4 d = ld4(3 + b0 + j);
        *reinterpret_cast<float4*>(sd + (b0 + j) * plane) =
            make_float4(__fmaf_rn(d.x, lk, old[j].x),
                        __fmaf_rn(d.y, lk, old[j].y),
                        __fmaf_rn(d.z, lk, old[j].z),
                        __fmaf_rn(d.w, lk, old[j].w));
      }
    }
  } else if (MODE == DENSE) {
    store_grid();
    for (int l = 0; l < nr; ++l) {
      const float4 d = ld4(3 + l);
      if (any_nz(d)) {
        float4* s = reinterpret_cast<float4*>(sd + l * plane);
        const float4 o = *s;
        *s = make_float4(__fmaf_rn(d.x, lk, o.x), __fmaf_rn(d.y, lk, o.y),
                         __fmaf_rn(d.z, lk, o.z), __fmaf_rn(d.w, lk, o.w));
      }
    }
  } else if (NR > 0) {
    // Packed, rank count fixed, B ranks a batch: decode, load every voted
    // word, then add rank by rank. Ranks of one voxel that name the same
    // label read the same word: within a batch each takes the sum of the
    // rank before it, and a later batch reads after the earlier one's
    // stores. A rank whose four words are all 0 (most deeper ranks) is
    // skipped.
#pragma unroll
    for (int b0 = 0; b0 < NR; b0 += B) {
      float cr[B][4], nw[B][4];
      int lb[B][4];
      bool act[B][4];
#pragma unroll
      for (int j = 0; j < B; ++j) {
        const float4 pv4 = b0 + j < NR ? ld4(3 + b0 + j)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
        const bool any = any_nz(pv4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          act[j][i] = false;
          if (!any) continue;
          const float pv = lane(pv4, i);
          cr[j][i] = floorf(pv * 0.03125f);
          lb[j][i] = (int)(pv - 32.f * cr[j][i]);
          act[j][i] = cr[j][i] != 0.f && lb[j][i] >= 0 && lb[j][i] < p.L;
          if (act[j][i]) nw[j][i] = sd[lb[j][i] * plane + i];
        }
      }
      if (b0 == 0) store_grid();
#pragma unroll
      for (int j = 0; j < B; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!act[j][i]) continue;
          float base = nw[j][i];
#pragma unroll
          for (int j2 = 0; j2 < j; ++j2)
            if (act[j2][i] && lb[j2][i] == lb[j][i]) base = nw[j2][i];
          nw[j][i] = base + cr[j][i] * lk;
          sd[lb[j][i] * plane + i] = nw[j][i];
        }
      }
    }
  } else {
    // Packed, any rank count: rank by rank, one lane at a time.
    store_grid();
    for (int r = 0; r < nr; ++r) {
      const float4 pv4 = ld4(3 + r);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = lane(pv4, i);
        const float c = floorf(pv * 0.03125f);
        const int l = (int)(pv - 32.f * c);
        if (c != 0.f && l >= 0 && l < p.L) {
          float* s = sd + l * plane + i;
          *s = *s + c * lk;
        }
      }
    }
  }
}

template <int MODE, int NR, bool COLOR, int C>
__global__ void __launch_bounds__(C / 4)
    block_rmw_kernel(RmwPtrs a, RmwParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nr = vote_planes<MODE, NR>(p);
  const int np = 3 + nr + (COLOR ? 3 : 0);
  const int V3 = p.V3;
  const int nch = (V3 + C - 1) / C;
  // Item i: chunk i % nch of row group (i / nch) % NG of tile i / nch / NG.
  const int n_items = (p.K / 8) * NG * nch;
  const int G = gridDim.x;
  float* ring = reinterpret_cast<float*>(smem + BAR_BYTES);
  const uint32_t bar0 = smem_u32(smem);

  // The tile group an item adds into, or -1 for a trash tile (or a slot
  // outside the live rows).
  auto group_of = [&](int item) {
    const int g = floor_div(__ldg(a.slots + 8 * (item / nch / NG)), 8);
    return (g >= 0 && g < p.trash_group) ? g : -1;
  };
  auto next_live = [&](int item) {
    while (item < n_items && group_of(item) < 0) item += G;
    return item;
  };
  // Thread 0's copies of row r of an item into the ring slot of `step`.
  auto issue = [&](int step, int item, int r) {
    const int stage = step % STAGES;
    const int tg = item / nch;
    const int v0 = (item - tg * nch) * C;
    const uint32_t bytes = 4u * (uint32_t)min(C, V3 - v0);
    const uint32_t bar = bar0 + 8 * stage;
    const uint32_t dst = smem_u32(ring + (size_t)stage * np * C);
    const size_t k = (size_t)tg * RPI + r;  // the delta row
    const size_t off = k * V3 + v0;
    mbar_expect_tx(bar, bytes * np);
    bulk_load(dst, a.d_w + off, bytes, bar);
    bulk_load(dst + 4 * C, a.d_wsdf + off, bytes, bar);
    bulk_load(dst + 8 * C, a.d_cnt + off, bytes, bar);
    if (MODE == ONEHOT) {
      bulk_load(dst + 12 * C, a.d_lab + off, bytes, bar);
    } else {
      for (int j = 0; j < nr; ++j)
        bulk_load(dst + 4 * (3 + j) * C, a.d_sem + (size_t)j * p.K * V3 + off,
                  bytes, bar);
    }
    if (COLOR) {
      for (int ch = 0; ch < 3; ++ch)
        bulk_load(dst + 4 * (3 + nr + ch) * C,
                  a.d_wc + (k * 3 + ch) * V3 + v0, bytes, bar);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Thread 0 runs STAGES rows ahead of the CTA along the same sequence of
  // (live item, row) steps.
  int p_item = 0, p_row = 0, p_step = 0;
  auto advance = [&]() {
    if (++p_row == RPI) {
      p_row = 0;
      p_item = next_live(p_item + G);
    }
  };
  if (tid == 0) {
    p_item = next_live(blockIdx.x);
    for (; p_step < STAGES && p_item < n_items; ++p_step) {
      issue(p_step, p_item, p_row);
      advance();
    }
  }

  int step = 0;
  for (int item = next_live(blockIdx.x); item < n_items;
       item = next_live(item + G)) {
    const int tg = item / nch;
    const int v = (item - tg * nch) * C + 4 * tid;
    // The item's first grid row: its tile group's row of row group tg % NG.
    const size_t row0 = (size_t)group_of(item) * 8 + (tg % NG) * RPI;
    for (int r = 0; r < RPI; ++r, ++step) {
      const int stage = step % STAGES;
      mbar_wait(bar0 + 8 * stage, (step / STAGES) & 1);
      if (v < V3)
        rmw_row<MODE, NR, COLOR, C>(a, p, ring + (size_t)stage * np * C,
                                    4 * tid, (row0 + r) * V3 + v, nr);
      __syncthreads();  // the slot is read: thread 0 may refill it
      if (tid == 0 && p_item < n_items) {
        issue(p_step++, p_item, p_row);
        advance();
      }
    }
  }
}

template <int MODE, int NR, bool COLOR, int C>
static int launch(const RmwPtrs& a, const RmwParams& p, cudaStream_t stream) {
  auto kernel = block_rmw_kernel<MODE, NR, COLOR, C>;
  const int np = 3 + vote_planes<MODE, NR>(p) + (COLOR ? 3 : 0);
  const int smem = BAR_BYTES + STAGES * np * C * 4;
  // Per instance: the dynamic shared memory set and the CTAs per SM at it.
  static int set_smem = -1, per_sm = 0, sms = 0;
  if (smem != set_smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C / 4,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0;
    cudaGetDevice(&dev);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    set_smem = smem;
  }
  const int n_items = (p.K / 8) * NG * ((p.V3 + C - 1) / C);
  const int grid = min(n_items, per_sm * sms);
  if (grid <= 0) return 0;
  kernel<<<grid, C / 4, smem, stream>>>(a, p);
  return (int)cudaGetLastError();
}

// The generic instance, for any V3 and any alignment (V3 % 8 != 0, for an
// odd vps, or a tensor that does not start on a 16-byte boundary): no
// bulk-copy ring and 4-byte grid words, one voxel of one row per thread. A
// tile's 8 delta rows and its group's 8 grid rows are each one run of 8 V3
// words, so a work item is a chunk of G_THREADS words of one live tile, and
// a warp reads and writes neighbouring words. A thread issues all its delta
// loads, then the loads of the grid words a nonzero delta touches, then the
// stores. It keeps the fast instances' rules: a persistent grid of CTAs
// striding over the items, trash tiles skipped where they are found, a
// read-modify-write only where a delta is nonzero, and the packed votes of
// a voxel added rank by rank.
constexpr int G_THREADS = 256;

template <int MODE, bool COLOR>
__global__ void __launch_bounds__(G_THREADS)
    block_rmw_kernel_generic(RmwPtrs a, RmwParams p) {
  const int V3 = p.V3, n = 8 * V3;  // words of a tile
  const int nch = (n + G_THREADS - 1) / G_THREADS;
  const int n_items = (p.K / 8) * nch;
  const size_t plane = (size_t)p.rows_total * V3;  // grid channel plane
  const size_t dplane = (size_t)p.K * V3;          // d_sem plane
  const float lk = p.lk;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int tile = item / nch;
    const int g = floor_div(__ldg(a.slots + 8 * tile), 8);
    const int e = (item - tile * nch) * G_THREADS + threadIdx.x;
    if (g < 0 || g >= p.trash_group || e >= n) continue;
    const size_t src = (size_t)tile * n + e;  // the delta word
    const size_t dst = (size_t)g * n + e;     // its grid word
    const float dw = a.d_w[src], ds = a.d_wsdf[src], dc = a.d_cnt[src];
    int lab = 0;
    if (MODE == ONEHOT) lab = a.d_lab[src];
    float dcol[3];
    size_t col = 0;
    if (COLOR) {
      const int r = e / V3;  // the row in the tile: d_wc is (K, 3, V3)
      col = ((size_t)tile * 8 + r) * 3 * V3 + (e - r * V3);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) dcol[ch] = a.d_wc[col + ch * V3];
    }
    float* sd = a.sem_delta + dst;  // this word's place in label plane 0
    const bool vote = MODE == ONEHOT && dc != 0.f && lab >= 0 && lab < p.L;
    float ow = 0.f, os = 0.f, oc = 0.f, ov = 0.f, ocol[3];
    if (dw != 0.f) ow = a.wsum[dst];
    if (ds != 0.f) os = a.wsdf[dst];
    if (dc != 0.f) oc = a.sem_count[dst];
    if (vote) ov = sd[lab * plane];
    if (COLOR) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        if (dcol[ch] != 0.f) ocol[ch] = a.wcolor[ch * plane + dst];
    }
    if (dw != 0.f) a.wsum[dst] = ow + dw;
    if (ds != 0.f) a.wsdf[dst] = os + ds;
    if (dc != 0.f) a.sem_count[dst] = oc + dc;
    if (vote) sd[lab * plane] = ov + dc * lk;
    if (COLOR) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        if (dcol[ch] != 0.f) a.wcolor[ch * plane + dst] = ocol[ch] + dcol[ch];
    }
    if (MODE == DENSE) {
      for (int l = 0; l < p.P; ++l) {
        const float d = a.d_sem[l * dplane + src];
        if (d != 0.f) sd[l * plane] = __fmaf_rn(d, lk, sd[l * plane]);
      }
    } else if (MODE == PACKED) {
      for (int j = 0; j < p.P; ++j) {
        const float pv = a.d_sem[j * dplane + src];
        const float c = floorf(pv * 0.03125f);
        const int l = (int)(pv - 32.f * c);
        if (c != 0.f && l >= 0 && l < p.L)
          sd[l * plane] = sd[l * plane] + c * lk;
      }
    }
  }
}

template <int MODE, bool COLOR>
static int launch_generic(const RmwPtrs& a, const RmwParams& p,
                          cudaStream_t stream) {
  auto kernel = block_rmw_kernel_generic<MODE, COLOR>;
  static int per_sm = 0, sms = 0;  // per instance, from the occupancy API
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, G_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    int dev = 0;
    cudaGetDevice(&dev);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const int n_items = (p.K / 8) * ((8 * p.V3 + G_THREADS - 1) / G_THREADS);
  const int grid = min(n_items, per_sm * sms);
  if (grid <= 0) return 0;
  kernel<<<grid, G_THREADS, 0, stream>>>(a, p);
  return (int)cudaGetLastError();
}

template <bool COLOR>
static int dispatch_generic(const RmwPtrs& a, const RmwParams& p,
                            cudaStream_t s) {
  if (p.sem_mode == ONEHOT) return launch_generic<ONEHOT, COLOR>(a, p, s);
  if (p.sem_mode == DENSE) return launch_generic<DENSE, COLOR>(a, p, s);
  return launch_generic<PACKED, COLOR>(a, p, s);
}

template <bool COLOR>
static int dispatch(const RmwPtrs& a, const RmwParams& p, cudaStream_t s) {
  if (p.sem_mode == ONEHOT) return launch<ONEHOT, 1, COLOR, C_SPARSE>(a, p, s);
  if (p.sem_mode == DENSE)
    return p.P == 21 ? launch<DENSE, 21, COLOR, C_DENSE>(a, p, s)
                     : launch<DENSE, 0, COLOR, C_DENSE>(a, p, s);
  if (p.P == 8) return launch<PACKED, 8, COLOR, C_SPARSE>(a, p, s);
  if (p.P == 4) return launch<PACKED, 4, COLOR, C_SPARSE>(a, p, s);
  return launch<PACKED, 0, COLOR, C_DENSE>(a, p, s);
}

static bool unaligned(const void* x) { return ((uintptr_t)x & 15) != 0; }

// The fast instances need V3 % 8 == 0 and every pointer 16-byte aligned
// (rows then start on 32-byte boundaries for the bulk copies and the
// 16-byte grid words); anything else takes the generic instance.
extern "C" int ksd_block_rmw_add(float* wsum, float* wsdf, float* sem_count,
                                 float* sem_delta, float* wcolor,
                                 const int* slots, const float* d_w,
                                 const float* d_wsdf, const float* d_cnt,
                                 const int* d_lab, const float* d_sem,
                                 const float* d_wc, RmwParams p,
                                 void* stream) {
  const RmwPtrs a{wsum, wsdf, sem_count, sem_delta, wcolor, slots,
                  d_w,  d_wsdf, d_cnt,   d_lab,     d_sem,  d_wc};
  const cudaStream_t s = (cudaStream_t)stream;
  const void* ptrs[] = {wsum, wsdf, sem_count, sem_delta, wcolor, slots,
                        d_w,  d_wsdf, d_cnt,   d_lab,     d_sem,  d_wc};
  bool generic = p.V3 % 8 != 0;
  for (const void* x : ptrs) generic = generic || unaligned(x);
  if (generic)
    return d_wc != nullptr ? dispatch_generic<true>(a, p, s)
                           : dispatch_generic<false>(a, p, s);
  return d_wc != nullptr ? dispatch<true>(a, p, s) : dispatch<false>(a, p, s);
}
