// K2: per-block mip level and aligned patch origins, 8 lanes per block.
//
// Replaces the Pallas kernel block_meta / _block_meta_kernel of
// kimera_semantics_tpu/ops/pallas_kernels.py:253-362.
//
// Bound on this card: the launch. The kernel reads 13 bytes and writes 32
// bytes per block (K = 512 on the main path: 23 KB in all) and does a few
// hundred flops per block, far below a microsecond of either memory or
// arithmetic. The first design gave each block one thread, which loaded the
// 12 pose words itself, projected the 8 corners one after another (two IEEE
// divisions each), walked the level ladder and the offset loop and wrote
// its row as 8 strided stores: 4 CTAs on 4 of 132 SMs at K = 512, 3.5x the
// launch floor (NVIDIA H100 80GB HBM3, 700 W, PERF.md).
//
// This design gives each block 8 lanes of a warp, one corner each (4
// blocks a warp, 4096 threads in 64 CTAs at K = 512):
//  - every lane loads the 12 pose words straight from the (4, 4) T_C_G on
//    the card (rows 0-2 are its first 12 words; a broadcast within the
//    warp), in the same round trip as its block's coordinates and real flag
//    (a torch bool). Lanes 0-11 loading them once and __shfl_sync sharing
//    them measured no faster;
//  - each lane projects its corner; umin/umax/vmin/vmax come from
//    __shfl_xor_sync min/max over the 8 lanes (exact, independent of
//    order), n_front from __ballot_sync and __popc;
//  - the level ladder is one compare per lane (need > 2^l for level l of
//    the lane) and a popc of their ballot;
//  - lane c writes word c of the block's meta row, so the row is one
//    coalesced 32-byte store.
// Levels come from exact power-of-two compares and origins from floor
// division, so the result is bit-identical to the plain version
// (ops/projective.py block_patch_meta). What is left above the launch
// floor is one load and store round trip and the dependent chain of the
// projection's two divisions, three shuffle levels and the level and origin
// arithmetic.
#include "ksd_common.cuh"

struct MetaParams {
  int K, full_level, width, atlas_height, row_window, atlas_width, col_window;
  float bs, fx, fy, cx, cy, inv_col, inv_row;
};

constexpr int META_THREADS = 64;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(META_THREADS)
    block_meta_kernel(const int* __restrict__ coords,
                      const bool* __restrict__ real,
                      const float* __restrict__ tcg, MetaParams p,
                      int* __restrict__ meta) {
  const int t = blockIdx.x * META_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int c = lane & 7;             // the corner, and the word it writes
  const int base = lane & ~7;         // the block's first lane in the warp
  const int k = t >> 3;
  const bool live = k < p.K;          // every lane takes part in the shuffles
  int b[3] = {0, 0, 0};
  int is_real = 0;
  if (live) {
#pragma unroll
    for (int a = 0; a < 3; ++a) b[a] = coords[3 * k + a];
    if (c == 2) is_real = real[k] ? 1 : 0;
  }
  float T[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) T[j] = tcg[j];

  const float big = 1e9f, zeps = 1e-3f;
  const float x = ((float)b[0] + (float)((c >> 2) & 1)) * p.bs;
  const float y = ((float)b[1] + (float)((c >> 1) & 1)) * p.bs;
  const float z = ((float)b[2] + (float)(c & 1)) * p.bs;
  float cam[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    cam[i] = __fmaf_rn(T[4 * i + 2], z,
                       __fmaf_rn(T[4 * i + 1], y, T[4 * i] * x)) + T[4 * i + 3];
  const float zsafe = fmaxf(cam[2], zeps);
  const float u = p.fx * cam[0] / zsafe + p.cx;
  const float v = p.fy * cam[1] / zsafe + p.cy;
  const bool front = cam[2] > zeps;
  float umin = front ? u : big, umax = front ? u : -big;
  float vmin = front ? v : big, vmax = front ? v : -big;
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    umin = fminf(umin, __shfl_xor_sync(FULL, umin, o));
    umax = fmaxf(umax, __shfl_xor_sync(FULL, umax, o));
    vmin = fminf(vmin, __shfl_xor_sync(FULL, vmin, o));
    vmax = fmaxf(vmax, __shfl_xor_sync(FULL, vmax, o));
  }
  const int n_front = __popc((__ballot_sync(FULL, front) >> base) & 0xffu);

  const float need = fmaxf((umax - umin) * p.inv_col, (vmax - vmin) * p.inv_row);
  const int FL = p.full_level;
  int lvl = 0;
  for (int l0 = 0; l0 < FL; l0 += 8) {
    const int l = l0 + c;
    const bool up = l < FL && need > (float)(1 << l);
    lvl += __popc((__ballot_sync(FULL, up) >> base) & 0xffu);
  }
  const bool bbox_ok = n_front == 8 && need <= (float)(1 << FL);
  if (!bbox_ok) lvl = FL;
  int off = 0;
  for (int l = 0; l < lvl; ++l) off += (((p.width >> l) + 127) / 128) * 128;
  const int vmin_l = bbox_ok ? ((int)floorf(vmin) >> lvl) - 1 : 0;
  const int umin_l = bbox_ok ? ((int)floorf(umin) >> lvl) - 1 : 0;
  const int v0 = clampi(floor_div(vmin_l, 8) * 8, 0, p.atlas_height - p.row_window);
  const int u0a = clampi(floor_div(off + umin_l, 128) * 128, 0,
                         p.atlas_width - p.col_window);
  // Row [v0, u0_atlas, real, lvl, u0_level, bx, by, bz]; the real flag is
  // lane 2's own load.
  const int word = c == 0 ? v0 : c == 1 ? u0a : c == 2 ? is_real
                 : c == 3 ? lvl : c == 4 ? u0a - off : c == 5 ? b[0]
                 : c == 6 ? b[1] : b[2];
  if (live) meta[t] = word;
}

extern "C" int ksd_block_meta(const int* coords, const bool* real,
                              const float* tcg, MetaParams p, int* meta,
                              void* stream) {
  const int blocks = (8 * p.K + META_THREADS - 1) / META_THREADS;
  block_meta_kernel<<<blocks, META_THREADS, 0, (cudaStream_t)stream>>>(
      coords, real, tcg, p, meta);
  return (int)cudaGetLastError();
}
