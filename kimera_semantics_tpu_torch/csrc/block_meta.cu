// K2: per-block mip level and aligned patch origins, one thread per block.
//
// Replaces the Pallas kernel block_meta / _block_meta_kernel of
// kimera_semantics_tpu/ops/pallas_kernels.py.
//
// Bound on this card: launch. The kernel reads 16 bytes and writes 32 bytes
// per block (K = 512 on the main path: 24 KB in all) and does a few hundred
// flops per block, far below a microsecond of either memory or arithmetic.
// One thread projects the block's 8 corners in registers and writes its
// 8-int meta row; nothing is staged. Levels come from a ladder of exact
// power-of-two compares and origins from floor division, so the result is
// bit-identical to the plain version (ops/projective.py block_patch_meta).
#include "ksd_common.cuh"

struct MetaParams {
  int K, full_level, width, atlas_height, row_window, atlas_width, col_window;
  float bs, fx, fy, cx, cy, inv_col, inv_row;
};

__global__ void block_meta_kernel(const int* __restrict__ coords,
                                  const int* __restrict__ real,
                                  const float* __restrict__ tcg, MetaParams p,
                                  int* __restrict__ meta) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.K) return;
  float T[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) T[j] = tcg[j];
  const int b[3] = {coords[3 * k], coords[3 * k + 1], coords[3 * k + 2]};
  const float big = 1e9f, zeps = 1e-3f;
  float umin = big, vmin = big, umax = -big, vmax = -big;
  int n_front = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
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
    umin = fminf(umin, front ? u : big);
    umax = fmaxf(umax, front ? u : -big);
    vmin = fminf(vmin, front ? v : big);
    vmax = fmaxf(vmax, front ? v : -big);
    n_front += front ? 1 : 0;
  }
  const float need = fmaxf((umax - umin) * p.inv_col, (vmax - vmin) * p.inv_row);
  const int FL = p.full_level;
  int lvl = 0;
  for (int l = 0; l < FL; ++l) lvl += need > (float)(1 << l) ? 1 : 0;
  const bool bbox_ok = n_front == 8 && need <= (float)(1 << FL);
  if (!bbox_ok) lvl = FL;
  int off = 0;
  for (int l = 0; l < lvl; ++l) off += (((p.width >> l) + 127) / 128) * 128;
  const int vmin_l = bbox_ok ? ((int)floorf(vmin) >> lvl) - 1 : 0;
  const int umin_l = bbox_ok ? ((int)floorf(umin) >> lvl) - 1 : 0;
  const int v0 = clampi(floor_div(vmin_l, 8) * 8, 0, p.atlas_height - p.row_window);
  const int u0a = clampi(floor_div(off + umin_l, 128) * 128, 0,
                         p.atlas_width - p.col_window);
  int* m = meta + 8 * k;
  m[0] = v0;
  m[1] = u0a;
  m[2] = real[k];
  m[3] = lvl;
  m[4] = u0a - off;
  m[5] = b[0];
  m[6] = b[1];
  m[7] = b[2];
}

extern "C" int ksd_block_meta(const int* coords, const int* real,
                              const float* tcg, MetaParams p, int* meta,
                              void* stream) {
  const int threads = 128;
  const int blocks = (p.K + threads - 1) / threads;
  block_meta_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      coords, real, tcg, p, meta);
  return (int)cudaGetLastError();
}
