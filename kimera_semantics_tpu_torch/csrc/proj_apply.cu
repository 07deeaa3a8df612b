// K3: fused projective sample + apply, in place on the grid channels.
//
// Replaces the Pallas kernel projective_apply_fused / _proj_fused_kernel +
// _proj_tile of kimera_semantics_tpu/ops/pallas_kernels.py.
//
// One CUDA block per (8-row tile group, chunk of the group's 8 x V3 voxels),
// one thread per voxel. Tile groups of the frame list are distinct by
// construction (grid/hash.py insert_frame_list), so every grid element has
// one writer and no atomics are needed; a trash group returns at once, as
// do the padding rows of a group (their deltas are zero).
//
// Bound on this card: bytes. Per updated voxel the kernel reads and writes
// wsum and wsdf, and per informative voxel sem_count and one sem_delta
// plane; the per-voxel arithmetic (a projection, a sqrt, two divisions) is
// small beside it. The TPU samples the atlas window through a bf16 hi/lo
// one-hot contraction on its matrix unit; here the sample is one direct,
// exact load at (v0 + row, u0_atlas + col), with the same window test (a
// sample outside the 128 x 256 window reads 0, an invalid depth), and the
// window stays hot in L2. Channels are only touched where the update is
// non-zero, and only the label's own sem_delta plane, so untouched voxels
// cost no grid traffic. Rounding mirrors the plain version
// (ops/projective.py sample_terms) operation for operation.
#include "ksd_common.cuh"

#define KSD_MAX_DYN 8

struct ProjParams {
  int K, V3, vps, L, rows_total, trash_group;
  int width, height, row_window, col_window, atlas_height, atlas_width;
  int allow_clear, carving, region_carve, use_const_weight, use_dropoff;
  int near_surface_only, with_color, n_dyn;
  int dyn[KSD_MAX_DYN];
  float voxel_size, fx, fy, cx, cy, trunc, min_ray, max_ray, dropoff_eps,
      dropoff_scale, half_vs, lk_delta;
};

__global__ void proj_apply_kernel(float* __restrict__ wsum,
                                  float* __restrict__ wsdf,
                                  float* __restrict__ sem_count,
                                  float* __restrict__ sem_delta,
                                  float* __restrict__ wcolor,
                                  const int* __restrict__ slots,
                                  const int* __restrict__ meta,
                                  const float* __restrict__ tcg,
                                  const float* __restrict__ atlas,
                                  ProjParams p) {
  const int group = blockIdx.x;
  if (slots[8 * group] / 8 == p.trash_group) return;
  const int flat = blockIdx.y * blockDim.x + threadIdx.x;
  if (flat >= 8 * p.V3) return;
  const int k = 8 * group + flat / p.V3;
  const int vox = flat % p.V3;
  const int* m = meta + 8 * k;
  if (m[2] == 0) return;  // padding row: all deltas are zero
  const int v0 = m[0], u0a = m[1], lvl = m[3], u0l = m[4];
  const int vps = p.vps;
  const int lx = vox / (vps * vps), ly = (vox / vps) % vps, lz = vox % vps;
  // Voxel center in voxel units, projected as h_j * (T_ij * voxel_size):
  // the reassociated, fused form of ops/projective.py centers_to_camera.
  const float hx = (float)(m[5] * vps + lx) + 0.5f;
  const float hy = (float)(m[6] * vps + ly) + 0.5f;
  const float hz = (float)(m[7] * vps + lz) + 0.5f;
  float P[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* T = tcg + 4 * i;
    P[i] = __fmaf_rn(hz, T[2] * p.voxel_size,
                     __fmaf_rn(hx, T[0] * p.voxel_size, hy * (T[1] * p.voxel_size))) +
           T[3];
  }
  const float pX = P[0], pY = P[1], pZ = P[2];
  const bool zok = pZ > 1e-3f;
  const float zsafe = fmaxf(pZ, 1e-3f);
  const float u = p.fx * pX / zsafe + p.cx;
  const float v = p.fy * pY / zsafe + p.cy;
  const int ui = (int)floorf(u + 0.5f);
  const int vi = (int)floorf(v + 0.5f);
  const bool in_img = zok && ui >= 0 && ui < p.width && vi >= 0 && vi < p.height;
  const int ul = clampi(ui, 0, p.width - 1) >> lvl;
  const int vl = clampi(vi, 0, p.height - 1) >> lvl;
  const bool lvl_ok = ul < (p.width >> lvl) && vl < (p.height >> lvl);
  const int row = vl - v0, col = ul - u0l;
  const bool inwin = row >= 0 && row < p.row_window && col >= 0 && col < p.col_window;
  const size_t plane = (size_t)p.atlas_height * p.atlas_width;
  const size_t a = inwin ? (size_t)(v0 + row) * p.atlas_width + (u0a + col) : 0;
  const float depth = inwin ? atlas[a] : 0.f;
  const int label = (int)rintf(inwin ? atlas[plane + a] : 0.f);

  // update_terms_from_sample (ops/projective.py).
  const bool depth_ok = depth > 0.f && depth < 1.0e6f * 0.5f;
  const float t_v = sqrtf(__fmaf_rn(pZ, pZ, __fmaf_rn(pX, pX, pY * pY)));
  const float ray_norm = t_v * depth / zsafe;
  const float sdf = ray_norm - t_v;
  const bool finite = depth_ok && in_img && lvl_ok;
  const bool too_close = ray_norm < p.min_ray;
  const bool beyond = ray_norm > p.max_ray;
  const bool clearing = beyond && p.allow_clear;
  bool pvalid = finite && !too_close && (!beyond || p.allow_clear);
  for (int i = 0; i < p.n_dyn; ++i) pvalid = pvalid && label != p.dyn[i];
  const float trunc = p.trunc;
  const bool normal_band = p.carving ? sdf >= -trunc : fabsf(sdf) <= trunc;
  const float clear_len = clampf(ray_norm - trunc, 0.f, p.max_ray);
  const bool clear_band =
      p.carving ? t_v <= clear_len : fabsf(t_v - clear_len) <= p.half_vs;
  bool upd = pvalid && ((clearing && clear_band) || (!clearing && normal_band));
  if (p.region_carve) upd = upd && (clearing || sdf > trunc);
  if (!upd) return;

  float w_point = 1.f;
  if (!p.use_const_weight)
    w_point = depth > 1e-6f ? 1.f / fmaxf(depth * depth, 1e-12f) : 0.f;
  float w = w_point;
  if (p.use_dropoff) {
    const float scale = (trunc + sdf) * p.dropoff_scale;
    if (sdf < -p.dropoff_eps) w = fmaxf(w_point * scale, 0.f);
  }
  const float w_sdf = w * clampf(sdf, -trunc, trunc);
  const bool gate = fabsf(sdf) < trunc;

  const size_t rows = (size_t)p.rows_total;
  const size_t e = (size_t)slots[k] * p.V3 + vox;
  wsum[e] += w;
  wsdf[e] += w_sdf;
  const bool sem_upd = p.near_surface_only ? gate : true;
  if (sem_upd && label != 0) {
    sem_count[e] += 1.f;
    if (label >= 0 && label < p.L) sem_delta[(size_t)label * rows * p.V3 + e] += p.lk_delta;
  }
  if (p.with_color && gate) {
    const float rg = rintf(atlas[2 * plane + a]);
    const float r = floorf(rg / 256.f);
    const float g = rg - r * 256.f;
    const float bl = rintf(atlas[3 * plane + a]);
    const size_t cs = rows * p.V3;
    wcolor[e] += w * r;
    wcolor[cs + e] += w * g;
    wcolor[2 * cs + e] += w * bl;
  }
}

extern "C" int ksd_proj_apply_fused(float* wsum, float* wsdf, float* sem_count,
                                    float* sem_delta, float* wcolor,
                                    const int* slots, const int* meta,
                                    const float* tcg, const float* atlas,
                                    ProjParams p, void* stream) {
  const int threads = 256;
  dim3 grid(p.K / 8, (8 * p.V3 + threads - 1) / threads);
  proj_apply_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      wsum, wsdf, sem_count, sem_delta, wcolor, slots, meta, tcg, atlas, p);
  return (int)cudaGetLastError();
}
