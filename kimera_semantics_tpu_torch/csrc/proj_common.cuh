// The per-voxel sample and update terms of the projective apply, shared by
// K3 (proj_apply.cu, added into the grid in place) and K4 (proj_sample.cu,
// written out as delta planes), so both run the same arithmetic: the
// projection of a camera-frame point to its atlas pixel (proj_pixel) and the
// update terms of a sample (proj_terms). Each kernel computes its voxel
// coordinates and camera-frame points itself and calls the two pieces for
// several voxels at once.
//
// The TPU kernels (_proj_tile of kimera_semantics_tpu/ops/pallas_kernels.py)
// sample the atlas window through a bf16 hi/lo one-hot contraction on the
// matrix unit; here the sample is one direct, exact load at
// (v0 + row, u0_atlas + col), with the same window test (a sample outside
// the window reads 0, an invalid depth). Rounding mirrors the plain version
// (ops/projective.py sample_terms) operation for operation.
#pragma once

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

// One voxel's terms. `upd` false means no channel changes; then the other
// fields are unset except `label`.
struct VoxelTerms {
  bool upd;     // the voxel takes a TSDF update
  bool gate;    // |sdf| < trunc: colour blend and near-surface votes
  bool vote;    // the update counts a semantic vote (informative label)
  int label;    // sampled label
  float w, w_sdf;
  size_t a;     // atlas offset of the sample (for the colour planes)
};

// Where a camera-frame point samples the atlas, for the block of meta row
// [v0, u0_atlas, real, lvl, u0_level, ...]: `ok` (in front of the camera,
// inside the image and its level), `inwin` (inside the block's window: then
// the sample is atlas[a] and atlas[plane + a]) and zsafe.
struct Pixel {
  bool ok, inwin;
  int a;
  float zsafe;
};

__device__ __forceinline__ Pixel proj_pixel(float pX, float pY, float pZ,
                                            int v0, int u0a, int lvl, int u0l,
                                            const ProjParams& p) {
  Pixel r;
  const bool zok = pZ > 1e-3f;
  r.zsafe = fmaxf(pZ, 1e-3f);
  const float u = p.fx * pX / r.zsafe + p.cx;
  const float v = p.fy * pY / r.zsafe + p.cy;
  const int ui = (int)floorf(u + 0.5f);
  const int vi = (int)floorf(v + 0.5f);
  const bool in_img = zok && ui >= 0 && ui < p.width && vi >= 0 && vi < p.height;
  const int ul = clampi(ui, 0, p.width - 1) >> lvl;
  const int vl = clampi(vi, 0, p.height - 1) >> lvl;
  const bool lvl_ok = ul < (p.width >> lvl) && vl < (p.height >> lvl);
  const int row = vl - v0, col = ul - u0l;
  r.inwin = row >= 0 && row < p.row_window && col >= 0 && col < p.col_window;
  r.a = r.inwin ? (v0 + row) * p.atlas_width + (u0a + col) : 0;
  r.ok = in_img && lvl_ok;
  return r;
}

// update_terms_from_sample (ops/projective.py) for the sample (depth,
// label) of a camera-frame point.
__device__ __forceinline__ VoxelTerms proj_terms(float pX, float pY, float pZ,
                                                 const Pixel& px, float depth,
                                                 int label,
                                                 const ProjParams& p) {
  VoxelTerms r;
  r.upd = false;
  r.label = label;
  r.a = px.a;
  const bool depth_ok = depth > 0.f && depth < 1.0e6f * 0.5f;
  const bool finite = depth_ok && px.ok;
  if (!finite) return r;  // no update, whatever the rest gives
  const float t_v = sqrtf(__fmaf_rn(pZ, pZ, __fmaf_rn(pX, pX, pY * pY)));
  const float ray_norm = t_v * depth / px.zsafe;
  const float sdf = ray_norm - t_v;
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
  if (!upd) return r;

  float w_point = 1.f;
  if (!p.use_const_weight)
    w_point = depth > 1e-6f ? 1.f / fmaxf(depth * depth, 1e-12f) : 0.f;
  float w = w_point;
  if (p.use_dropoff) {
    const float scale = (trunc + sdf) * p.dropoff_scale;
    if (sdf < -p.dropoff_eps) w = fmaxf(w_point * scale, 0.f);
  }
  r.upd = true;
  r.w = w;
  r.w_sdf = w * clampf(sdf, -trunc, trunc);
  r.gate = fabsf(sdf) < trunc;
  r.vote = (p.near_surface_only ? r.gate : true) && label != 0;
  return r;
}

// The sampled colour of a voxel (mip_ops.unpack_color) from its atlas
// words (rg, b): r, g, b as floats.
__device__ __forceinline__ void proj_rgb(float rg_word, float b_word,
                                         float rgb[3]) {
  const float rg = rintf(rg_word);
  rgb[0] = floorf(rg / 256.f);
  rgb[1] = rg - rgb[0] * 256.f;
  rgb[2] = rintf(b_word);
}
