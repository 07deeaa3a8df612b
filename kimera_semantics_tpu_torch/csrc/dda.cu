// K1: DDA job stream, one thread per ray.
//
// Replaces the Pallas kernel dda_job_stream / _dda_kernel of
// kimera_semantics_tpu/ops/pallas_kernels.py (the TPU walks 512 rays per
// program on the 128-lane axis; here each thread walks one ray).
//
// Bound on this card: bytes. A ray reads 22 bytes and writes 4 bytes for
// each of its S steps in 7 (S, R) planes plus MAXR run rows; the arithmetic
// per step is a few dozen flops. The S-step loop keeps the whole DDA state
// (voxel, crossing times, run position) in registers, so each output word
// is written exactly once, coalesced across the warp's neighbouring rays;
// the TPU's one-hot accumulate over MAXR run rows becomes one direct store
// at the new run row. At the main path's size (R = 4800, S = 15) the launch
// itself dominates.
#include "ksd_common.cuh"

struct DdaParams {
  int R, S, maxr, vps, ext, use_dropoff;
  float inv, voxel_size, trunc, dropoff_eps, dropoff_scale;
};

__global__ void dda_kernel(const float* __restrict__ origin3,
                           const float* __restrict__ point3,
                           const float* __restrict__ start3,
                           const float* __restrict__ end3,
                           const float* __restrict__ weights,
                           const int* __restrict__ flags, DdaParams p,
                           int* __restrict__ key_out,
                           int* __restrict__ local_out,
                           float* __restrict__ w_out,
                           float* __restrict__ wsdf_out,
                           float* __restrict__ wc_out,
                           int* __restrict__ valid_out,
                           int* __restrict__ run_key,
                           int* __restrict__ run_idx) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int R = p.R;
  if (r >= R) return;

  float o[3], vec[3];
  int curr[3], sgn[3];
  float tn[3], ts[3];
  int n_steps = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = origin3[a * R + r];
    vec[a] = point3[a * R + r] - o[a];
    const float s = start3[a * R + r];
    const float e = end3[a * R + r];
    const float s3 = s * p.inv, e3 = e * p.inv;
    curr[a] = (int)floorf(s3 + 1e-6f);
    const int end_i = (int)floorf(e3 + 1e-6f);
    n_steps += abs(end_i - curr[a]);
    const float ray = e3 - s3;
    const int sg = ray > 0.f ? 1 : (ray < 0.f ? -1 : 0);
    sgn[a] = sg;
    const float corrected = sg > 0 ? 1.f : 0.f;
    const float frac = s3 - (float)curr[a];
    const float safe = ray == 0.f ? 1.f : ray;
    tn[a] = ray == 0.f ? INFINITY : (corrected - frac) / safe;
    ts[a] = ray == 0.f ? 0.f : (float)sg / safe;
  }
  const float dist =
      sqrtf(__fmaf_rn(vec[2], vec[2], __fmaf_rn(vec[1], vec[1], vec[0] * vec[0])));
  const float inv_dist_den = fmaxf(dist, 1e-12f);
  const bool ray_valid = flags[r] != 0;
  const float weight = weights[r];
  const int vps = p.vps, ext = p.ext;

  for (int m = 0; m < p.maxr; ++m) run_key[m * R + r] = -1;
  int pos = -1, prev = -2;

  for (int s = 0; s < p.S; ++s) {
    const int bx = floor_div(curr[0], vps);
    const int by = floor_div(curr[1], vps);
    const int bz = floor_div(curr[2], vps);
    const int key = ((bx + ext) << 20) | ((by + ext) << 10) | (bz + ext);
    const int local = ((curr[0] - bx * vps) * vps + (curr[1] - by * vps)) * vps +
                      (curr[2] - bz * vps);
    const bool in_b = bx >= -ext && bx < ext && by >= -ext && by < ext &&
                      bz >= -ext && bz < ext;
    const bool valid = s <= n_steps && ray_valid && in_b;

    // Projective sdf at the voxel center (voxblox computeDistance).
    const float A0 = __fmaf_rn((float)curr[0] + 0.5f, p.voxel_size, -o[0]);
    const float A1 = __fmaf_rn((float)curr[1] + 0.5f, p.voxel_size, -o[1]);
    const float A2 = __fmaf_rn((float)curr[2] + 0.5f, p.voxel_size, -o[2]);
    const float num = __fmaf_rn(A2, vec[2], __fmaf_rn(A0, vec[0], A1 * vec[1]));
    const float sdf = dist - num / inv_dist_den;

    float w = weight;
    if (p.use_dropoff) {
      const float scale = (p.trunc + sdf) * p.dropoff_scale;
      if (sdf < -p.dropoff_eps) w = fmaxf(weight * scale, 0.f);
    }
    w = valid ? w : 0.f;
    const int idx = s * R + r;
    key_out[idx] = valid ? key : -1;
    local_out[idx] = local;
    w_out[idx] = w;
    wsdf_out[idx] = w * clampf(sdf, -p.trunc, p.trunc);
    wc_out[idx] = fabsf(sdf) < p.trunc ? w : 0.f;
    valid_out[idx] = valid ? 1 : 0;

    // Block runs: a new run row on every block change along the valid steps.
    const bool changed = key != prev && valid;
    pos = min(pos + (changed ? 1 : 0), p.maxr - 1);
    if (changed) run_key[pos * R + r] = key;
    run_idx[idx] = pos;
    if (valid) prev = key;

    // Advance along the axis of least crossing time (first-min tie-break).
    const float min01 = fminf(tn[0], tn[1]);
    const int axis = tn[2] < min01 ? 2 : (tn[1] < tn[0] ? 1 : 0);
    if (axis == 0) { curr[0] += sgn[0]; tn[0] += ts[0]; }
    else if (axis == 1) { curr[1] += sgn[1]; tn[1] += ts[1]; }
    else { curr[2] += sgn[2]; tn[2] += ts[2]; }
  }
}

extern "C" int ksd_dda_job_stream(const float* origin3, const float* point3,
                                  const float* start3, const float* end3,
                                  const float* weights, const int* flags,
                                  DdaParams p, int* key, int* local, float* w,
                                  float* wsdf, float* wc, int* valid,
                                  int* run_key, int* run_idx, void* stream) {
  const int threads = 128;
  const int blocks = (p.R + threads - 1) / threads;
  dda_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      origin3, point3, start3, end3, weights, flags, p, key, local, w, wsdf, wc,
      valid, run_key, run_idx);
  return (int)cudaGetLastError();
}
