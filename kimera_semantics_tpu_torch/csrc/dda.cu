// K1: DDA job stream.
//
// Replaces the Pallas kernel dda_job_stream / _dda_kernel of
// kimera_semantics_tpu/ops/pallas_kernels.py:33-198 (the TPU walks 512 rays
// per program on the 128-lane axis, one vector step per DDA step).
//
// Bound on this card: bytes at the voxel walk (a ray reads 53 bytes and
// writes 25 bytes for each of its S steps in 7 (S, R) planes, plus MAXR run
// rows: 9.3 MB at R 28672, S 10, 2.8 us), the launch at the block walk
// (keys and validity only: 0.5 MB at R 4800, S 15). The first design gave
// each ray a thread that walked all S steps and did all of each step's work:
// three integer divisions by a runtime vps, an IEEE division and seven
// stores per step, and 38 CTAs of 128 threads at the block walk's R 4800 on
// 132 SMs. It ran at 7.4x (block) and 2.25x (voxel) its least time (NVIDIA
// H100 80GB HBM3, 700 W, PERF.md).
//
// This design:
//  - vps is a template parameter for 1, 8, 16 and 32 (floor division is an
//    arithmetic shift and the in-block index a mask, both exact for negative
//    coordinates), with a generic instance for any other vps;
//  - the axis choice of a step is three selects, not a branch (the lanes of
//    a warp take different axes, and the branch made the block walk a
//    quarter slower);
//  - a keys-only instance for the allocation walk, which keeps only the
//    block keys and the validity: one thread per ray, CTAs of 32 threads (150
//    CTAs at R 4800), no sdf, and only the start and end points read;
//  - the full instance splits the serial walk from the sdf. A CTA of NT = 96
//    threads takes RT = 32 rays. Phase 1: warp 0 walks them, a thread per
//    ray, through a chunk of SC steps: the DDA recurrence (the axis choice
//    and tn += ts in the reference's order, so the bits do not change), the
//    block key, the validity and the block-run position; it stores the key,
//    validity and run planes (coalesced across the warp's rays) and stages
//    each step's voxel in shared memory, while warp 1 loads the rays' sdf
//    terms. Phase 2: all three warps take the chunk's (step, ray) items, a
//    thread keeping one ray, and compute the in-block index, the projective
//    sdf (the division) and the weight planes;
//  - job_valid is read and valid written as torch bools (1 byte);
//  - a walk's six start and end words are loaded before any of its
//    arithmetic, in one round trip;
//  - 1 / x and -1 / x are the correctly rounded reciprocal (__frcp_rn),
//    bit for bit the division the plain version does.
// What still holds the voxel walk back: the walk of phase 1 is a dependent
// chain per ray, run by every CTA of an SM at once, and the stores of phase
// 2 wait for it. Other shapes tried (64-256 threads, 64 rays a CTA, 8-step
// chunks, a hand-over per step through named barriers or mbarriers) were
// bit-exact and slower (PERF.md).
#include <stdint.h>

#include "ksd_common.cuh"

struct DdaParams {
  int R, S, maxr, vps, ext, use_dropoff;
  float inv, voxel_size, trunc, dropoff_eps, dropoff_scale;
};

constexpr int RT = 32;  // rays of a CTA of the full instance (warp 0 walks)
constexpr int NT = 96;  // threads of a CTA of the full instance
constexpr int KT = 32;  // threads (rays) of a CTA of the keys-only instance
constexpr int SC = 16;  // steps of a chunk staged in shared memory

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v / 2);
}

// Block coordinate of voxel coordinate x (VPS > 0: a power of two known at
// compile time; 0: the runtime vps).
template <int VPS>
__device__ __forceinline__ int block_of(int x, int vps) {
  if (VPS > 0) return x >> ilog2(VPS);
  return floor_div(x, vps);
}

// The in-block linear index of voxel (x, y, z).
template <int VPS>
__device__ __forceinline__ int local_index(int x, int y, int z, int vps) {
  if (VPS > 0) {
    constexpr int L = ilog2(VPS), M = VPS - 1;
    return ((x & M) << (2 * L)) | ((y & M) << L) | (z & M);
  }
  const int lx = x - floor_div(x, vps) * vps;
  const int ly = y - floor_div(y, vps) * vps;
  const int lz = z - floor_div(z, vps) * vps;
  return (lx * vps + ly) * vps + lz;
}

// The DDA state of one ray (raycast.dda_init / dda_advance).
struct Walk {
  int curr[3], sgn[3], n_steps;
  float tn[3], ts[3];

  __device__ __forceinline__ void init(const float* __restrict__ start3,
                                       const float* __restrict__ end3,
                                       int r, int R, float inv) {
    // All six loads first: written axis by axis, nvcc issued each axis's
    // loads only after the previous axis's division and its slow-path
    // branch, three round trips in a row.
    float st[3], en[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      st[a] = start3[a * R + r];
      en[a] = end3[a * R + r];
    }
    n_steps = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float s3 = st[a] * inv, e3 = en[a] * inv;
      curr[a] = (int)floorf(s3 + 1e-6f);
      const int end_i = (int)floorf(e3 + 1e-6f);
      n_steps += abs(end_i - curr[a]);
      // end * inv - s3 with the product fused, as XLA:CPU compiles the
      // reference's kernel (raycast.dda_init with inv)
      const float ray = __fmaf_rn(en[a], inv, -s3);
      const int sg = ray > 0.f ? 1 : (ray < 0.f ? -1 : 0);
      sgn[a] = sg;
      const float corrected = sg > 0 ? 1.f : 0.f;
      const float frac = s3 - (float)curr[a];
      const float safe = ray == 0.f ? 1.f : ray;
      tn[a] = ray == 0.f ? INFINITY : (corrected - frac) / safe;
      // sg / safe for sg = +-1: the correctly rounded reciprocal, signed
      const float rc = __frcp_rn(safe);
      ts[a] = sg > 0 ? rc : (sg < 0 ? -rc : 0.f);
    }
  }

  // Advance along the axis of least crossing time (first-min tie-break).
  __device__ __forceinline__ void advance() {
    const float min01 = fminf(tn[0], tn[1]);
    const bool a2 = tn[2] < min01;
    const bool a1 = !a2 && tn[1] < tn[0];
    const bool a0 = !a2 && !a1;
    curr[0] += a0 ? sgn[0] : 0;
    curr[1] += a1 ? sgn[1] : 0;
    curr[2] += a2 ? sgn[2] : 0;
    tn[0] = a0 ? tn[0] + ts[0] : tn[0];
    tn[1] = a1 ? tn[1] + ts[1] : tn[1];
    tn[2] = a2 ? tn[2] + ts[2] : tn[2];
  }
};

// The packed block key of the current voxel and its block coordinates'
// range check.
template <int VPS>
__device__ __forceinline__ int step_key(const Walk& wk, const DdaParams& p,
                                        bool& in_b) {
  const int vps = p.vps, ext = p.ext;
  const int bx = block_of<VPS>(wk.curr[0], vps);
  const int by = block_of<VPS>(wk.curr[1], vps);
  const int bz = block_of<VPS>(wk.curr[2], vps);
  in_b = bx >= -ext && bx < ext && by >= -ext && by < ext && bz >= -ext &&
         bz < ext;
  return ((bx + ext) << 20) | ((by + ext) << 10) | (bz + ext);
}

// Keys-only instance: one thread per ray writes key (-1 where invalid) and
// valid for each step, coalesced across the warp's rays.
template <int VPS>
__global__ void __launch_bounds__(KT)
    dda_kernel_keys(const float* __restrict__ start3,
                    const float* __restrict__ end3,
                    const bool* __restrict__ flags, DdaParams p,
                    int* __restrict__ key_out, bool* __restrict__ valid_out) {
  const int r = blockIdx.x * KT + threadIdx.x;
  const int R = p.R;
  if (r >= R) return;
  const bool ray_valid = flags[r];
  Walk wk;
  wk.init(start3, end3, r, R, p.inv);
  for (int s = 0; s < p.S; ++s) {
    bool in_b;
    const int key = step_key<VPS>(wk, p, in_b);
    const bool valid = s <= wk.n_steps && ray_valid && in_b;
    key_out[(size_t)s * R + r] = valid ? key : -1;
    valid_out[(size_t)s * R + r] = valid;
    wk.advance();
  }
}

// Full instance: RT rays a CTA, walked SC steps at a time.
static_assert(NT % RT == 0 && NT >= 2 * RT, "a CTA holds its walking warp "
              "and at least one more");

template <int VPS>
__global__ void __launch_bounds__(NT)
    dda_kernel(const float* __restrict__ origin3,
               const float* __restrict__ point3,
               const float* __restrict__ start3,
               const float* __restrict__ end3,
               const float* __restrict__ weights,
               const bool* __restrict__ flags, DdaParams p,
               int* __restrict__ key_out, int* __restrict__ local_out,
               float* __restrict__ w_out, float* __restrict__ wsdf_out,
               float* __restrict__ wc_out, bool* __restrict__ valid_out,
               int* __restrict__ run_key, int* __restrict__ run_idx) {
  // Per step and ray: the voxel and the step's validity (phase 2's
  // inputs). Per ray: origin, direction, length, its clamp, weight.
  __shared__ int s_vox[3][SC][RT];
  __shared__ bool s_valid[SC][RT];
  __shared__ float s_ray[9][RT];
  const int tid = threadIdx.x;
  const int R = p.R, r0 = blockIdx.x * RT;
  const int n_rays = min(RT, R - r0);

  // Phase 1 state, in the walking warp's registers across chunks. The
  // second warp loads the sdf's per-ray terms meanwhile.
  Walk wk;
  bool ray_valid = false;
  int pos = -1, prev = -2;
  const int rw = r0 + tid;
  if (tid < n_rays) {
    ray_valid = flags[rw];
    wk.init(start3, end3, rw, R, p.inv);
  } else if (tid >= RT && tid - RT < n_rays) {
    const int rl = tid - RT, r = r0 + rl;
    float vec[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float o = origin3[a * R + r];
      vec[a] = point3[a * R + r] - o;
      s_ray[a][rl] = o;
      s_ray[3 + a][rl] = vec[a];
    }
    const float dist = sqrtf(
        __fmaf_rn(vec[2], vec[2], __fmaf_rn(vec[1], vec[1], vec[0] * vec[0])));
    s_ray[6][rl] = dist;
    s_ray[7][rl] = fmaxf(dist, 1e-12f);
    s_ray[8][rl] = weights[r];
  }

  for (int s0 = 0; s0 < p.S; s0 += SC) {
    const int ns = min(SC, p.S - s0);
    if (tid < n_rays) {
      // Phase 1: the walk; the planes that need no sdf go out from here,
      // coalesced across the warp's rays.
      size_t idx = (size_t)s0 * R + rw;
      for (int j = 0; j < ns; ++j, idx += R) {
        bool in_b;
        const int key = step_key<VPS>(wk, p, in_b);
        const bool valid = s0 + j <= wk.n_steps && ray_valid && in_b;
        // Block runs: a new run row on every block change along the valid
        // steps (the last row takes every later change).
        const bool changed = key != prev && valid;
        pos = min(pos + (changed ? 1 : 0), p.maxr - 1);
        if (changed) run_key[(size_t)pos * R + rw] = key;
        if (valid) prev = key;
        key_out[idx] = valid ? key : -1;
        valid_out[idx] = valid;
        run_idx[idx] = pos;
#pragma unroll
        for (int a = 0; a < 3; ++a) s_vox[a][j][tid] = wk.curr[a];
        s_valid[j][tid] = valid;
        wk.advance();
      }
    }
    __syncthreads();
    // Phase 2: a thread keeps one ray (tid % RT) and takes every
    // (NT / RT)-th step of the chunk, so a warp stores RT neighbouring rays
    // of one step.
    const int rl = tid % RT;
    if (rl < n_rays) {
      const float o0 = s_ray[0][rl], o1 = s_ray[1][rl], o2 = s_ray[2][rl];
      const float v0 = s_ray[3][rl], v1 = s_ray[4][rl], v2 = s_ray[5][rl];
      const float dist = s_ray[6][rl], den = s_ray[7][rl];
      const float weight = s_ray[8][rl];
      for (int j = tid / RT; j < ns; j += NT / RT) {
        const int x = s_vox[0][j][rl], y = s_vox[1][j][rl],
                  z = s_vox[2][j][rl];
        // Projective sdf at the voxel center (voxblox computeDistance).
        const float A0 = __fmaf_rn((float)x + 0.5f, p.voxel_size, -o0);
        const float A1 = __fmaf_rn((float)y + 0.5f, p.voxel_size, -o1);
        const float A2 = __fmaf_rn((float)z + 0.5f, p.voxel_size, -o2);
        const float num = __fmaf_rn(A2, v2, __fmaf_rn(A0, v0, A1 * v1));
        const float sdf = dist - num / den;
        float w = weight;
        if (p.use_dropoff) {
          const float scale = (p.trunc + sdf) * p.dropoff_scale;
          if (sdf < -p.dropoff_eps) w = fmaxf(weight * scale, 0.f);
        }
        w = s_valid[j][rl] ? w : 0.f;
        const size_t idx = (size_t)(s0 + j) * R + r0 + rl;
        local_out[idx] = local_index<VPS>(x, y, z, p.vps);
        w_out[idx] = w;
        wsdf_out[idx] = w * clampf(sdf, -p.trunc, p.trunc);
        wc_out[idx] = fabsf(sdf) < p.trunc ? w : 0.f;
      }
    }
    __syncthreads();  // the chunk is read: the walk may overwrite it
  }
  // Run rows past the last block change stay empty.
  if (tid < n_rays)
    for (int m = pos + 1; m < p.maxr; ++m) run_key[(size_t)m * R + rw] = -1;
}

template <int VPS>
static int launch(const float* origin3, const float* point3,
                  const float* start3, const float* end3,
                  const float* weights, const bool* flags, const DdaParams& p,
                  int keys_only, int* key, int* local, float* w, float* wsdf,
                  float* wc, bool* valid, int* run_key, int* run_idx,
                  cudaStream_t stream) {
  if (keys_only)
    dda_kernel_keys<VPS><<<(p.R + KT - 1) / KT, KT, 0, stream>>>(
        start3, end3, flags, p, key, valid);
  else
    dda_kernel<VPS><<<(p.R + RT - 1) / RT, NT, 0, stream>>>(
        origin3, point3, start3, end3, weights, flags, p, key, local, w, wsdf,
        wc, valid, run_key, run_idx);
  return (int)cudaGetLastError();
}

// keys_only: only key and valid are written (the other output pointers and
// origin3, point3 and weights may be null).
extern "C" int ksd_dda_job_stream(const float* origin3, const float* point3,
                                  const float* start3, const float* end3,
                                  const float* weights, const bool* flags,
                                  DdaParams p, int keys_only, int* key,
                                  int* local, float* w, float* wsdf, float* wc,
                                  bool* valid, int* run_key, int* run_idx,
                                  void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define KSD_DDA_LAUNCH(V)                                                    \
  launch<V>(origin3, point3, start3, end3, weights, flags, p, keys_only, key, \
            local, w, wsdf, wc, valid, run_key, run_idx, s)
  switch (p.vps) {
    case 1: return KSD_DDA_LAUNCH(1);
    case 8: return KSD_DDA_LAUNCH(8);
    case 16: return KSD_DDA_LAUNCH(16);
    case 32: return KSD_DDA_LAUNCH(32);
    default: return KSD_DDA_LAUNCH(0);
  }
#undef KSD_DDA_LAUNCH
}
