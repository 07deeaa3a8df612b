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
// small beside it. The per-voxel sample and update terms are shared with
// K4 (proj_common.cuh); the sampled atlas window stays hot in L2. Channels
// are only touched where the update is non-zero, and only the label's own
// sem_delta plane, so untouched voxels cost no grid traffic.
#include "proj_common.cuh"

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
  const VoxelTerms t = proj_voxel_terms(meta + 8 * k, vox, tcg, atlas, p);
  if (!t.upd) return;
  const size_t rows = (size_t)p.rows_total;
  const size_t e = (size_t)slots[k] * p.V3 + vox;
  wsum[e] += t.w;
  wsdf[e] += t.w_sdf;
  if (t.vote) {
    sem_count[e] += 1.f;
    if (t.label >= 0 && t.label < p.L)
      sem_delta[(size_t)t.label * rows * p.V3 + e] += p.lk_delta;
  }
  if (p.with_color && t.gate) {
    float rgb[3];
    proj_voxel_rgb(atlas, t.a, p, rgb);
    const size_t cs = rows * p.V3;
    wcolor[e] += t.w * rgb[0];
    wcolor[cs + e] += t.w * rgb[1];
    wcolor[2 * cs + e] += t.w * rgb[2];
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
