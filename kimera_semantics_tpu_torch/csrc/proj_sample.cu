// K4: projective sample + update terms, written out as delta planes.
//
// Replaces the Pallas kernel projective_sample_update / _proj_kernel +
// _proj_tile of kimera_semantics_tpu/ops/pallas_kernels.py. K5
// (block_rmw.cu, onehot votes) then adds the planes into the grid; this is
// the projective route for fused_apply=False and for blocks past the fused
// kernel's V3 (32^3 literal storage).
//
// One CUDA block per (8-row tile, chunk of the tile's 8 x V3 voxels), one
// thread per voxel, running the same per-voxel code as K3
// (proj_common.cuh). The TPU kernel skips tiles with no real row and leaves
// their outputs as garbage; here the tiles K5 skips (slot group outside
// the live rows: the frame list's trash tail) are skipped, and every voxel
// of every other tile is written, zeros included: padding rows and voxels
// without an update read as no delta, so K5 may read the whole tile.
//
// Bound on this card: bytes. Each live tile writes its d_w, d_wsdf, d_cnt
// and label planes (and d_wc in colour mode) once; the atlas window it
// samples stays hot in L2.
#include "proj_common.cuh"

__global__ void proj_sample_kernel(float* __restrict__ d_w,
                                   float* __restrict__ d_wsdf,
                                   float* __restrict__ d_cnt,
                                   int* __restrict__ d_lab,
                                   float* __restrict__ d_wc,
                                   const int* __restrict__ slots,
                                   const int* __restrict__ meta,
                                   const float* __restrict__ tcg,
                                   const float* __restrict__ atlas,
                                   ProjParams p) {
  const int tile = blockIdx.x;
  const int group = floor_div(slots[8 * tile], 8);
  if (group < 0 || group >= p.trash_group) return;  // K5 skips this tile
  const int flat = blockIdx.y * blockDim.x + threadIdx.x;
  if (flat >= 8 * p.V3) return;
  const int k = 8 * tile + flat / p.V3;
  const int vox = flat % p.V3;
  const VoxelTerms t = proj_voxel_terms(meta + 8 * k, vox, tcg, atlas, p);
  const size_t e = (size_t)k * p.V3 + vox;
  d_w[e] = t.upd ? t.w : 0.f;
  d_wsdf[e] = t.upd ? t.w_sdf : 0.f;
  d_cnt[e] = (t.upd && t.vote) ? 1.f : 0.f;
  d_lab[e] = t.upd ? t.label : 0;
  if (p.with_color) {
    float rgb[3] = {0.f, 0.f, 0.f};
    const float wc = (t.upd && t.gate) ? t.w : 0.f;
    if (wc > 0.f) proj_voxel_rgb(atlas, t.a, p, rgb);
    const size_t c0 = ((size_t)k * 3) * p.V3 + vox;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      d_wc[c0 + (size_t)ch * p.V3] = wc > 0.f ? wc * rgb[ch] : 0.f;
  }
}

extern "C" int ksd_projective_sample_update(float* d_w, float* d_wsdf,
                                            float* d_cnt, int* d_lab,
                                            float* d_wc, const int* slots,
                                            const int* meta, const float* tcg,
                                            const float* atlas, ProjParams p,
                                            void* stream) {
  const int threads = 256;
  dim3 grid(p.K / 8, (8 * p.V3 + threads - 1) / threads);
  proj_sample_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      d_w, d_wsdf, d_cnt, d_lab, d_wc, slots, meta, tcg, atlas, p);
  return (int)cudaGetLastError();
}
