// K5: block read-modify-write add of 8-row delta tiles into the grid.
//
// Replaces the Pallas kernel block_rmw_add / _rmw_kernel of
// kimera_semantics_tpu/ops/pallas_kernels.py. There, one grid step fetches
// a whole (8, V3) channel tile group, adds the aligned delta tile and
// writes every semantic plane back. Here one CUDA block takes one delta
// tile and a chunk of 256 voxel lanes; each thread walks the tile's 8 rows.
// Tiles name distinct tile groups by construction, so no two blocks touch
// one grid word and no atomics are needed; a trash tile returns at once.
//
// Bound on this card: bytes. Every delta word of a live tile is read once;
// a grid word is read and written only where its delta is nonzero (adding
// +0.0 changes no value the grid holds), and only the semantic planes that
// receive a vote are touched: the plane d_lab where the count is nonzero
// (onehot), the planes with nonzero counts (dense), each rank's decoded
// label where its count is positive (packed). Colour is touched only when
// d_wc is given (ColorMode.COLOR). Loads and stores are coalesced along the
// voxel lanes.
#include "ksd_common.cuh"

struct RmwParams {
  int K, V3, L, P, rows_total, trash_group, sem_mode;
  float lk;
};

__device__ __forceinline__ void add_nonzero(float* __restrict__ dst,
                                            float d) {
  if (d != 0.f) *dst += d;
}

__global__ void block_rmw_kernel(
    float* __restrict__ wsum, float* __restrict__ wsdf,
    float* __restrict__ sem_count, float* __restrict__ sem_delta,
    float* __restrict__ wcolor, const int* __restrict__ slots,
    const float* __restrict__ d_w, const float* __restrict__ d_wsdf,
    const float* __restrict__ d_cnt, const int* __restrict__ d_lab,
    const float* __restrict__ d_sem, const float* __restrict__ d_wc,
    RmwParams p) {
  const int tile = blockIdx.x;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v >= p.V3) return;
  const int group = floor_div(slots[tile * 8], 8);
  // Trash tiles, and any slot outside the live rows, add nothing.
  if (group < 0 || group >= p.trash_group) return;
  const size_t V3 = p.V3;
  const size_t plane = (size_t)p.rows_total * V3;
  const size_t dplane = (size_t)p.K * V3;
  for (int row = 0; row < 8; ++row) {
    const size_t k = (size_t)tile * 8 + row;
    const size_t src = k * V3 + v;
    const size_t dst = ((size_t)group * 8 + row) * V3 + v;
    add_nonzero(wsum + dst, d_w[src]);
    add_nonzero(wsdf + dst, d_wsdf[src]);
    const float c = d_cnt[src];
    add_nonzero(sem_count + dst, c);
    if (p.sem_mode == 0) {          // onehot: one label per voxel
      const int l = d_lab[src];
      if (c != 0.f && l >= 0 && l < p.L)
        sem_delta[l * plane + dst] += c * p.lk;
    } else if (p.sem_mode == 1) {   // dense: counts per label
      for (int l = 0; l < p.L; ++l) {
        const float d = d_sem[l * dplane + src];
        if (d != 0.f) {
          float* s = sem_delta + l * plane + dst;
          *s = __fmaf_rn(d, p.lk, *s);
        }
      }
    } else {                        // packed: rank planes of count*32+label
      for (int r = 0; r < p.P; ++r) {
        const float pv = d_sem[r * dplane + src];
        const float cr = floorf(pv * 0.03125f);
        const int l = (int)(pv - 32.f * cr);
        if (cr != 0.f && l >= 0 && l < p.L)
          sem_delta[l * plane + dst] += cr * p.lk;
      }
    }
    if (d_wc != nullptr) {
      for (int ch = 0; ch < 3; ++ch)
        add_nonzero(wcolor + ch * plane + dst, d_wc[(k * 3 + ch) * V3 + v]);
    }
  }
}

extern "C" int ksd_block_rmw_add(float* wsum, float* wsdf, float* sem_count,
                                 float* sem_delta, float* wcolor,
                                 const int* slots, const float* d_w,
                                 const float* d_wsdf, const float* d_cnt,
                                 const int* d_lab, const float* d_sem,
                                 const float* d_wc, RmwParams p,
                                 void* stream) {
  const int threads = 256;
  const dim3 grid(p.K / 8, (p.V3 + threads - 1) / threads);
  block_rmw_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      wsum, wsdf, sem_count, sem_delta, wcolor, slots, d_w, d_wsdf, d_cnt,
      d_lab, d_sem, d_wc, p);
  return (int)cudaGetLastError();
}
