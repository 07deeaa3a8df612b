// K6: slot resolve against the frame's camera cube, one thread per ray.
//
// Replaces the Pallas kernel slot_resolve_stream / _slot_kernel of
// kimera_semantics_tpu/ops/pallas_kernels.py. The TPU gathers each run's
// slot from the cube with a two-level bf16 hi/lo MXU contraction and a
// masked lane reduction; here a thread loads its ray's MAXR run slots
// directly from the cube of its frame (ray / per_frame), writes them to
// run_slots and reads each step's slot back from there (its own writes,
// served by L1), so MAXR has no limit.
//
// Bound on this card: bytes. Per step a ray reads four 4-byte planes
// (run_idx, local, w, wsdf), the wc plane only with gate_near (and then
// only where the step is valid), and a 1-byte valid flag; it writes five
// 4-byte planes and a 1-byte flag, each word once and coalesced across the
// warp's neighbouring rays ((S, R) planes, rays fastest). The flags are
// torch bools, read and written as bytes, so the wrapper converts nothing.
// The cube (< 20 KB a frame) stays in L1/L2. The arithmetic is a few
// integer ops per step.
#include "ksd_common.cuh"

struct SlotParams {
  int R, S, maxr, per_frame, side, E, ext, v3, cap, pad, lab_shift, gate_near;
  float trunc;
};

__global__ void slot_resolve_kernel(
    const float* __restrict__ cube, const int* __restrict__ cam_block,
    const int* __restrict__ run_key, const int* __restrict__ run_idx,
    const int* __restrict__ local, const float* __restrict__ w,
    const float* __restrict__ wsdf, const float* __restrict__ wc,
    const bool* __restrict__ valid, const int* __restrict__ labels,
    const bool* __restrict__ inform, SlotParams p, int* __restrict__ k2_out,
    float* __restrict__ w_out, float* __restrict__ wsdf_out,
    float* __restrict__ cnt_out, int* __restrict__ key_out,
    bool* __restrict__ valid_out, int* __restrict__ run_slots) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int R = p.R;
  if (r >= R) return;
  const int b = r / p.per_frame;
  const int cbx = cam_block[3 * b], cby = cam_block[3 * b + 1],
            cbz = cam_block[3 * b + 2];
  const float* frame_cube = cube + (size_t)b * p.pad;

  for (int m = 0; m < p.maxr; ++m) {
    const int rk = run_key[m * R + r];
    const int bx = ((rk >> 20) & 0x3FF) - p.ext - cbx + p.E;
    const int by = ((rk >> 10) & 0x3FF) - p.ext - cby + p.E;
    const int bz = (rk & 0x3FF) - p.ext - cbz + p.E;
    const bool in_c = rk >= 0 && bx >= 0 && bx < p.side && by >= 0 &&
                      by < p.side && bz >= 0 && bz < p.side;
    const int slot =
        in_c ? (int)frame_cube[(bx * p.side + by) * p.side + bz] : -1;
    run_slots[m * R + r] = slot;
  }

  const int lab = labels[r];
  const bool informative = inform[r];
  for (int s = 0; s < p.S; ++s) {
    const int idx = s * R + r;
    const int ri = run_idx[idx];
    const int slot = (ri >= 0 && ri < p.maxr) ? run_slots[ri * R + r] : -1;
    const bool v = valid[idx] && slot >= 0 && slot < p.cap;
    const int key = slot * p.v3 + local[idx];
    const float wv = w[idx];
    key_out[idx] = key;
    k2_out[idx] = v ? ((key << p.lab_shift) | lab) : 0x7FFFFFFF;
    w_out[idx] = v ? wv : 0.f;
    wsdf_out[idx] = v ? __fmaf_rn(wv, p.trunc, wsdf[idx]) : 0.f;
    const bool gate = v && (!p.gate_near || wc[idx] > 0.f);
    cnt_out[idx] = (gate && informative) ? 1.f : 0.f;
    valid_out[idx] = v;
  }
}

extern "C" int ksd_slot_resolve(const float* cube, const int* cam_block,
                                const int* run_key, const int* run_idx,
                                const int* local, const float* w,
                                const float* wsdf, const float* wc,
                                const bool* valid, const int* labels,
                                const bool* inform, SlotParams p, int* k2,
                                float* w_out, float* wsdf_out, float* cnt,
                                int* key, bool* valid_out, int* run_slots,
                                void* stream) {
  const int threads = 128;
  const int blocks = (p.R + threads - 1) / threads;
  slot_resolve_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      cube, cam_block, run_key, run_idx, local, w, wsdf, wc, valid, labels,
      inform, p, k2, w_out, wsdf_out, cnt, key, valid_out, run_slots);
  return (int)cudaGetLastError();
}
