// An empty kernel: one block of one thread that does nothing.
//
// Not part of any path. chip_smoke.py times it to measure the launch floor,
// the least device time any kernel launch takes on this card, which bounds
// the small kernels of the main path (K1, K2) from below more tightly than
// their bytes do.
#include "ksd_common.cuh"

__global__ void empty_kernel() {}

extern "C" int ksd_empty(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
