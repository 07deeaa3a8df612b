// K7: o = x + y over float32, one thread per element.
//
// Replaces the `_add` Pallas kernel of scripts/profile_scatter_r4.py
// (:103-110), the WARM_PALLAS probe of that TPU profiling script: an
// (8, 128) f32 add run once under a raised scoped-VMEM limit, to test
// whether running any Pallas kernel flips per-device state that slows
// later XLA scatters. The card has no scoped VMEM limit to raise, so the
// port's probe (tools/profile_scatter.py --warm-kernel) only launches it.
//
// Bound: 3 x 4 B per element moved (two reads, one write); at (8, 128)
// that is 12 KB, about 3.7 ns at 3.35 TB/s, far under the launch floor
// (csrc/empty.cu), so the kernel is expected at that floor. Bit-exact
// against x + y: one IEEE float32 add per element, nothing contracted
// (--fmad=false).
#include "ksd_common.cuh"

__global__ void ksd_add_f32_kernel(const float* __restrict__ x,
                                   const float* __restrict__ y,
                                   float* __restrict__ o, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + y[i];
}

extern "C" int ksd_add_f32(const float* x, const float* y, float* o,
                           long long n, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  ksd_add_f32_kernel<<<(unsigned)blocks, threads, 0,
                       (cudaStream_t)stream>>>(x, y, o, n);
  return (int)cudaGetLastError();
}
