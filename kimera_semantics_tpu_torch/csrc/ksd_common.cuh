// Helpers shared by the port's CUDA kernels.
//
// The kernels are built with --fmad=false: nvcc contracts no a*b + c by
// itself, and every fused multiply-add is an explicit __fmaf_rn placed
// exactly where the plain PyTorch version rounds once (core/fp.py). Division
// and sqrt are IEEE (no fast math). Integer division that must floor (block
// and patch-origin math) goes through floor_div, since C++ `/` truncates.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
