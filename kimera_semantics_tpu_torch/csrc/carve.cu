// The decimated carve jobs of one frame, built and compacted to the carve
// budget on the card in three launches.
//
// Replaces no Pallas kernel: the JAX package builds these jobs with XLA ops
// (kimera_semantics_tpu/ops/carve.py carve_jobs, compact_jobs), and the
// port's plain version (ops/carve.py carve_jobs, then compact_jobs) runs
// about 80 small torch ops a level, 15 a chunk, eight concatenations and a
// stable argsort over every slot.
//
//   carve_reach_kernel  one CTA per 32 x 32 pixel region: each pixel's ray
//                       reach (its distance where the pixel is valid, else
//                       3.0e38), min-pooled in shared memory to every level
//                       of the pyramid up to 32; writes each level's minima
//                       and the centre pixel's label (0 where that pixel is
//                       invalid) as (Hp/k, Wp/k) planes. Past k = 32 (a plan
//                       whose k_max exceeds 32) it writes the 32 x 32 minima
//                       and the regions' corner labels, which the slot
//                       kernels min-reduce and read for the coarser levels.
//   carve_count_kernel  the job slots, two a thread, in the plain version's
//                       slot order (level, chunk, row-major cell): each
//                       slot's valid flag; one count per CTA of 512 slots.
//   carve_write_kernel  the same slots and flags; each CTA sums the counts
//                       before it and in all, ranks its flags by warp
//                       ballots, and writes the kept slots in place: valid
//                       slots first in slot order, then invalid ones in slot
//                       order, cut at the budget (the plain version's stable
//                       partition). CTA 0 writes `dropped`.
//
// The plan (ops/carve.py carve_table) is a static table, one row a chunk:
// its first slot, level k, the level's plane shape and offset, and float32
// t0, t1 and the valid threshold f32(t0 + 1e-6). It lies on the device
// once per (plan, image size, device).
//
// Rounding mirrors the plain version operation for operation (built with
// --fmad=false): fma_as_plain where it calls core/fp.fma, IEEE division and
// sqrtf, and every Python constant it compares with rounded to float32 on
// the host, as torch rounds a scalar operand.
//
// Bound on this card: bytes. It reads the depth and label images and T_G_C
// and writes min(slots, budget) jobs of 17 words and a flag; the planes
// (about 0.9 MB at 720 x 480) and the counts stay in L2.
#include "ksd_common.cuh"

#define CARVE_MAX_DYN 8
#define CARVE_LEVELS 6     // k = 1, 2, 4, ..., 32 have planes of their own
#define CARVE_THREADS 256
#define CARVE_ROWS 2       // slots a thread: the wrapper's _CARVE_TILE is
                           // CARVE_THREADS * CARVE_ROWS
#define CARVE_TILE (CARVE_THREADS * CARVE_ROWS)  // slots a CTA of the slot kernels
#define CARVE_TABLE 8      // int words a chunk row

struct CarveParams {
  int H, W, Hp, Wp, allow_clear, use_const_weight, n_dyn;
  int dyn[CARVE_MAX_DYN];
  int plane[CARVE_LEVELS];  // offset of level k = 1 << i's planes, -1 if absent
  int base_off;             // offset of the 32 x 32 minima (k_max > 32), or -1
  int n_chunks, total, budget, out_n;
  float cx, cy, ifx, ify, min_ray, max_ray, inf, m_clamp, trunc;
};

// core/fp.fma as the plain version computes it: the float32 product, exact
// in double, plus c rounded to double, then to float32. __fmaf_rn rounds
// once, and the two differ where the double sum lands on a float32 tie,
// which these jobs meet often: a factor of few significant bits (t1 = 10.0,
// a chunk bound) times a unit component, plus an origin coordinate of
// 4e-16 (an orbit's cos 90 degrees), whose share the double sum drops.
__device__ __forceinline__ float fma_as_plain(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

__device__ __forceinline__ float ray_norm(float x, float y) {
  return sqrtf(fma_as_plain(y, y, x * x) + 1.0f);
}

// Reach and job label of pixel (y, x) of the padded image: the padding and
// invalid pixels reach 3.0e38 and label 0.
__device__ __forceinline__ void pixel_reach(const float* __restrict__ depth,
                                            const int* __restrict__ labels,
                                            const CarveParams& p, int y, int x,
                                            float& reach, int& lab) {
  reach = p.inf;
  lab = 0;
  if (y >= p.H || x >= p.W) return;
  const float xr = ((float)x - p.cx) * p.ifx;
  const float yr = ((float)y - p.cy) * p.ify;
  const float z = __ldg(depth + y * p.W + x);
  const int l = __ldg(labels + y * p.W + x);
  const float dist = z * ray_norm(xr, yr);
  bool ok = isfinite(z) && z > 0.f && dist >= p.min_ray;
  for (int i = 0; i < p.n_dyn; ++i) ok = ok && l != p.dyn[i];
  if (!p.allow_clear) ok = ok && dist <= p.max_ray;
  if (ok) {
    reach = fminf(dist, p.inf);
    lab = l;
  }
}

__device__ __forceinline__ void put_level(const CarveParams& p, int lv, int i,
                                          int j, float m, int lab,
                                          float* __restrict__ mplane,
                                          int* __restrict__ lplane) {
  const int off = p.plane[lv];
  if (off < 0) return;
  const int hk = p.Hp >> lv, wk = p.Wp >> lv;
  if (i < hk && j < wk) {
    mplane[off + i * wk + j] = m;
    lplane[off + i * wk + j] = lab;
  }
}

__global__ void __launch_bounds__(CARVE_THREADS) carve_reach_kernel(
    const float* __restrict__ depth, const int* __restrict__ labels,
    CarveParams p, float* __restrict__ mplane, int* __restrict__ lplane) {
  // Minima of the region's levels 2, 4, 8, 16, 32 (16^2 + 8^2 + ... + 1),
  // and each 2 x 2 quad's top-left label: the centre pixel of a level-k
  // cell (k >= 4) is the top-left pixel of quad (i k/2 + k/4, j k/2 + k/4).
  __shared__ float sm[256 + 64 + 16 + 4 + 1];
  __shared__ int sl[256];
  const int t = threadIdx.x, qy = t >> 4, qx = t & 15;
  const int y0 = blockIdx.y * 32 + 2 * qy, x0 = blockIdx.x * 32 + 2 * qx;
  float r[4];
  int l[4];
  for (int a = 0; a < 2; ++a)
    for (int b = 0; b < 2; ++b)
      pixel_reach(depth, labels, p, y0 + a, x0 + b, r[2 * a + b], l[2 * a + b]);
  for (int a = 0; a < 2; ++a)
    for (int b = 0; b < 2; ++b)
      put_level(p, 0, y0 + a, x0 + b, r[2 * a + b], l[2 * a + b], mplane,
                lplane);
  const float m2 = fminf(fminf(r[0], r[1]), fminf(r[2], r[3]));
  sm[t] = m2;
  sl[t] = l[0];
  put_level(p, 1, blockIdx.y * 16 + qy, blockIdx.x * 16 + qx, m2, l[3], mplane,
            lplane);
  int side = 16, in = 0, out = 256;
  for (int lv = 2; lv <= 5; ++lv) {
    __syncthreads();
    const int ns = side >> 1;
    if (t < ns * ns) {
      const int ci = t / ns, cj = t - ci * ns;
      const float* s = sm + in + (2 * ci) * side + 2 * cj;
      const float m =
          fminf(fminf(s[0], s[1]), fminf(s[side], s[side + 1]));
      sm[out + t] = m;
      const int h = 1 << (lv - 1), q = 1 << (lv - 2);  // k/2, k/4
      const int lab = sl[(ci * h + q) * 16 + cj * h + q];
      put_level(p, lv, blockIdx.y * ns + ci, blockIdx.x * ns + cj, m, lab,
                mplane, lplane);
      if (lv == 5 && p.base_off >= 0) {
        const int o = p.base_off + blockIdx.y * (p.Wp >> 5) + blockIdx.x;
        mplane[o] = m;
        lplane[o] = sl[0];
      }
    }
    in = out;
    out += ns * ns;
    side = ns;
  }
}

// One job slot: its chunk row and its cell's minimum reach and flag.
struct SlotView {
  int chunk, k, wk, cell;
  float m, t1;
  bool valid;
};

__device__ __forceinline__ SlotView slot_view(const int* __restrict__ table,
                                              const float* __restrict__ mplane,
                                              const CarveParams& p, int s) {
  int lo = 0, hi = p.n_chunks - 1;
  while (lo < hi) {  // the last chunk whose first slot is <= s
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(table + mid * CARVE_TABLE) <= s) lo = mid; else hi = mid - 1;
  }
  const int* row = table + lo * CARVE_TABLE;
  SlotView v;
  v.chunk = lo;
  v.k = __ldg(row + 1);
  v.wk = __ldg(row + 3);
  v.cell = s - __ldg(row + 0);
  const int off = __ldg(row + 4);
  float m;
  if (off >= 0) {
    m = mplane[off + v.cell];
  } else {  // k > 32: the minimum of the cell's (k/32)^2 base minima
    const int rr = v.k >> 5, wb = p.Wp >> 5;
    const int i = v.cell / v.wk, j = v.cell - i * v.wk;
    m = p.inf;
    for (int a = 0; a < rr; ++a)
      for (int b = 0; b < rr; ++b)
        m = fminf(m, mplane[p.base_off + (i * rr + a) * wb + j * rr + b]);
  }
  v.m = m;
  const float t1c = __int_as_float(__ldg(row + 6));
  const float thr = __int_as_float(__ldg(row + 7));
  const bool m_fin = isfinite(m) && m < p.inf;
  const float m_safe = fminf(m, p.m_clamp);
  const float m_star = fminf(fmaxf(m_safe - p.trunc, 0.f), p.max_ray);
  v.t1 = fminf(m_star, t1c);
  v.valid = m_fin && v.t1 > thr;
  return v;
}

// The sums over the CTA of each thread's a and b (every thread gets both):
// warp shuffles, then the 8 warps' partial sums through shared memory.
__device__ __forceinline__ void block_sum2(int& a, int& b) {
  __shared__ int sa[CARVE_THREADS / 32], sb[CARVE_THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0) {
    sa[threadIdx.x >> 5] = a;
    sb[threadIdx.x >> 5] = b;
  }
  __syncthreads();
  a = b = 0;
  for (int w = 0; w < CARVE_THREADS / 32; ++w) {
    a += sa[w];
    b += sb[w];
  }
}

__global__ void __launch_bounds__(CARVE_THREADS) carve_count_kernel(
    const int* __restrict__ table, const float* __restrict__ mplane,
    CarveParams p, int* __restrict__ counts) {
  const int base = blockIdx.x * CARVE_TILE + threadIdx.x;
  int n = 0, unused = 0;
#pragma unroll
  for (int r = 0; r < CARVE_ROWS; ++r) {
    const int s = base + r * CARVE_THREADS;
    n += s < p.total && slot_view(table, mplane, p, s).valid;
  }
  block_sum2(n, unused);
  if (threadIdx.x == 0) counts[blockIdx.x] = n;
}

__global__ void __launch_bounds__(CARVE_THREADS) carve_write_kernel(
    const int* __restrict__ table, const float* __restrict__ mplane,
    const int* __restrict__ lplane, const float* __restrict__ T_G_C,
    const int* __restrict__ counts, int n_blocks, CarveParams p,
    float* __restrict__ origin, float* __restrict__ point,
    float* __restrict__ start, float* __restrict__ end,
    float* __restrict__ weight, int* __restrict__ label,
    float* __restrict__ color, bool* __restrict__ valid,
    int* __restrict__ dropped) {
  __shared__ int warp_n[CARVE_ROWS][CARVE_THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int base = blockIdx.x * CARVE_TILE + t;
  // The CTA's slots and flags first, their loads all in flight.
  SlotView v[CARVE_ROWS];
  unsigned bits[CARVE_ROWS];
#pragma unroll
  for (int r = 0; r < CARVE_ROWS; ++r) {
    const int s = base + r * CARVE_THREADS;
    v[r].valid = false;
    if (s < p.total) v[r] = slot_view(table, mplane, p, s);
  }
#pragma unroll
  for (int r = 0; r < CARVE_ROWS; ++r) {
    bits[r] = __ballot_sync(0xffffffffu, v[r].valid);
    if (lane == 0) warp_n[r][warp] = __popc(bits[r]);
  }
  // Valid slots before the CTA's first (the counts of the CTAs before
  // it), and in all.
  int before = 0, n_valid = 0;
  for (int i = t; i < n_blocks; i += CARVE_THREADS) {
    const int c = counts[i];
    n_valid += c;
    if (i < (int)blockIdx.x) before += c;
  }
  block_sum2(before, n_valid);  // its __syncthreads also publishes warp_n
  if (blockIdx.x == 0 && t == 0) dropped[0] = max(n_valid - p.budget, 0);

  float Rm[9], o[3];
  for (int a = 0; a < 3; ++a) {
    for (int b = 0; b < 3; ++b) Rm[3 * a + b] = __ldg(T_G_C + 4 * a + b);
    o[a] = __ldg(T_G_C + 4 * a + 3);
  }
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < CARVE_ROWS; ++r) {
    int wpre = 0, row_n = 0;
    for (int w = 0; w < CARVE_THREADS / 32; ++w) {
      const int c = warp_n[r][w];
      if (w < warp) wpre += c;
      row_n += c;
    }
    const int s = base + r * CARVE_THREADS;
    const int vb = before + wpre + __popc(bits[r] & lower);  // valid before s
    before += row_n;
    const int pos = v[r].valid ? vb : n_valid + (s - vb);
    if (s >= p.total || pos >= p.out_n) continue;
    const SlotView& q = v[r];
    const int* row = table + q.chunk * CARVE_TABLE;
    const float t0 = __int_as_float(__ldg(row + 5));
    const int i = q.cell / q.wk, j = q.cell - i * q.wk;
    const int half = q.k >> 1;
    const float ur = (float)(j * q.k + half), vr = (float)(i * q.k + half);
    const float xr = (ur - p.cx) * p.ifx, yr = (vr - p.cy) * p.ify;
    const float nr = ray_norm(xr, yr);
    const float dx = xr / nr, dy = yr / nr, dz = 1.0f / nr;
    const float m_safe = fminf(q.m, p.m_clamp);
    float w = 1.0f;
    if (!p.use_const_weight) {
      const float zz = fmaxf(m_safe / nr, 1e-6f);
      w = 1.0f / (zz * zz);
    }
    int lab;
    const int off = __ldg(row + 4);
    if (off >= 0) {
      lab = lplane[off + q.cell];
    } else {
      const int rr = q.k >> 5, wb = p.Wp >> 5;
      lab = lplane[p.base_off + (i * rr + rr / 2) * wb + j * rr + rr / 2];
    }
    for (int a = 0; a < 3; ++a) {
      const float u = fma_as_plain(
          dz, Rm[3 * a + 2],
          fma_as_plain(dy, Rm[3 * a + 1], dx * Rm[3 * a]));
      origin[3 * pos + a] = o[a];
      point[3 * pos + a] = fma_as_plain(u, m_safe, o[a]);
      start[3 * pos + a] = fma_as_plain(u, t0, o[a]);
      end[3 * pos + a] = fma_as_plain(u, q.t1, o[a]);
      color[3 * pos + a] = 0.f;
    }
    weight[pos] = w;
    label[pos] = lab;
    valid[pos] = q.valid;
  }
}

extern "C" int ksd_carve_jobs(const float* depth, const int* labels,
                              const float* T_G_C, const int* table,
                              CarveParams p, float* mplane, int* lplane,
                              int* counts, float* origin, float* point,
                              float* start, float* end, float* weight,
                              int* label, float* color, bool* valid,
                              int* dropped, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 regions((p.Wp + 31) / 32, (p.Hp + 31) / 32);
  carve_reach_kernel<<<regions, CARVE_THREADS, 0, st>>>(depth, labels, p,
                                                        mplane, lplane);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int n_blocks = (p.total + CARVE_TILE - 1) / CARVE_TILE;
  carve_count_kernel<<<n_blocks, CARVE_THREADS, 0, st>>>(table, mplane, p,
                                                         counts);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  carve_write_kernel<<<n_blocks, CARVE_THREADS, 0, st>>>(
      table, mplane, lplane, T_G_C, counts, n_blocks, p, origin, point, start,
      end, weight, label, color, valid, dropped);
  return (int)cudaGetLastError();
}
