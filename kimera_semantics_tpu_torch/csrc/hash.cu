// H1 hash_lookup and H2 hash_insert: the block hash table's probe loops.
//
// Not TPU kernels: the JAX package runs these loops as jax.lax.while_loops
// inside its jitted programs (kimera_semantics_tpu/grid/hash.py lookup
// :72-101, insert :105-171), so a JAX frame is one device program. Here
// they are two kernels, so that no probe round waits on the host.
//
// The table is open addressing with linear probing: position
// mix(key) & (table_size - 1), then +1 per round, at most `rounds` (64)
// rounds. EMPTY_KEY (-1) ends a lookup's probe; TOMBSTONE_KEY (-2), a
// claim rolled back for capacity, does not, and an insert may claim it.
//
// H1, one thread per key, only reads the table. Bound: the latency of a
// chain of dependent 4-byte loads (one per probe round, most keys one or
// two) at N keys; bytes N * (4 + 4 + 4) plus the probed words.
//
// H2 runs in ONE CTA of 1024 threads, each taking keys j = tid + 1024 m:
// the claim-and-verify rounds need a barrier between the bid, the write
// and the read back, and __syncthreads is the only cheap one. Each round:
//   1. a pending key reads its position: placed if it holds its own key;
//      if the position is EMPTY or TOMBSTONE the key bids its batch index
//      j with atomicMax into bid[position] (all -1 between rounds);
//   2. barrier; the highest bidder writes its key;
//   3. barrier; a bidder reads its position back and wins if it holds its
//      key (duplicates of the winner's key win too), resetting the bid;
//   4. keys that lost, or met another key, step to the next position.
// The loop ends when no key is pending (__syncthreads_or) or after 64
// rounds. The largest batch index wins every contested position, which is
// the last-writer rule of XLA:CPU's and torch's CPU scatter, so the table
// equals the JAX package's on the CPU bit for bit and is the same from run
// to run. bid lives in shared memory when table_size * 4 bytes fits (up to
// 32768 entries, 128 KiB), else in global scratch that the wrapper fills
// with -1 (left all -1 again on exit).
// Phase 2, slot assignment, has no race: each thread counts the new
// entries (claimed, slot < 0) of its contiguous chunk of the table, a
// block-wide exclusive scan ranks them in table order (cumsum(is_new) - 1),
// entry r gets slot n_blocks + r below the capacity and writes its block
// coordinates, the rest roll back to TOMBSTONE; n_blocks and overflow (slot
// overflow plus keys still pending) are written to 0-d device tensors.
// Bound: latency. One SM does the whole insert; at the frame list's 512
// keys a round is a few dependent load/atomic/store steps between barriers.
#include "ksd_common.cuh"

struct HashInsertParams {
  int n, table_size, capacity, ext, max_probes, bid_in_smem;
};

namespace {

constexpr int kEmpty = -1;
constexpr int kTombstone = -2;
constexpr int kInsertThreads = 1024;
constexpr int kBidFlag = 1 << 30;  // marks a key that bid this round

// The JAX package's uint32 finalizer (grid/hash.py mix), without the final
// & 0x7FFFFFFF: every table mask is below 2^31, so it changes no position.
__device__ __forceinline__ unsigned mix_u32(int key) {
  unsigned h = (unsigned)key;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void hash_lookup_kernel(const int* __restrict__ table_keys,
                                   const int* __restrict__ table_slots,
                                   const int* __restrict__ keys, int n,
                                   int mask, int rounds,
                                   int* __restrict__ slots,
                                   bool* __restrict__ complete) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int key = keys[i];
  unsigned idx = mix_u32(key) & (unsigned)mask;
  int result = -1;
  bool done = false;
  for (int r = 0; r < rounds; ++r) {
    const int k = table_keys[idx];
    if (k == key) {
      result = table_slots[idx];
      done = true;
      break;
    }
    if (k == kEmpty) {
      done = true;
      break;
    }
    idx = (idx + 1) & (unsigned)mask;
  }
  slots[i] = result;
  if (!done && complete != nullptr) *complete = false;
}

// Block-wide exclusive scan of one int per thread (1024 threads); `total`
// receives the sum. `warp_sums` is 32 ints of shared memory.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[31];
  return before + x - v;
}

__global__ void __launch_bounds__(kInsertThreads)
hash_insert_kernel(int* __restrict__ table_keys, int* __restrict__ table_slots,
                   int* __restrict__ block_coords,
                   const int* __restrict__ n_blocks_in,
                   const int* __restrict__ keys,
                   const bool* __restrict__ active, int* __restrict__ state,
                   int* __restrict__ global_bid, HashInsertParams p,
                   int* __restrict__ n_blocks_out,
                   int* __restrict__ overflow_out) {
  extern __shared__ int smem_bid[];
  __shared__ int warp_sums[32];
  __shared__ int pending_count;
  const int tid = threadIdx.x;
  const unsigned mask = (unsigned)(p.table_size - 1);
  int* bid = p.bid_in_smem ? smem_bid : global_bid;
  if (p.bid_in_smem)
    for (int i = tid; i < p.table_size; i += kInsertThreads) bid[i] = -1;
  if (tid == 0) pending_count = 0;

  // state[j]: the key's position while it is pending (| kBidFlag while it
  // has bid this round), -1 once it is placed or if it is inactive. Each
  // entry is only ever touched by its own thread.
  bool any = false;
  for (int j = tid; j < p.n; j += kInsertThreads) {
    const int s = active[j] ? (int)(mix_u32(keys[j]) & mask) : -1;
    state[j] = s;
    any |= s >= 0;
  }

  // Phase 1: claim and verify, round by round.
  for (int round = 0; round < p.max_probes; ++round) {
    if (!__syncthreads_or(any)) break;
    for (int j = tid; j < p.n; j += kInsertThreads) {
      const int s = state[j];
      if (s < 0) continue;
      const int k = table_keys[s];
      if (k == keys[j]) {
        state[j] = -1;                       // already in the table
      } else if (k == kEmpty || k == kTombstone) {
        atomicMax(&bid[s], j);
        state[j] = s | kBidFlag;
      }
    }
    __syncthreads();
    for (int j = tid; j < p.n; j += kInsertThreads) {
      const int s = state[j];
      if (s >= 0 && (s & kBidFlag) && bid[s & ~kBidFlag] == j)
        table_keys[s & ~kBidFlag] = keys[j];
    }
    __syncthreads();
    any = false;
    for (int j = tid; j < p.n; j += kInsertThreads) {
      int s = state[j];
      if (s < 0) continue;
      if (s & kBidFlag) {
        s &= ~kBidFlag;
        if (table_keys[s] == keys[j]) {      // won (or a duplicate did)
          bid[s] = -1;
          state[j] = -1;
          continue;
        }
      }
      state[j] = (int)(((unsigned)s + 1) & mask);
      any = true;
    }
  }
  __syncthreads();
  int still = 0;
  for (int j = tid; j < p.n; j += kInsertThreads) still += state[j] >= 0;
  if (still) atomicAdd(&pending_count, still);

  // Phase 2: slots for the new entries, in table order.
  const int chunk = (p.table_size + kInsertThreads - 1) / kInsertThreads;
  const int lo = min(tid * chunk, p.table_size);
  const int hi = min(lo + chunk, p.table_size);
  int n_new = 0;
  for (int i = lo; i < hi; ++i) {
    const int k = table_keys[i];
    n_new += (k != kEmpty && k != kTombstone && table_slots[i] < 0);
  }
  int total;
  int rank = block_exclusive_scan(n_new, warp_sums, &total);
  const int nb = *n_blocks_in;
  for (int i = lo; i < hi; ++i) {
    const int k = table_keys[i];
    if (k == kEmpty || k == kTombstone || table_slots[i] >= 0) continue;
    const int slot = nb + rank++;
    if (slot < p.capacity) {
      table_slots[i] = slot;
      block_coords[3 * slot] = ((k >> 20) & 0x3FF) - p.ext;
      block_coords[3 * slot + 1] = ((k >> 10) & 0x3FF) - p.ext;
      block_coords[3 * slot + 2] = (k & 0x3FF) - p.ext;
    } else {
      table_keys[i] = kTombstone;
    }
  }
  if (tid == 0) {
    const int fit = max(0, min(total, p.capacity - nb));
    *n_blocks_out = nb + fit;
    *overflow_out = (total - fit) + pending_count;
  }
}

}  // namespace

extern "C" int ksd_hash_lookup(const int* table_keys, const int* table_slots,
                               const int* keys, int n, int table_size,
                               int rounds, int* slots, bool* complete,
                               void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  hash_lookup_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table_keys, table_slots, keys, n, table_size - 1, rounds, slots,
      complete);
  return (int)cudaGetLastError();
}

extern "C" int ksd_hash_insert(int* table_keys, int* table_slots,
                               int* block_coords, const int* n_blocks_in,
                               const int* keys, const bool* active,
                               int* state, int* global_bid,
                               HashInsertParams p, int* n_blocks_out,
                               int* overflow_out, void* stream) {
  const size_t smem = p.bid_in_smem ? (size_t)p.table_size * sizeof(int) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hash_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  hash_insert_kernel<<<1, kInsertThreads, smem, (cudaStream_t)stream>>>(
      table_keys, table_slots, block_coords, n_blocks_in, keys, active, state,
      global_bid, p, n_blocks_out, overflow_out);
  return (int)cudaGetLastError();
}
