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
// H1: a group of G = 16 lanes serves one key (16 measured faster than 4
// and 8 at 512 keys and at the camera cube's 4913 on the H100, PERF.md).
// Lane l of window w loads both table_keys and table_slots at
// (home + G w + l) & mask before it compares anything; a sub-warp ballot
// over "holds the key or EMPTY" picks the first such lane in probe order
// (only the first rounds - G w lanes of the last window count), and that
// lane's slot, or -1 at EMPTY, is the result. A group with no such lane
// moves to its next window; a key still unresolved after `rounds`
// positions reads -1 and clears `complete`. So a key costs two dependent
// round trips (its key, then one window) in place of one per probe.
// Bound: latency; bytes N * (4 + 4) plus the probed words.
//
// H2 runs in ONE CTA of 1024 threads: the claim-and-verify rounds need a
// barrier between the bids and the read back, and __syncthreads is the
// only cheap one. Two instances:
//
// The shared-table instance (hash_insert_kernel_smem; 128 <= table_size
// <= 32768, every table the port's configurations make: capacity 4096
// gives 8192 entries, 16376 and 16384 give 32768). One thread brings
// table_keys into dynamic shared memory with the TMA (cp.async.bulk on an
// mbarrier: 32 KiB at 8192 entries, 128 KiB at 32768), and table_slots
// beside it where both fit (up to 16384 entries), while every thread loads
// its keys and flags and copies its share of block_coords to the output. A
// thread keeps keys j = tid + NT m and their probe state in registers
// (instances for up to 1, 4 and 16 keys a thread of NT = 1024, so
// N <= 16384 covers insert_compacted's budget, the capacity; up to 512 keys,
// the frame list's, NT = 512 threads take one each: half the warps through
// every barrier and phase 2, measured faster at 512 keys); past
// that the state lives in shared memory after the table when it fits the
// 227 KiB a CTA may have (20000 keys at 32768 entries: 208 KiB), else in
// global scratch, and the keys are read again from global memory. A bid is
// a code in the key word itself, -3 - j, so the largest batch index has
// the smallest code and there is no bid array to clear. Each round:
//   A. a pending key reads its position: placed if it holds its own key;
//      if it holds EMPTY, TOMBSTONE or another key's code (a bid made this
//      round), the key bids with atomicMin(&T[s], -3 - j);
//   B. barrier; a bidder reads T[s]: its own code means it won, and it
//      writes its key there; the winner's key, or the winner's code c with
//      keys[-3 - c] equal to its own key, means a duplicate of its key won,
//      and it is placed too. The other bidders, and the keys that met
//      another key in A, step to (s + 1) & mask.
// A position that holds a code always gets its winner's key in the same
// round, so no code survives a round; the next round's __syncthreads_or is
// the barrier after B, so a round costs two barriers. The loop ends when
// no key is pending or after MAX_PROBES (64) rounds. The codes must not
// collide with an inserted key: every caller passes non-negative 30-bit
// packed keys as its active ones, masking the rest (ops/integrate.py:187
// `alloc_keys >= 0`, grid/hash.py:189 and :216 `uk != _TRASH_KEY` after
// the trash-padded unique pass, grid/blocks.py:135 `active & ok` with `ok`
// the in-bounds coordinates, tools/profile_scatter.py:239 `uk >= 0` and
// :245 `ks >= 0` through insert_compacted; tests/test_torch_hash.py
// test_active_keys_reaching_h2_are_non_negative holds each of them to it);
// an active key below -2 would be taken for a bid.
// Phase 2, slot assignment in table order: warp w walks its contiguous
// range of positions 128 at a time, lane l taking positions 4l..4l+3 as one
// int4 of keys and one of slots (from shared memory, or coalesced from
// global memory). An entry is new where its key is neither EMPTY nor
// TOMBSTONE and its slot is below 0, whoever claimed it: four ballots and
// __popc count the new entries of each warp, one scan over the warps
// gives each its base, and a second walk ranks entry e of lane l
// base + popc of the four ballots below lane l + the lane's new entries
// before e: cumsum(is_new) - 1 over the whole table. Entry r takes slot
// n_blocks + r below the capacity and writes its block coordinates; the
// rest roll back to TOMBSTONE. The walk writes the whole output
// table_keys and table_slots with 16-byte stores; block_coords is the
// input's rows, copied in the kernel (cheaper in device plus host time
// than a torch clone before it at capacity 16376, PERF.md), with the new
// rows in place. The inputs are not
// modified. n_blocks and overflow (slot overflow plus keys still pending)
// are written to 0-d device tensors. Bound: one SM. A round is a few
// dependent shared-memory accesses and two barriers for all the warps; the
// fixed part (the loads, phase 2, the outputs) moves the table through one
// SM's load and store units.
//
// The generic instance (hash_insert_kernel; tables above 32768 entries or
// below 128, or tensors off a 16-byte boundary) is the first design. It
// works in place on tables the wrapper has copied, bids the batch index
// with atomicMax into a bid array (in shared memory when `instance` is
// GENERIC_SMEM_BID, else in global scratch that the wrapper fills with -1
// and that is left all -1 again on exit), keeps the probe state in global
// scratch, and scans the table in contiguous per-thread chunks.
//
// Both instances give the largest batch index every contested position:
// the last-writer rule of XLA:CPU's and torch's CPU scatter, so the table
// equals the JAX package's on the CPU bit for bit and is the same from run
// to run (atomicMin over the codes and atomicMax over the indices do not
// depend on which thread arrives first; phase 2 has no race).
#include "ksd_common.cuh"

struct HashInsertParams {
  int n, table_size, capacity, ext, max_probes, instance;
};

namespace {

constexpr int kEmpty = -1;
constexpr int kTombstone = -2;
constexpr int kInsertThreads = 1024;
constexpr int kWarps = kInsertThreads / 32;
constexpr int kBidFlag = 1 << 30;  // marks a key that bid this round
constexpr unsigned kFull = 0xFFFFFFFFu;
// Dynamic shared memory the shared-table instance may ask for: the 227 KiB
// a CTA may opt into, less 1 KiB for its static variables.
constexpr size_t kSmemLimit = 227 * 1024 - 1024;
constexpr int kSharedMinEntries = 128, kSharedMaxEntries = 32768;
constexpr int kTmaChunk = 16384;  // bytes per cp.async.bulk of the table
constexpr int kLookupLanes = 16;  // H1's group: lanes (and probes) a key

enum { GENERIC_GLOBAL_BID = 0, GENERIC_SMEM_BID = 1, SHARED_TABLE = 2 };

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
                                   unsigned mask, int rounds,
                                   int* __restrict__ slots,
                                   bool* __restrict__ complete) {
  constexpr int G = kLookupLanes;
  const int i = (int)((blockIdx.x * blockDim.x + threadIdx.x) / G);
  const int sub = threadIdx.x & (G - 1);
  const int gbase = (threadIdx.x & 31) & ~(G - 1);
  const unsigned gmask = (1u << G) - 1u;
  const bool live = i < n;
  const int key = live ? __ldg(keys + i) : 0;
  const unsigned first_pos = mix_u32(key) + (unsigned)sub;
  bool pending = live;
  int result = -1;
  // Every lane of the warp runs every window (the ballot and the shuffle
  // need them all); `rounds` is the same for all, so the loop is uniform.
  for (int w = 0; w < rounds; w += G) {
    if (!__any_sync(kFull, pending)) break;
    const bool probe = pending && w + sub < rounds;
    int k = 0, s = -1;
    if (probe) {
      const unsigned pos = (first_pos + (unsigned)w) & mask;
      k = __ldg(table_keys + pos);
      s = __ldg(table_slots + pos);
    }
    const bool stop = probe && (k == key || k == kEmpty);
    const unsigned found = (__ballot_sync(kFull, stop) >> gbase) & gmask;
    const int at = found ? __ffs(found) - 1 : 0;
    const int got = __shfl_sync(kFull, k == key ? s : -1, gbase + at);
    if (found) {
      result = got;
      pending = false;
    }
  }
  if (live && sub == 0) {
    slots[i] = result;
    if (pending && complete != nullptr) *complete = false;
  }
}

// Block-wide exclusive scan of one int per thread over NW warps; `total`
// receives the sum. `warp_sums` is 32 ints of shared memory.
template <int NW = kWarps>
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NW ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < NW) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[NW - 1];
  return before + x - v;
}

// -- the shared-table instance -----------------------------------------------

// Pass A for key j (state st: its position, | kBidFlag once it has bid, -1
// once placed or inactive): placed if its position holds its own key, a bid
// (atomicMin of its code) if it holds EMPTY, TOMBSTONE or a code. T[s] may
// change under the read: other keys' atomicMin only ever turn EMPTY,
// TOMBSTONE or a code into a smaller code, all of which read as claimable,
// and never touch a position that holds a key.
__device__ __forceinline__ void claim_bid(int* T, int j, int key, int& st) {
  if (st < 0) return;
  const int k = *(volatile int*)(T + st);
  if (k == key) {
    st = -1;                           // already in the table
  } else if (k < 0) {                  // EMPTY, TOMBSTONE or a code
    atomicMin(T + st, -3 - j);
    st |= kBidFlag;
  }
}

// Pass B: a bidder that finds its own code at its position won it and
// writes its key there. A bidder that finds the winner's key, or the
// winner's code c (the winner has not written yet) with keys[-3 - c] equal
// to its own key, is placed: a duplicate of its key won. Every other
// pending key steps. Returns whether the key is still pending.
__device__ __forceinline__ bool claim_settle(int* T,
                                             const int* __restrict__ keys,
                                             int j, int key, int& st,
                                             unsigned mask) {
  if (st < 0) return false;
  if (st & kBidFlag) {
    st &= ~kBidFlag;
    const int v = *(volatile int*)(T + st);
    if (v == -3 - j) {
      T[st] = key;
      st = -1;
      return false;
    }
    if (v == key || (v <= -3 && __ldg(keys + (-3 - v)) == key)) {
      st = -1;
      return false;
    }
  }
  st = (int)(((unsigned)st + 1) & mask);
  return true;
}

__device__ __forceinline__ bool is_new(int k, int s) {
  return k != kEmpty && k != kTombstone && s < 0;
}

// Entry `r` of the new ones (in table order) takes slot nb + r below the
// capacity and writes its block coordinates, else rolls back to TOMBSTONE.
__device__ __forceinline__ void assign(int& k, int& s, bool fresh, int r,
                                       int nb, const HashInsertParams& p,
                                       int* __restrict__ bc_out) {
  if (!fresh) return;
  const int slot = nb + r;
  if (slot < p.capacity) {
    s = slot;
    bc_out[3 * slot] = ((k >> 20) & 0x3FF) - p.ext;
    bc_out[3 * slot + 1] = ((k >> 10) & 0x3FF) - p.ext;
    bc_out[3 * slot + 2] = (k & 0x3FF) - p.ext;
  } else {
    k = kTombstone;
  }
}

// NT threads; KPT keys a thread with their state in registers; KPT == 0:
// the state in shared memory after the table (state_in_smem) or in
// `state` (global), the keys read again from global memory. table_slots
// comes into shared memory after the table too where slots_in_smem
// (ksd_hash_insert's choice: when both fit).
template <int NT, int KPT>
__global__ void __launch_bounds__(NT)
hash_insert_kernel_smem(const int* __restrict__ tk_in,
                        const int* __restrict__ ts_in,
                        const int* __restrict__ bc_in,
                        const int* __restrict__ n_blocks_in,
                        const int* __restrict__ keys,
                        const bool* __restrict__ active,
                        int* __restrict__ state_global,
                        int* __restrict__ tk_out, int* __restrict__ ts_out,
                        int* __restrict__ bc_out, HashInsertParams p,
                        bool state_in_smem, bool slots_in_smem,
                        int* __restrict__ n_blocks_out,
                        int* __restrict__ overflow_out) {
  extern __shared__ __align__(128) int T[];
  __shared__ __align__(8) unsigned long long bar;
  constexpr int NW = NT / 32;
  __shared__ int warp_sums[32];
  __shared__ int pending_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned mask = (unsigned)(p.table_size - 1);
  const uint32_t bar_addr = smem_u32(&bar);
  int* S = state_in_smem ? T + p.table_size : state_global;
  int* TS = T + p.table_size;          // table_slots, where slots_in_smem

  // Load: the table (and the slots) by the TMA, while the threads take up
  // their keys and copy block_coords, every thread's loads issued before
  // any of them is used.
  if (tid == 0) {
    pending_count = 0;
    mbar_init(bar_addr, 1);
    mbar_fence_init();
    const int bytes = p.table_size * 4;
    mbar_expect_tx(bar_addr, (uint32_t)(slots_in_smem ? 2 * bytes : bytes));
    for (int off = 0; off < bytes; off += kTmaChunk) {
      const uint32_t len = (uint32_t)min(kTmaChunk, bytes - off);
      bulk_load(smem_u32(T) + off, (const char*)tk_in + off, len, bar_addr);
      if (slots_in_smem)
        bulk_load(smem_u32(TS) + off, (const char*)ts_in + off, len,
                  bar_addr);
    }
  }
  int key[KPT > 0 ? KPT : 1], st[KPT > 0 ? KPT : 1];
  bool act[KPT > 0 ? KPT : 1];
  if constexpr (KPT > 0) {
#pragma unroll
    for (int m = 0; m < KPT; ++m) {
      const int j = tid + m * NT;
      act[m] = j < p.n && active[j];
      key[m] = j < p.n ? __ldg(keys + j) : 0;
    }
  }
  {
    // block_coords to the output: U 16-byte words in flight a thread,
    // fewer where the keys take more registers.
    constexpr int U = KPT == 16 ? 2 : KPT == 4 ? 4 : 8;
    const int words = 3 * p.capacity, nv = words >> 2;
    const int4* src = reinterpret_cast<const int4*>(bc_in);
    int4* dst = reinterpret_cast<int4*>(bc_out);
    for (int v0 = tid; v0 < nv; v0 += U * NT) {
      int4 r[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (v0 + u * NT < nv)
          r[u] = __ldg(src + v0 + u * NT);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (v0 + u * NT < nv) dst[v0 + u * NT] = r[u];
    }
    for (int w = 4 * nv + tid; w < words; w += NT)
      bc_out[w] = __ldg(bc_in + w);
  }
  bool any = false;
  if constexpr (KPT > 0) {
#pragma unroll
    for (int m = 0; m < KPT; ++m) {
      st[m] = act[m] ? (int)(mix_u32(key[m]) & mask) : -1;
      any |= st[m] >= 0;
    }
  } else {
    for (int j = tid; j < p.n; j += NT) {
      const int s = active[j] ? (int)(mix_u32(__ldg(keys + j)) & mask) : -1;
      S[j] = s;
      any |= s >= 0;
    }
  }
  __syncthreads();  // the mbarrier's initialisation, seen by every thread
  mbar_wait(bar_addr, 0);

  // Phase 1: claim and verify, round by round (passes A and B above; the
  // barrier of a round's __syncthreads_or sees the last round's writes).
  for (int round = 0; round < p.max_probes; ++round) {
    if (!__syncthreads_or(any)) break;
    if constexpr (KPT > 0) {
#pragma unroll
      for (int m = 0; m < KPT; ++m)
        claim_bid(T, tid + m * NT, key[m], st[m]);
    } else {
      for (int j = tid; j < p.n; j += NT) {
        int s = S[j];
        if (s < 0) continue;
        claim_bid(T, j, __ldg(keys + j), s);
        S[j] = s;
      }
    }
    __syncthreads();
    any = false;
    if constexpr (KPT > 0) {
#pragma unroll
      for (int m = 0; m < KPT; ++m)
        any |= claim_settle(T, keys, tid + m * NT, key[m], st[m],
                            mask);
    } else {
      for (int j = tid; j < p.n; j += NT) {
        int s = S[j];
        if (s < 0) continue;
        any |= claim_settle(T, keys, j, __ldg(keys + j), s, mask);
        S[j] = s;
      }
    }
  }
  __syncthreads();  // the last round's writes, seen by phase 2
  int still = 0;
  if constexpr (KPT > 0) {
#pragma unroll
    for (int m = 0; m < KPT; ++m) still += st[m] >= 0;
  } else {
    for (int j = tid; j < p.n; j += NT) still += S[j] >= 0;
  }
  if (still) atomicAdd(&pending_count, still);

  // Phase 2: slots for the new entries, in table order. Warp w takes quads
  // (4 positions) [q_lo, q_hi), a multiple of 32 quads, 32 at a time.
  const int quads = p.table_size >> 2;
  const int per_warp = (quads + 32 * NW - 1) / (32 * NW) * 32;
  const int q_lo = min(warp * per_warp, quads);
  const int q_hi = min(q_lo + per_warp, quads);
  const int4* T4 = reinterpret_cast<const int4*>(T);
  const int4* S4 = reinterpret_cast<const int4*>(slots_in_smem ? TS : ts_in);
  const unsigned below = (1u << lane) - 1u;
  int n_new = 0;
  for (int q0 = q_lo; q0 < q_hi; q0 += 32) {
    const int q = q0 + lane;
    int4 k = make_int4(kEmpty, kEmpty, kEmpty, kEmpty), s = k;
    if (q < q_hi) {
      k = T4[q];
      s = S4[q];
    }
    n_new += __popc(__ballot_sync(kFull, is_new(k.x, s.x)))
             + __popc(__ballot_sync(kFull, is_new(k.y, s.y)))
             + __popc(__ballot_sync(kFull, is_new(k.z, s.z)))
             + __popc(__ballot_sync(kFull, is_new(k.w, s.w)));
  }
  int total;
  // n_new is the same on every lane of a warp: lane 0's share is the warp's.
  int rank = block_exclusive_scan<NW>(lane == 0 ? n_new : 0, warp_sums,
                                     &total);
  rank = __shfl_sync(kFull, rank, 0);
  const int nb = *n_blocks_in;
  int4* K4 = reinterpret_cast<int4*>(tk_out);
  int4* O4 = reinterpret_cast<int4*>(ts_out);
  for (int q0 = q_lo; q0 < q_hi; q0 += 32) {
    const int q = q0 + lane;
    int4 k = make_int4(kEmpty, kEmpty, kEmpty, kEmpty), s = k;
    if (q < q_hi) {
      k = T4[q];
      s = S4[q];
    }
    const bool n0 = is_new(k.x, s.x), n1 = is_new(k.y, s.y),
               n2 = is_new(k.z, s.z), n3 = is_new(k.w, s.w);
    const unsigned b0 = __ballot_sync(kFull, n0),
                   b1 = __ballot_sync(kFull, n1),
                   b2 = __ballot_sync(kFull, n2),
                   b3 = __ballot_sync(kFull, n3);
    int r = rank + __popc(b0 & below) + __popc(b1 & below)
            + __popc(b2 & below) + __popc(b3 & below);
    assign(k.x, s.x, n0, r, nb, p, bc_out);
    r += n0;
    assign(k.y, s.y, n1, r, nb, p, bc_out);
    r += n1;
    assign(k.z, s.z, n2, r, nb, p, bc_out);
    r += n2;
    assign(k.w, s.w, n3, r, nb, p, bc_out);
    if (q < q_hi) {
      K4[q] = k;
      O4[q] = s;
    }
    rank += __popc(b0) + __popc(b1) + __popc(b2) + __popc(b3);
  }
  if (tid == 0) {
    const int fit = max(0, min(total, p.capacity - nb));
    *n_blocks_out = nb + fit;
    *overflow_out = (total - fit) + pending_count;
  }
}

// -- the generic instance (the first design) ---------------------------------

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
  const bool bid_in_smem = p.instance == GENERIC_SMEM_BID;
  int* bid = bid_in_smem ? smem_bid : global_bid;
  if (bid_in_smem)
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int NT, int KPT>
int launch_insert_smem(const int* tk_in, const int* ts_in, const int* bc_in,
                       const int* n_blocks_in, const int* keys,
                       const bool* active, int* state, int* tk_out,
                       int* ts_out, int* bc_out, HashInsertParams p,
                       bool state_in_smem, bool slots_in_smem,
                       int* n_blocks_out, int* overflow_out, size_t smem,
                       cudaStream_t stream) {
  const cudaError_t e = allow_smem(hash_insert_kernel_smem<NT, KPT>, smem);
  if (e != cudaSuccess) return (int)e;
  hash_insert_kernel_smem<NT, KPT><<<1, NT, smem, stream>>>(
      tk_in, ts_in, bc_in, n_blocks_in, keys, active, state, tk_out, ts_out,
      bc_out, p, state_in_smem, slots_in_smem, n_blocks_out, overflow_out);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

}  // namespace

extern "C" int ksd_hash_lookup(const int* table_keys, const int* table_slots,
                               const int* keys, int n, int table_size,
                               int rounds, int* slots, bool* complete,
                               void* stream) {
  const int threads = 256;
  const int blocks =
      (int)(((long long)n * kLookupLanes + threads - 1) / threads);
  hash_lookup_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table_keys, table_slots, keys, n, (unsigned)(table_size - 1), rounds,
      slots, complete);
  return (int)cudaGetLastError();
}

// The shared-table instance reads the *_in tensors and writes the *_out
// ones, and needs `state` (n ints) past 16 keys a thread where the probe
// state does not fit in shared memory after the table; the generic
// instances work in place on the *_out tensors, which the caller has
// filled with the input, and need `state` and, for GENERIC_GLOBAL_BID,
// `global_bid` (table_size ints, all -1). A launch that does not fit (the
// table's size or alignment, the shared memory, a missing scratch) is
// refused with cudaErrorInvalidValue and not run.
extern "C" int ksd_hash_insert(const int* tk_in, const int* ts_in,
                               const int* bc_in, const int* n_blocks_in,
                               const int* keys, const bool* active,
                               int* state, int* global_bid, int* tk_out,
                               int* ts_out, int* bc_out, HashInsertParams p,
                               int* n_blocks_out, int* overflow_out,
                               void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (p.instance != SHARED_TABLE) {
    const size_t smem = p.instance == GENERIC_SMEM_BID
                            ? (size_t)p.table_size * sizeof(int) : 0;
    if (smem > kSmemLimit || state == nullptr
        || (p.instance == GENERIC_GLOBAL_BID && global_bid == nullptr))
      return (int)cudaErrorInvalidValue;
    const cudaError_t e = allow_smem(hash_insert_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    hash_insert_kernel<<<1, kInsertThreads, smem, s>>>(
        tk_out, ts_out, bc_out, n_blocks_in, keys, active, state, global_bid,
        p, n_blocks_out, overflow_out);
    return (int)cudaGetLastError();
  }
  const int kpt = p.n <= kInsertThreads ? 1
                  : p.n <= 4 * kInsertThreads ? 4
                  : p.n <= 16 * kInsertThreads ? 16 : 0;
  const size_t table_bytes = (size_t)p.table_size * sizeof(int);
  // Past 16 keys a thread the probe state goes after the table where it
  // fits; table_slots goes beside the table where both fit (up to 16384
  // entries) and the state does not take the room.
  const bool state_in_smem =
      kpt == 0 && table_bytes + (size_t)p.n * sizeof(int) <= kSmemLimit;
  const bool slots_in_smem = !state_in_smem && 2 * table_bytes <= kSmemLimit;
  const size_t smem = table_bytes * (slots_in_smem ? 2 : 1)
                      + (state_in_smem ? (size_t)p.n * sizeof(int) : 0);
  if (p.table_size < kSharedMinEntries || p.table_size > kSharedMaxEntries
      || smem > kSmemLimit || (kpt == 0 && !state_in_smem && !state)
      || !aligned16(tk_in) || !aligned16(ts_in) || !aligned16(bc_in)
      || !aligned16(tk_out) || !aligned16(ts_out) || !aligned16(bc_out))
    return (int)cudaErrorInvalidValue;
#define KSD_LAUNCH(NT, KPT)                                                  \
  launch_insert_smem<NT, KPT>(tk_in, ts_in, bc_in, n_blocks_in, keys, active, \
                              state, tk_out, ts_out, bc_out, p,              \
                              state_in_smem, slots_in_smem, n_blocks_out,    \
                              overflow_out, smem, s)
  // Up to 512 keys, 512 threads: half the warps through every barrier and
  // phase 2's walk, which measured faster at the frame list's 512 keys.
  if (p.n <= kInsertThreads / 2) return KSD_LAUNCH(kInsertThreads / 2, 1);
  switch (kpt) {
    case 1: return KSD_LAUNCH(kInsertThreads, 1);
    case 4: return KSD_LAUNCH(kInsertThreads, 4);
    case 16: return KSD_LAUNCH(kInsertThreads, 16);
    default: return KSD_LAUNCH(kInsertThreads, 0);
  }
#undef KSD_LAUNCH
}
