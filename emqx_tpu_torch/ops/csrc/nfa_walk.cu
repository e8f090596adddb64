// nfa_walk.cu — the fused hash-backend NFA walk for Hopper (sm_90a).
//
// Replaces: emqx_tpu/ops/pallas_match.py `_kernel` (with `_walk_tile` and
// `_hash`), the Pallas kernel that fuses the whole (D+1)-step walk of
// `match_kernel.nfa_walk` over the cuckoo edge table.  Output is the raw
// accept-slot layout of `nfa_match(compact_output=False)`, bit for bit:
// acc (B, C) int32 with C = sum_t 2*w_t (w_0 = 1, w_{t+1} = min(2*w_t, A)),
// and aover (B,) int32, the per-row active-set spill.
//
// The walk itself is nfa::walk_row (walk_common.cuh); this file holds
// the lookup: for t < min(D, len), the literal edge of a valid slot comes
// from two cuckoo probes (32 B bucket rows of 2 [state, word, next, 0]
// slots, the max over matching slots).
//
// What bounds it on the H100: the random 16 B node-row and 2 x 32 B
// bucket-row gathers, one set per valid slot and step, each a separate
// 32 B sector from tables (about 100 MB at 1M filters) larger than the
// 50 MB L2.  The arithmetic (a uint32 hash, compares, a sort of at most
// 2A ints) is small beside that.  Design: one thread per topic row, the
// tables read with 16 B read-only loads (a node row is one int4, a
// bucket two), invalid slots skip their loads, and the row's active set
// and candidates live in thread-local arrays.  At B = 2048 that is only
// 2048 threads for 132 SMs, so the walk is latency bound with few loads
// in flight; blocks of 32 threads spread the rows over as many SMs as
// possible.  A warp per row (or a thread per row and slot) would put
// more gathers in flight.

#include "walk_common.cuh"

#define NFA_BLOCK 32

namespace {

__device__ __forceinline__ uint32_t bucket_hash(uint32_t state, uint32_t word,
                                                uint32_t seed) {
  uint32_t h = state * 2654435761u + word * 2246822519u + seed;
  h ^= h >> 16;
  h *= 3266489917u;
  h ^= h >> 13;
  return h;
}

// One bucket row: 2 slots of [state, word, next, 0] = two int4.
__device__ __forceinline__ int probe(const int4* __restrict__ edge,
                                     uint32_t b, int s, int word) {
  const int4 a = __ldg(edge + 2 * (size_t)b);
  const int4 c = __ldg(edge + 2 * (size_t)b + 1);
  int best = -1;
  if (a.x == s && a.y == word) best = max(best, a.z);
  if (c.x == s && c.y == word) best = max(best, c.z);
  return best;
}

struct CuckooLookup {
  const int4* edge;
  uint32_t seed0, seed1, mask;
  __device__ __forceinline__ int operator()(int s, int word) const {
    return max(probe(edge, bucket_hash(s, word, seed0) & mask, s, word),
               probe(edge, bucket_hash(s, word, seed1) & mask, s, word));
  }
};

__global__ void __launch_bounds__(NFA_BLOCK)
nfa_walk_kernel(const int* __restrict__ words, const int* __restrict__ lens,
                const uint8_t* __restrict__ is_sys,
                const int4* __restrict__ node_tab,
                const int4* __restrict__ edge_tab,
                const int* __restrict__ seeds, int B, int D, int A,
                uint32_t mask, int C, int* __restrict__ acc,
                int* __restrict__ aover) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  const CuckooLookup lookup{edge_tab, (uint32_t)seeds[0], (uint32_t)seeds[1],
                            mask};
  nfa::walk_row(r, words, lens, is_sys, node_tab, D, A, C, acc, aover,
                lookup);
}

}  // namespace

// C interface for ctypes.  Pointers are device pointers; `stream` is a
// cudaStream_t.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int nfa_walk_launch(const int* words, const int* lens,
                               const uint8_t* is_sys, const int* node_tab,
                               const int* edge_tab, const int* seeds, int B,
                               int D, int A, int Hb, int C, int* acc,
                               int* aover, void* stream) {
  if (B <= 0 || D <= 0 || A < 1 || A > NFA_MAX_A || Hb <= 0 ||
      (Hb & (Hb - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + NFA_BLOCK - 1) / NFA_BLOCK;
  nfa_walk_kernel<<<blocks, NFA_BLOCK, 0, (cudaStream_t)stream>>>(
      words, lens, is_sys, reinterpret_cast<const int4*>(node_tab),
      reinterpret_cast<const int4*>(edge_tab), seeds, B, D, A,
      (uint32_t)(Hb - 1), C, acc, aover);
  return (int)cudaGetLastError();
}
