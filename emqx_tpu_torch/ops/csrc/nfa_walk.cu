// nfa_walk.cu — the fused hash-backend NFA walk for Hopper (sm_90a).
//
// Replaces: emqx_tpu/ops/pallas_match.py `_kernel` (with `_walk_tile` and
// `_hash`), the Pallas kernel that fuses the whole (D+1)-step walk of
// `match_kernel.nfa_walk` over the cuckoo edge table.  Two kernels, one
// walk: nfa_walk_kernel writes the raw accept-slot layout of
// `nfa_match(compact_output=False)`, bit for bit: acc (B, C) int32 with
// C = sum_t 2*w_t (w_0 = 1, w_{t+1} = min(2*w_t, A)), and aover (B,)
// int32, the per-row active-set spill.  nfa_walk_flat_kernel writes the
// flat mode of `nfa_match(flat_cap=cap)` in the same launch (K3, the
// reference's XLA `match_kernel.flat_epilogue`, fused; walk_common.cuh).
//
// The walk itself is nfa::walk_rows (walk_common.cuh); this file holds
// the lookup: for t < min(D, len), the literal edge of a valid slot comes
// from two cuckoo probes (32 B bucket rows of 2 [state, word, next, 0]
// slots, the max over matching slots).
//
// What bounds it on the H100: a chain of dependent loads per step.  A
// slot's node row (16 B) and its two bucket rows (2 x 32 B, two int4
// each) are independent loads, issued together once the slot's state is
// known, so a step is one round trip to L2 or device memory plus the
// frontier exchange (shuffles and a shared-memory scatter); the walk is
// D + 1 such rounds back to back.  The bytes bound stays far off: a
// round moves 80 B per valid slot, a frontier holds only a few valid
// slots (about 20 lookups a row over a served walk at D = 16), and each
// load is its own 32 B sector of a table larger than the 50 MB L2, so
// the card's bandwidth idles while each round waits on its latency.  Design: one
// lane per frontier slot (walk_common.cuh), the tables read with 16 B
// read-only loads, invalid slots skip their loads.

#include "walk_common.cuh"

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

__global__ void __launch_bounds__(NFA_THREADS)
nfa_walk_kernel(const int* __restrict__ words, const int* __restrict__ lens,
                const uint8_t* __restrict__ is_sys,
                const int4* __restrict__ node_tab,
                const int4* __restrict__ edge_tab,
                const int* __restrict__ seeds, int B, int D, int A,
                uint32_t mask, int C, int* __restrict__ acc,
                int* __restrict__ aover) {
  __shared__ int scratch[NFA_THREADS];
  const CuckooLookup lookup{edge_tab, (uint32_t)__ldg(seeds),
                            (uint32_t)__ldg(seeds + 1), mask};
  nfa::RawOut out{acc, aover, C};
  nfa::walk_rows(words, lens, is_sys, node_tab, B, D, A, blockIdx.x,
                 scratch, lookup, out);
}

__global__ void __launch_bounds__(NFA_THREADS)
nfa_walk_flat_kernel(const int* __restrict__ words,
                     const int* __restrict__ lens,
                     const uint8_t* __restrict__ is_sys,
                     const int4* __restrict__ node_tab,
                     const int4* __restrict__ edge_tab,
                     const int* __restrict__ seeds, int B, int D, int A,
                     uint32_t mask, nfa::FlatArgs fa) {
  __shared__ int scratch[NFA_THREADS];
  __shared__ nfa::FlatShared sh;
  extern __shared__ int flat_list[];
  const int tile = nfa::flat_ticket(fa, sh);
  const CuckooLookup lookup{edge_tab, (uint32_t)__ldg(seeds),
                            (uint32_t)__ldg(seeds + 1), mask};
  nfa::FlatOut out{fa.K, flat_list + (size_t)(threadIdx.x /
                                              nfa::lanes_per_row(A)) * fa.K};
  nfa::walk_rows(words, lens, is_sys, node_tab, B, D, A, tile, scratch,
                 lookup, out);
  nfa::flat_finish(fa, sh, tile, B, A, out);
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
  nfa_walk_kernel<<<nfa::walk_blocks(B, A), NFA_THREADS, 0,
                    (cudaStream_t)stream>>>(
      words, lens, is_sys, reinterpret_cast<const int4*>(node_tab),
      reinterpret_cast<const int4*>(edge_tab), seeds, B, D, A,
      (uint32_t)(Hb - 1), C, acc, aover);
  return (int)cudaGetLastError();
}

// The flat mode: the walk's operands as above, then K, cap, the outputs
// matches (cap,) 16-byte aligned, n, aover, mover, row_meta (B,), and the
// stream's state buffer (1 + walk_blocks(B, A) words) with the ticket
// counter's value at the launch and the launch's epoch.
extern "C" int nfa_walk_flat_launch(
    const int* words, const int* lens, const uint8_t* is_sys,
    const int* node_tab, const int* edge_tab, const int* seeds, int B, int D,
    int A, int Hb, int K, int cap, int* matches, int* nout, int* aover,
    int* mover, int* row_meta, unsigned long long* state,
    unsigned ticket_base, unsigned epoch, void* stream) {
  if (B <= 0 || D <= 0 || A < 1 || A > NFA_MAX_A || Hb <= 0 ||
      (Hb & (Hb - 1)) != 0 || K < 0 || cap <= 0 ||
      (long long)B * K > (long long)NFA_TILE_VALUE)
    return (int)cudaErrorInvalidValue;
  const size_t smem = nfa::flat_list_bytes(A, K);
  const int e = nfa::flat_smem_optin(
      nfa_walk_flat_kernel, smem,
      sizeof(int) * NFA_THREADS + sizeof(nfa::FlatShared));
  if (e != 0) return e;
  const nfa::FlatArgs fa{K,         cap,      matches, nout,
                         aover,     mover,    row_meta, state,
                         ticket_base, epoch};
  nfa_walk_flat_kernel<<<nfa::walk_blocks(B, A), NFA_THREADS, smem,
                         (cudaStream_t)stream>>>(
      words, lens, is_sys, reinterpret_cast<const int4*>(node_tab),
      reinterpret_cast<const int4*>(edge_tab), seeds, B, D, A,
      (uint32_t)(Hb - 1), fa);
  return (int)cudaGetLastError();
}
