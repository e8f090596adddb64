// nfa_join_walk.cu — the join-backend NFA walk for Hopper (sm_90a).
//
// Replaces: emqx_tpu/ops/pallas_match.py `_join_kernel`, the Pallas
// kernel that runs the whole (D+1)-step walk with the literal edge found
// in a sorted relation (join_match._join_edge_lookup) instead of a cuckoo
// table.  It serves both `join` and `join-pallas`.  The walk and the
// output layout are nfa::walk_row (walk_common.cuh), shared with
// nfa_walk.cu; this file holds the lookup of a valid state s on word w:
//
//   1. the CSR bounds lo = state_start[s], hi0 = state_start[s+1];
//   2. a lower bound of w over edge_word[lo, hi0); a hit
//      (lo < hi0 and edge_word[lo] == w) gives edge_next[lo], which is
//      -1 for a tombstone;
//   3. a lower bound of (s, w) over the overlay rows [state, word, next],
//      sorted by (state, word) with INT32_MAX sentinel rows at the end;
//   4. the max of the two answers.
//
// Every compare is signed int32, as in the reference.  The reference
// unrolls E.bit_length() masked halvings; the loop here stops when
// lo == hi, where the unrolled form stops moving, so it lands on the same
// lo.  The value at the final lo is the last probe that moved hi (the
// last mid with edge_word[mid] >= w), so the hit test needs no extra
// load.  Rows past state_start[S] are padding and lie in no segment.
//
// What bounds it on the H100: per valid slot and step, a 16 B node row,
// an 8 B pair of CSR bounds and a chain of about log2(segment) dependent
// 4 B edge_word loads, then a 4 B edge_next load on a hit, all random
// reads from tables (node table + relation about 75 MB at 1M filters)
// larger than the 50 MB L2.  So each slot waits on a chain of dependent
// loads: the kernel is latency bound, further from its bytes bound than
// the hash walk, whose two probes are independent.  Design: one thread
// per topic row, as in nfa_walk.cu; the 3 KB overlay is staged in shared
// memory once per block, so its search touches no device memory; invalid
// slots load nothing.  A warp per row, or a thread per (row, slot), would
// put more of the chains in flight.

#include "walk_common.cuh"

#define JOIN_BLOCK 32
#define JOIN_OVERLAY_CAP 256  // join_match.OVERLAY_CAP

namespace {

struct JoinLookup {
  const int* state_start;
  const int* edge_word;
  const int* edge_next;
  const int* o_state;  // the overlay, in shared memory
  const int* o_word;
  const int* o_next;

  __device__ __forceinline__ int operator()(int s, int word) const {
    int lo = __ldg(state_start + s);
    const int hi0 = __ldg(state_start + s + 1);
    int hi = hi0;
    int at_lo = 0;  // edge_word at the final lo, when lo < hi0
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int wm = __ldg(edge_word + mid);
      if (wm < word) {
        lo = mid + 1;
      } else {
        hi = mid;
        at_lo = wm;
      }
    }
    const int nxt = (lo < hi0 && at_lo == word) ? __ldg(edge_next + lo) : -1;

    int olo = 0, ohi = JOIN_OVERLAY_CAP;
    while (olo < ohi) {
      const int mid = (olo + ohi) >> 1;
      const int ms = o_state[mid];
      if (ms < s || (ms == s && o_word[mid] < word))
        olo = mid + 1;
      else
        ohi = mid;
    }
    const int nxt_o = (olo < JOIN_OVERLAY_CAP && o_state[olo] == s &&
                       o_word[olo] == word)
                          ? o_next[olo]
                          : -1;
    return max(nxt, nxt_o);
  }
};

__global__ void __launch_bounds__(JOIN_BLOCK)
nfa_join_walk_kernel(const int* __restrict__ words,
                     const int* __restrict__ lens,
                     const uint8_t* __restrict__ is_sys,
                     const int4* __restrict__ node_tab,
                     const int* __restrict__ state_start,
                     const int* __restrict__ edge_word,
                     const int* __restrict__ edge_next,
                     const int* __restrict__ overlay, int B, int D, int A,
                     int C, int* __restrict__ acc, int* __restrict__ aover) {
  __shared__ int o_state[JOIN_OVERLAY_CAP];
  __shared__ int o_word[JOIN_OVERLAY_CAP];
  __shared__ int o_next[JOIN_OVERLAY_CAP];
  for (int i = threadIdx.x; i < JOIN_OVERLAY_CAP; i += blockDim.x) {
    o_state[i] = __ldg(overlay + 3 * i);
    o_word[i] = __ldg(overlay + 3 * i + 1);
    o_next[i] = __ldg(overlay + 3 * i + 2);
  }
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  const JoinLookup lookup{state_start, edge_word, edge_next,
                          o_state,     o_word,    o_next};
  nfa::walk_row(r, words, lens, is_sys, node_tab, D, A, C, acc, aover,
                lookup);
}

}  // namespace

// C interface for ctypes.  Pointers are device pointers; `overlay` holds
// JOIN_OVERLAY_CAP rows of 3 int32; `S` is the node table's row count
// (state_start holds S+1 offsets) and `E` the relation's row count;
// `stream` is a cudaStream_t.  Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int nfa_join_walk_launch(
    const int* words, const int* lens, const uint8_t* is_sys,
    const int* node_tab, const int* state_start, const int* edge_word,
    const int* edge_next, const int* overlay, int B, int D, int A, int S,
    int E, int C, int* acc, int* aover, void* stream) {
  if (B <= 0 || D <= 0 || A < 1 || A > NFA_MAX_A || S <= 0 || E <= 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + JOIN_BLOCK - 1) / JOIN_BLOCK;
  nfa_join_walk_kernel<<<blocks, JOIN_BLOCK, 0, (cudaStream_t)stream>>>(
      words, lens, is_sys, reinterpret_cast<const int4*>(node_tab),
      state_start, edge_word, edge_next, overlay, B, D, A, C, acc, aover);
  return (int)cudaGetLastError();
}
