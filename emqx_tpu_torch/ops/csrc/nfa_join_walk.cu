// nfa_join_walk.cu — the join-backend NFA walk for Hopper (sm_90a).
//
// Replaces: emqx_tpu/ops/pallas_match.py `_join_kernel`, the Pallas
// kernel that runs the whole (D+1)-step walk with the literal edge found
// in a sorted relation (join_match._join_edge_lookup) instead of a cuckoo
// table.  It serves both `join` and `join-pallas`.  The walk and the
// output layouts are nfa::walk_rows (walk_common.cuh), shared with
// nfa_walk.cu: nfa_join_walk_kernel writes the raw accept slots,
// nfa_join_walk_flat_kernel the flat mode in the same launch (K3, the
// reference's XLA `match_kernel.flat_epilogue`, fused).  This file holds
// the lookup of a valid state s on word w:
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
// unrolls E.bit_length() masked halvings, which land on the lower bound
// of w in the sorted segment.  Here the halvings run only while more
// than JOIN_TAIL rows remain; the rest, edge_word[lo, hi), are read as
// independent loads and the lower bound is lo + (count of them < w).
// The hit test needs no extra load: it is either one of those rows or,
// when all are < w, the row at hi, read by the last probe that moved hi.
// Rows past state_start[S] are padding and lie in no segment.  The
// overlay's sentinel rows never match (no state is INT32_MAX), so the
// block counts the live rows while it stages the overlay into shared
// memory and searches only those, and not at all when there are none.
//
// What bounds it on the H100: a chain of dependent loads per step.  Per
// valid slot the 16 B node row goes out with the 8 B CSR pair; then one
// edge_word probe per halving of a segment wider than JOIN_TAIL rows
// (none for most states; a search run to the end reads 4.3 a lookup on
// the served 1M-filter table), one round of at most JOIN_TAIL independent 4 B loads,
// and the 4 B edge_next of a hit: three dependent round trips for a
// narrow segment, one more per halving of a wide one such as the root's.
// The lanes of a row run their chains side by side (walk_common.cuh), so
// a step costs the longest chain among its slots.  The bytes bound stays
// far off: a lookup moves a few tens of bytes in 4-8 B pieces, each its
// own 32 B sector of tables (node table + relation about 75 MB at 1M
// filters) larger than the 50 MB L2, so the card's bandwidth idles while
// each round waits on its latency.  The overlay's search touches only
// shared memory.

#include "walk_common.cuh"

#define JOIN_OVERLAY_CAP 256  // join_match.OVERLAY_CAP
#define JOIN_TAIL 8           // CSR rows read in one round at the end

static_assert(JOIN_OVERLAY_CAP % NFA_THREADS == 0,
              "the overlay is staged in whole rounds of the block");

namespace {

struct JoinLookup {
  const int* state_start;
  const int* edge_word;
  const int* edge_next;
  const int* o_state;  // the overlay, in shared memory
  const int* o_word;
  const int* o_next;
  int n_live;  // live overlay rows, a sorted prefix

  __device__ __forceinline__ int operator()(int s, int word) const {
    int lo = __ldg(state_start + s);
    const int hi0 = __ldg(state_start + s + 1);
    int hi = hi0;
    int at_hi = 0;  // edge_word[hi] once a probe has moved hi
    while (hi - lo > JOIN_TAIL) {
      const int mid = (lo + hi) >> 1;
      const int wm = __ldg(edge_word + mid);
      if (wm < word) {
        lo = mid + 1;
      } else {
        hi = mid;
        at_hi = wm;
      }
    }
    const int n = hi - lo;
    int tail[JOIN_TAIL];
#pragma unroll
    for (int k = 0; k < JOIN_TAIL; ++k)
      tail[k] = k < n ? __ldg(edge_word + lo + k) : 0;
    int below = 0;
    bool found = false;
#pragma unroll
    for (int k = 0; k < JOIN_TAIL; ++k) {
      below += k < n && tail[k] < word;
      found |= k < n && tail[k] == word;
    }
    const bool hit = found || (below == n && hi < hi0 && at_hi == word);
    const int nxt = hit ? __ldg(edge_next + lo + below) : -1;

    int nxt_o = -1;
    if (n_live > 0) {
      int olo = 0, ohi = n_live;
      while (olo < ohi) {
        const int mid = (olo + ohi) >> 1;
        const int ms = o_state[mid];
        if (ms < s || (ms == s && o_word[mid] < word))
          olo = mid + 1;
        else
          ohi = mid;
      }
      if (olo < n_live && o_state[olo] == s && o_word[olo] == word)
        nxt_o = o_next[olo];
    }
    return max(nxt, nxt_o);
  }
};

// Stages the overlay's JOIN_OVERLAY_CAP rows into shared memory; returns
// its live rows.  Every thread of the block calls it.
__device__ __forceinline__ int stage_overlay(const int* __restrict__ overlay,
                                             int* o_state, int* o_word,
                                             int* o_next) {
  int n_live = 0;
  for (int i0 = 0; i0 < JOIN_OVERLAY_CAP; i0 += NFA_THREADS) {
    const int i = i0 + threadIdx.x;
    const int st = __ldg(overlay + 3 * i);
    o_state[i] = st;
    o_word[i] = __ldg(overlay + 3 * i + 1);
    o_next[i] = __ldg(overlay + 3 * i + 2);
    n_live += __syncthreads_count(st != INT32_MAX);
  }
  return n_live;
}

__global__ void __launch_bounds__(NFA_THREADS)
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
  __shared__ int scratch[NFA_THREADS];
  const int n_live = stage_overlay(overlay, o_state, o_word, o_next);
  const JoinLookup lookup{state_start, edge_word, edge_next, o_state,
                          o_word,      o_next,    n_live};
  nfa::RawOut out{acc, aover, C};
  nfa::walk_rows(words, lens, is_sys, node_tab, B, D, A, blockIdx.x,
                 scratch, lookup, out);
}

__global__ void __launch_bounds__(NFA_THREADS)
nfa_join_walk_flat_kernel(const int* __restrict__ words,
                          const int* __restrict__ lens,
                          const uint8_t* __restrict__ is_sys,
                          const int4* __restrict__ node_tab,
                          const int* __restrict__ state_start,
                          const int* __restrict__ edge_word,
                          const int* __restrict__ edge_next,
                          const int* __restrict__ overlay, int B, int D,
                          int A, nfa::FlatArgs fa) {
  __shared__ int o_state[JOIN_OVERLAY_CAP];
  __shared__ int o_word[JOIN_OVERLAY_CAP];
  __shared__ int o_next[JOIN_OVERLAY_CAP];
  __shared__ int scratch[NFA_THREADS];
  __shared__ nfa::FlatShared sh;
  extern __shared__ int flat_list[];
  const int tile = nfa::flat_ticket(fa, sh);
  const int n_live = stage_overlay(overlay, o_state, o_word, o_next);
  const JoinLookup lookup{state_start, edge_word, edge_next, o_state,
                          o_word,      o_next,    n_live};
  nfa::FlatOut out{fa.K, flat_list + (size_t)(threadIdx.x /
                                              nfa::lanes_per_row(A)) * fa.K};
  nfa::walk_rows(words, lens, is_sys, node_tab, B, D, A, tile, scratch,
                 lookup, out);
  nfa::flat_finish(fa, sh, tile, B, A, out);
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
  nfa_join_walk_kernel<<<nfa::walk_blocks(B, A), NFA_THREADS, 0,
                         (cudaStream_t)stream>>>(
      words, lens, is_sys, reinterpret_cast<const int4*>(node_tab),
      state_start, edge_word, edge_next, overlay, B, D, A, C, acc, aover);
  return (int)cudaGetLastError();
}

// The flat mode: the walk's operands as above, then K, cap, the outputs
// and the stream's state as in nfa_walk.cu's nfa_walk_flat_launch.
extern "C" int nfa_join_walk_flat_launch(
    const int* words, const int* lens, const uint8_t* is_sys,
    const int* node_tab, const int* state_start, const int* edge_word,
    const int* edge_next, const int* overlay, int B, int D, int A, int S,
    int E, int K, int cap, int* matches, int* nout, int* aover, int* mover,
    int* row_meta, unsigned long long* state, unsigned ticket_base,
    unsigned epoch, void* stream) {
  if (B <= 0 || D <= 0 || A < 1 || A > NFA_MAX_A || S <= 0 || E <= 0 ||
      K < 0 || cap <= 0 || (long long)B * K > (long long)NFA_TILE_VALUE)
    return (int)cudaErrorInvalidValue;
  const size_t smem = nfa::flat_list_bytes(A, K);
  const int e = nfa::flat_smem_optin(
      nfa_join_walk_flat_kernel, smem,
      sizeof(int) * (3 * JOIN_OVERLAY_CAP + NFA_THREADS) +
          sizeof(nfa::FlatShared));
  if (e != 0) return e;
  const nfa::FlatArgs fa{K,         cap,      matches, nout,
                         aover,     mover,    row_meta, state,
                         ticket_base, epoch};
  nfa_join_walk_flat_kernel<<<nfa::walk_blocks(B, A), NFA_THREADS, smem,
                              (cudaStream_t)stream>>>(
      words, lens, is_sys, reinterpret_cast<const int4*>(node_tab),
      state_start, edge_word, edge_next, overlay, B, D, A, fa);
  return (int)cudaGetLastError();
}
