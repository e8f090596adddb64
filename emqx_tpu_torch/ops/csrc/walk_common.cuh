// walk_common.cuh — the (D+1)-step NFA walk of one topic row, shared by
// the hash walk (nfa_walk.cu) and the join walk (nfa_join_walk.cu).  The
// literal-edge lookup is a template argument: the factoring of
// emqx_tpu/ops/pallas_match.py `_walk_tile`, which both of its Pallas
// kernels call with their own lookup.
//
// Output is the raw accept-slot layout of `nfa_match(compact_output=
// False)`, bit for bit: acc (B, C) int32 with C = sum_t 2*w_t (w_0 = 1,
// w_{t+1} = min(2*w_t, A)), and aover (B,) int32, the per-row active-set
// spill.
//
// Per step t of row r, for each active slot j (w_t slots):
//   * a valid slot (state >= 0) loads its 16 B node row
//     [plus_child, hash_accept, accept, 0];
//   * acc[col + j]       = hash_accept  (-1 at t = 0 for $-topics)
//     acc[col + w + j]   = accept if t == len else -1;
//   * for t < min(D, len): cand[j] = lookup(state, word), the literal
//     edge's target or -1, and cand[w + j] = plus_child (-1 at t = 0
//     for $-topics);
//   * invalid slots emit -1 everywhere and load nothing.
// Then the next active set is cand itself when 2*w <= A, else the A
// largest candidates in descending order (lax.top_k), with the dropped
// valid candidates added to the row's spill.
//
// One thread walks one row; the row's active set and candidates live in
// thread-local arrays.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define NFA_MAX_A 32

namespace nfa {

// `lookup(s, word)` gives the literal edge of valid state `s` on `word`.
template <class Lookup>
__device__ __forceinline__ void walk_row(
    int r, const int* __restrict__ words, const int* __restrict__ lens,
    const uint8_t* __restrict__ is_sys, const int4* __restrict__ node_tab,
    int D, int A, int C, int* __restrict__ acc, int* __restrict__ aover,
    const Lookup& lookup) {
  int active[NFA_MAX_A];
  int cand[2 * NFA_MAX_A];
  const int len = lens[r];
  const bool sys = is_sys[r] != 0;
  const int* row_words = words + (size_t)r * D;
  int* out = acc + (size_t)r * C;

  int w = 1;
  active[0] = 0;  // {root}
  int col = 0;
  int spill = 0;
  for (int t = 0; t <= D; ++t) {
    const bool step = t < D && t < len;
    const int word = step ? row_words[t] : 0;
    const bool root_sys = t == 0 && sys;
    for (int j = 0; j < w; ++j) {
      const int s = active[j];
      int hacc = -1, eacc = -1, lit = -1, plus = -1;
      if (s >= 0) {
        const int4 nd = __ldg(node_tab + s);
        hacc = root_sys ? -1 : nd.y;
        eacc = t == len ? nd.z : -1;
        if (step) {
          plus = root_sys ? -1 : nd.x;
          lit = lookup(s, word);
        }
      }
      out[col + j] = hacc;
      out[col + w + j] = eacc;
      cand[j] = lit;
      cand[w + j] = plus;
    }
    col += 2 * w;
    if (t == D) break;
    const int n = 2 * w;
    if (n <= A) {
      for (int j = 0; j < n; ++j) active[j] = cand[j];
      w = n;
      continue;
    }
    // top_k(cand, A): the valid candidates, largest first; states are
    // unique within a row, so the order is fully determined.
    int nv = 0;
    for (int j = 0; j < n; ++j)
      if (cand[j] >= 0) cand[nv++] = cand[j];
    for (int i = 1; i < nv; ++i) {
      const int v = cand[i];
      int k = i - 1;
      while (k >= 0 && cand[k] < v) {
        cand[k + 1] = cand[k];
        --k;
      }
      cand[k + 1] = v;
    }
    const int kept = nv < A ? nv : A;
    for (int j = 0; j < A; ++j) active[j] = j < kept ? cand[j] : -1;
    spill += nv - kept;
    w = A;
  }
  aover[r] = spill;
}

}  // namespace nfa
