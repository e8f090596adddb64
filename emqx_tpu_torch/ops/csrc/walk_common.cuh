// walk_common.cuh — the (D+1)-step NFA walk of a topic batch, shared by
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
//   * for t < min(D, len): lit[j] = lookup(state, word), the literal
//     edge's target or -1, and plus[j] = plus_child (-1 at t = 0 for
//     $-topics); the candidates are cand[j] = lit[j], cand[w + j] =
//     plus[j];
//   * invalid slots emit -1 everywhere and load nothing.
// Then the next active set is cand itself when 2*w <= A, else the A
// largest candidates in descending order (lax.top_k), with the dropped
// valid candidates added to the row's spill.
//
// Layout: one lane per frontier slot.  A group of L lanes walks one row,
// L the smallest power of two >= A, so a warp holds 32 / L rows and a
// block of NFA_THREADS threads NFA_THREADS / L rows (at A = 16 and B =
// 2048: 256 blocks, 1,024 warps, about 8 a SM).  Lane j holds active[j]
// (-1 for j >= w) and, in one step, issues its node-row load and its
// lookup together (the lookup needs only (state, word)), so a step
// costs the slowest slot's chain of dependent loads, not the sum over
// the slots.  The next frontier moves between the row's lanes:
//   * 2w <= A: lane k < w keeps its literal candidate, lane w <= k < 2w
//     takes the `+` child of lane k - w (two __shfl_sync);
//   * 2w > A: a valid candidate's rank is the number of valid
//     candidates greater than it plus those equal to it at a lower
//     index, counted with shuffles over the lanes that hold a valid
//     candidate.  Ranks are distinct even if a state repeats in a row,
//     and rank order is top_k's value order; rank < A goes to lane
//     `rank` through a per-row scratch of L ints in shared memory.
// Every lane of the block runs every step, rows past B included (their
// slots stay -1 and they load and store nothing), so the full-warp
// shuffles and ballots always have all their lanes.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define NFA_MAX_A 32
#define NFA_THREADS 128  // threads per block, both kernels

namespace nfa {

// Lanes that walk one row: the smallest power of two >= A.
__host__ __device__ __forceinline__ int lanes_per_row(int A) {
  int L = 1;
  while (L < A) L <<= 1;
  return L;
}

// Blocks of NFA_THREADS threads that cover B rows.
__host__ __device__ __forceinline__ int walk_blocks(int B, int A) {
  const int rows = NFA_THREADS / lanes_per_row(A);
  return (B + rows - 1) / rows;
}

// `lookup(s, word)` gives the literal edge of valid state `s` on `word`.
// `scratch` is NFA_THREADS ints of shared memory.
template <class Lookup>
__device__ __forceinline__ void walk_rows(
    const int* __restrict__ words, const int* __restrict__ lens,
    const uint8_t* __restrict__ is_sys, const int4* __restrict__ node_tab,
    int B, int D, int A, int C, int* __restrict__ acc,
    int* __restrict__ aover, int* scratch, const Lookup& lookup) {
  constexpr unsigned FULL = 0xffffffffu;
  const int L = lanes_per_row(A);
  const int j = threadIdx.x & (L - 1);  // this lane's slot
  const int base = threadIdx.x - j;     // the row's scratch in the block
  const unsigned lane_bits = L == 32 ? FULL : (1u << L) - 1;
  const unsigned row_bits = lane_bits << ((threadIdx.x & 31) - j);
  const int r = (blockIdx.x * NFA_THREADS + threadIdx.x) / L;
  const bool in = r < B;
  const int len = in ? __ldg(lens + r) : -1;
  const bool sys = in && __ldg(is_sys + r) != 0;
  const int* row_words = words + (size_t)r * D;
  int* out = acc + (size_t)r * C;

  int s = in && j == 0 ? 0 : -1;  // {root}
  int w = 1;
  int col = 0;
  int spill = 0;
  int next_word = in && len > 0 ? __ldg(row_words) : 0;
  for (int t = 0; t <= D; ++t) {
    const bool step = t < D && t < len;
    const int word = next_word;
    if (t + 1 < D && t + 1 < len) next_word = __ldg(row_words + t + 1);
    const bool root_sys = t == 0 && sys;
    int hacc = -1, eacc = -1, lit = -1, plus = -1;
    if (s >= 0) {
      const int4 nd = __ldg(node_tab + s);
      if (step) lit = lookup(s, word);
      hacc = root_sys ? -1 : nd.y;
      eacc = t == len ? nd.z : -1;
      if (step) plus = root_sys ? -1 : nd.x;
    }
    if (in && j < w) {
      out[col + j] = hacc;
      out[col + w + j] = eacc;
    }
    col += 2 * w;
    if (t == D) break;
    const int n = 2 * w;
    if (n <= A) {
      const int src = j < w ? j : j - w;
      const int a = __shfl_sync(FULL, lit, src, L);
      const int b = __shfl_sync(FULL, plus, src, L);
      s = j < w ? a : (j < n ? b : -1);
      w = n;
      continue;
    }
    // top_k(cand, A).  Lane j's candidates sit at indices j and w + j.
    const unsigned vl = __ballot_sync(FULL, lit >= 0);
    const unsigned vp = __ballot_sync(FULL, plus >= 0);
    const int nv = __popc(vl & row_bits) + __popc(vp & row_bits);
    unsigned todo = vl | vp;  // the row lanes holding a valid candidate,
    for (int sh = 16; sh >= L; sh >>= 1) todo |= todo >> sh;  // all rows
    todo &= lane_bits;
    int rank_lit = 0, rank_plus = 0;
    while (todo) {
      const int q = __ffs(todo) - 1;
      todo &= todo - 1;
      const int a = __shfl_sync(FULL, lit, q, L);   // index q
      const int b = __shfl_sync(FULL, plus, q, L);  // index w + q
      rank_lit += (a > lit || (a == lit && q < j)) + (b > lit);
      rank_plus += (a >= plus) + (b > plus || (b == plus && q < j));
    }
    if (lit >= 0 && rank_lit < A) scratch[base + rank_lit] = lit;
    if (plus >= 0 && rank_plus < A) scratch[base + rank_plus] = plus;
    __syncwarp();
    const int kept = min(nv, A);
    s = j < kept ? scratch[base + j] : -1;
    __syncwarp();
    spill += nv - kept;
    w = A;
  }
  if (in && j == 0) aover[r] = spill;
}

}  // namespace nfa
