// dense_walk.cu — K6, the dense walk of a multi-hot frontier, for Hopper
// (sm_90a).
//
// Replaces: emqx_tpu/ops/dense_match.py `dense_match`, an XLA function of
// the reference (not a `pallas_call`): a (D+1)-step walk whose frontier is
// a multi-hot row active (B, S), stepped by two bf16 matmuls `active @
// lmat` and `active @ pmat` on the TPU's matrix unit, then the compaction
// of both accept bitmaps to K ids.  Output, bit for bit: matches (B, K)
// int32 (every state's hash accept in state order, then every state's end
// accept, the first K valid, -1 padded), n (B,) the count of all accepts,
// aover (B,) = 0 (the walk never spills) and mover (B,) = n > K.
//
// The function without the matmul.  `> 0.5` after a sum of 0/1 values is
// an OR: column c is active at t + 1 iff t < len and (some `+` parent of c
// is active, except at t = 0 for a $-topic) or (words[t] == label[c] and
// some literal parent of c is active).  The wrapper turns lmat and pmat
// once per table into column -> parents lists (CSC: ptr (S + 1), row
// (nnz)), so a step costs O(S + the parents tested) instead of O(S^2),
// exact for any 0/1 matrix, several parents a column included.
//
// Layout: one warp walks one row (rows strided over the grid's warps).
// The row's frontier is an S-bit set in shared memory (cur), with the next
// frontier (nxt) and the two accept bitmaps (acch, acce) beside it, 4 *
// ceil(S/32) words a warp.  Step t: lane l pulls columns l, l + 32, ...;
// a 32-column chunk's bits are one __ballot_sync, written as one word of
// nxt.  Lanes own the bitmap words k = l mod 32 for the accumulation.  The
// walk stops after t = min(D, len) or once the frontier is empty (no
// later step can fire).  Then the compaction: each 32-state chunk of acch,
// then of acce, is one ballot of "bit set and id >= 0", its ids written at
// the running count plus the lane's prefix (chunks with no bit set are
// skipped); the row's tail is filled with -1.  The tables (label, both ptr
// arrays, both row lists: 12 S + 4 nnz bytes, 8 KB at S = 512 with one
// parent a column, 112 KB at S = 4096 with two in each matrix) are staged
// once per block in shared memory when they fit beside the warps' bitmaps
// (2 S bytes); else the kernel reads them from device memory through L1.  The grid is capped at
// the blocks that can be resident, so each block stages the tables once.
//
// What bounds it on the H100: neither bytes nor arithmetic.  One call moves
// the batch (4 B D + 5 B), the CSC table and the outputs (4 B (K + 3)):
// about 1.3 MB at B = 4096, D = 8, K = 64 (bench_dense's table, S =
// 2048), 0.4 us at 3.35 TB/s.  Its work is one label compare a column and
// step plus the parents tested for the columns whose word matches (a few
// a step): there, about 3.4 steps a row, ~28M compares, under a
// microsecond of the card's scalar rate.  What the kernel waits on is the chain inside a warp: each
// step is S / 32 ballots, each behind a shared-memory load of the
// column's ptr pair and label and the frontier probes of its parents; so
// the design keeps every operand of a step in shared memory, skips the
// parents of a literal column whose label differs from the word, and
// ends a row's walk at its length or at an empty frontier.

#include <cstdint>
#include <cuda_runtime.h>

#define DENSE_THREADS 128  // threads per block: 4 warps, one row each
#define DENSE_WARPS (DENSE_THREADS / 32)

namespace {

constexpr unsigned FULL = 0xffffffffu;

struct Columns {  // generic pointers: shared memory or device memory
  const int* label;
  const int* lptr;
  const int* lrow;
  const int* pptr;
  const int* prow;
};

// Any parent in row[ptr[c] .. ptr[c + 1]) set in the frontier `cur`.
__device__ __forceinline__ bool any_parent(const int* ptr, const int* row,
                                           const unsigned* cur, int c) {
  for (int i = ptr[c], e = ptr[c + 1]; i < e; ++i) {
    const int p = row[i];
    if (cur[p >> 5] >> (p & 31) & 1u) return true;
  }
  return false;
}

// Copies n ints of `src` to `tab` (the block's threads together) and moves
// `tab` past them; returns where they went.
__device__ __forceinline__ const int* stage_copy(int*& tab, const int* src,
                                                 int n) {
  int* dst = tab;
  for (int i = threadIdx.x; i < n; i += DENSE_THREADS) dst[i] = src[i];
  tab += n;
  return dst;
}

__device__ __forceinline__ void walk_row(
    int r, int lane, unsigned* bits, int nw, const Columns& col,
    const int* __restrict__ words, const int* __restrict__ lens,
    const uint8_t* __restrict__ is_sys, const int* __restrict__ hacc,
    const int* __restrict__ eacc, int D, int S, int K,
    int* __restrict__ matches, int* __restrict__ nout,
    int* __restrict__ aover, int* __restrict__ mover) {
  unsigned* cur = bits;
  unsigned* nxt = bits + nw;
  unsigned* acch = bits + 2 * nw;
  unsigned* acce = bits + 3 * nw;
  const int len = __ldg(lens + r);
  const bool sys = __ldg(is_sys + r) != 0;
  const int* row_words = words + (size_t)r * D;
  for (int k = lane; k < nw; k += 32) {
    cur[k] = k == 0 ? 1u : 0u;  // {root}
    acch[k] = 0u;
    acce[k] = 0u;
  }
  __syncwarp();
  for (int t = 0;; ++t) {
    const bool root_sys = t == 0 && sys;  // no root fire, no root '+'
    unsigned live = 0u;
    for (int k = lane; k < nw; k += 32) {
      const unsigned a = cur[k];
      live |= a;
      if (!root_sys) acch[k] |= a;
      if (t == len) acce[k] |= a;
    }
    if (t == D || t >= len || __ballot_sync(FULL, live != 0u) == 0u) break;
    const int word = __ldg(row_words + t);
    for (int base = 0; base < S; base += 32) {
      const int c = base + lane;
      bool on = false;
      if (c < S) {
        if (!root_sys) on = any_parent(col.pptr, col.prow, cur, c);
        if (!on && col.label[c] == word)
          on = any_parent(col.lptr, col.lrow, cur, c);
      }
      const unsigned m = __ballot_sync(FULL, on);
      if (lane == 0) nxt[base >> 5] = m;
    }
    __syncwarp();  // every lane is done reading cur and sees nxt whole
    unsigned* const done = cur;
    cur = nxt;
    nxt = done;
  }
  __syncwarp();  // the accept bitmaps are whole
  int n = 0;
  int* out = matches + (size_t)r * K;
  const unsigned below = (1u << lane) - 1u;
  for (int pass = 0; pass < 2; ++pass) {
    const unsigned* acc = pass ? acce : acch;
    const int* ids = pass ? eacc : hacc;
    for (int k = 0; k < nw; ++k) {
      const unsigned w = acc[k];  // the same word in every lane
      if (w == 0u) continue;
      const int id = w >> lane & 1u ? __ldg(ids + (k << 5) + lane) : -1;
      const unsigned m = __ballot_sync(FULL, id >= 0);
      const int pos = n + __popc(m & below);
      if (id >= 0 && pos < K) out[pos] = id;
      n += __popc(m);
    }
  }
  for (int j = min(n, K) + lane; j < K; j += 32) out[j] = -1;
  if (lane == 0) {
    nout[r] = n;
    aover[r] = 0;
    mover[r] = n > K ? 1 : 0;
  }
  __syncwarp();  // the next row may reset the bitmaps
}

__global__ void __launch_bounds__(DENSE_THREADS)
dense_walk_kernel(const int* __restrict__ words, const int* __restrict__ lens,
                  const uint8_t* __restrict__ is_sys,
                  const int* __restrict__ hacc, const int* __restrict__ eacc,
                  Columns col, int stage, int B, int D, int S, int nl, int np,
                  int K, int* __restrict__ matches, int* __restrict__ nout,
                  int* __restrict__ aover, int* __restrict__ mover) {
  extern __shared__ unsigned dense_smem[];
  const int nw = (S + 31) >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Columns c = col;
  if (stage) {  // the same for every thread of the block
    int* tab = reinterpret_cast<int*>(dense_smem + DENSE_WARPS * 4 * nw);
    c.label = stage_copy(tab, col.label, S);
    c.lptr = stage_copy(tab, col.lptr, S + 1);
    c.pptr = stage_copy(tab, col.pptr, S + 1);
    c.lrow = stage_copy(tab, col.lrow, nl);
    c.prow = stage_copy(tab, col.prow, np);
    __syncthreads();
  }
  unsigned* bits = dense_smem + warp * 4 * nw;
  for (int r = blockIdx.x * DENSE_WARPS + warp; r < B;
       r += gridDim.x * DENSE_WARPS)
    walk_row(r, lane, bits, nw, c, words, lens, is_sys, hacc, eacc, D, S,
             K, matches, nout, aover, mover);
}

}  // namespace

// C interface for ctypes.  Pointers are device pointers; `stream` is a
// cudaStream_t.  Returns the cudaError_t of the set-up and the launch (0 =
// launched).
extern "C" int dense_walk_launch(const int* words, const int* lens,
                                 const uint8_t* is_sys, const int* label,
                                 const int* hacc, const int* eacc,
                                 const int* lptr, const int* lrow,
                                 const int* pptr, const int* prow, int B,
                                 int D, int S, int nl, int np, int K,
                                 int* matches, int* nout, int* aover,
                                 int* mover, void* stream) {
  if (B <= 0 || D < 0 || S <= 0 || nl < 0 || np < 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t nw = ((size_t)S + 31) / 32;
  const size_t bit_bytes = DENSE_WARPS * 4 * nw * sizeof(unsigned);
  const size_t tab_bytes = sizeof(int) * (3 * (size_t)S + 2 + nl + np);
  const int stage = bit_bytes + tab_bytes <= (size_t)max_smem;
  const size_t smem = stage ? bit_bytes + tab_bytes : bit_bytes;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(dense_walk_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dense_walk_kernel, DENSE_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const int want = (B + DENSE_WARPS - 1) / DENSE_WARPS;
  const int grid = min(want, max(1, per_sm * sms));
  const Columns col{label, lptr, lrow, pptr, prow};
  dense_walk_kernel<<<grid, DENSE_THREADS, smem, (cudaStream_t)stream>>>(
      words, lens, is_sys, hacc, eacc, col, stage, B, D, S, nl, np, K,
      matches, nout, aover, mover);
  return (int)cudaGetLastError();
}
