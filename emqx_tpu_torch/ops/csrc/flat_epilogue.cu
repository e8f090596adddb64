// flat_epilogue.cu — K3, the flat compaction epilogue, for Hopper (sm_90a).
//
// Replaces: emqx_tpu/ops/match_kernel.py `flat_epilogue` with `_compact`,
// XLA code of the reference (not a `pallas_call`) that follows every
// flat-mode walk of both backends (the serve path, the fanout's batches,
// the exhook sidecar).  From a walk's raw accept slots acc (B, C) int32
// (-1 holes) and its spills aover (B,), bit for bit with
// `match_kernel.flat_epilogue_plain`:
//   n (B,)           the valid ids of each row;
//   matches (cap,)   each row's first K valid ids in column order, rows
//                    one after another at the exclusive prefix sum offs of
//                    nk = min(n, K), every position past the last id
//                    written (or past the cap) -1;
//   mover (B,)       (n > K) | (offs + nk > cap);
//   row_meta (B,)    nk | ((aover > 0) | mover) << 16.
//
// What bounds it on the H100: bytes.  It must read acc once (4 B C; C =
// sum_t 2 w_t = 446 at D = 16, A = 16) and aover, and write the flat
// buffer and three ints a row: 3.65 MB + 0.1 MB at B = 2048 and cap =
// 8 B, about 1.1 us at 3.35 TB/s (0.5 us at D = 8, 0.2 us at D = 4).
// The torch-ops version makes a (B, K + 1) compaction, a (cap + 1,)
// scatter target and a dozen launches; this kernel keeps no intermediate
// in device memory beside one int a tile.
//
// Design: two launches over tiles of EPI_ROWS rows (a block a tile, a
// warp a row, its C ints read coalesced, EPI_UNROLL chunks of 32 columns
// loaded before their ballots, so that a row's loads overlap).
//  1. count_rows: n of each row by ballots and popc, written; the tile's
//     sum of nk into tile_nk[tile].
//  2. scatter_rows: each block sums the tile sums before its own (its
//     base) and all of them (the total), scans its rows' nk in one warp,
//     re-reads each row (L2-resident right after the walk) until it has
//     its nk ids and writes them straight to matches[offs + j] while
//     offs + j < cap; mover and row_meta; then the blocks fill
//     [min(total, cap), cap) with -1 in strided shares.
// Every position below min(total, cap) lies in exactly one row's
// segment, so the two launches write each output once.

#include <cstdint>
#include <cuda_runtime.h>

#define EPI_THREADS 256                 // threads per block: 8 warps
#define EPI_WARPS (EPI_THREADS / 32)
#define EPI_ROWS 8                      // rows of a tile (a block), 1 a warp
#define EPI_UNROLL 4                    // 32-column chunks loaded at once

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SPILL_SHIFT = 16;         // match_kernel.ROW_META_SPILL_SHIFT

__device__ __forceinline__ int warp_sum(int v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

__global__ void __launch_bounds__(EPI_THREADS)
count_rows(const int* __restrict__ acc, int B, int C, int K,
           int* __restrict__ nout, int* __restrict__ tile_nk) {
  __shared__ int warp_nk[EPI_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int nk_sum = 0;
  for (int i = warp; i < EPI_ROWS; i += EPI_WARPS) {
    const int r = blockIdx.x * EPI_ROWS + i;
    if (r >= B) break;  // the same in every lane
    const int* row = acc + (size_t)r * C;
    int n = 0;
    for (int c0 = 0; c0 < C; c0 += 32 * EPI_UNROLL) {
      int v[EPI_UNROLL];  // the loads first, so they are in flight at once
#pragma unroll
      for (int u = 0; u < EPI_UNROLL; ++u) {
        const int c = c0 + 32 * u + lane;
        v[u] = c < C ? __ldg(row + c) : -1;
      }
#pragma unroll
      for (int u = 0; u < EPI_UNROLL; ++u)
        n += __popc(__ballot_sync(FULL, v[u] >= 0));
    }
    if (lane == 0) nout[r] = n;
    nk_sum += min(n, K);
  }
  if (lane == 0) warp_nk[warp] = nk_sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < EPI_WARPS; ++w) s += warp_nk[w];
    tile_nk[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(EPI_THREADS)
scatter_rows(const int* __restrict__ acc, const int* __restrict__ aover,
             const int* __restrict__ nin, const int* __restrict__ tile_nk,
             int B, int C, int K, int cap, int tiles,
             int* __restrict__ matches, int* __restrict__ mover,
             int* __restrict__ row_meta) {
  __shared__ int part[2][EPI_WARPS];  // per warp: tiles before, all tiles
  __shared__ int offs[EPI_ROWS];      // exclusive scan of the tile's nk
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int before = 0, all = 0;
  for (int i = threadIdx.x; i < tiles; i += EPI_THREADS) {
    const int v = tile_nk[i];
    all += v;
    if (i < (int)blockIdx.x) before += v;
  }
  before = warp_sum(before);
  all = warp_sum(all);
  if (lane == 0) {
    part[0][warp] = before;
    part[1][warp] = all;
  }
  if (warp == 0) {
    const int r = blockIdx.x * EPI_ROWS + lane;
    const int nk = lane < EPI_ROWS && r < B ? min(nin[r], K) : 0;
    int incl = nk;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane < EPI_ROWS) offs[lane] = incl - nk;
  }
  __syncthreads();
  int base = 0, total = 0;
  for (int w = 0; w < EPI_WARPS; ++w) {
    base += part[0][w];
    total += part[1][w];
  }
  const unsigned below = (1u << lane) - 1u;
  for (int i = warp; i < EPI_ROWS; i += EPI_WARPS) {
    const int r = blockIdx.x * EPI_ROWS + i;
    if (r >= B) break;  // the same in every lane
    const int n = nin[r];
    const int nk = min(n, K);
    const int off = base + offs[i];
    const int* row = acc + (size_t)r * C;
    // nk <= n valid ids lie in the row, so the loop ends before c0 >= C
    for (int c0 = 0, got = 0; got < nk; c0 += 32 * EPI_UNROLL) {
      int v[EPI_UNROLL];
#pragma unroll
      for (int u = 0; u < EPI_UNROLL; ++u) {
        const int c = c0 + 32 * u + lane;
        v[u] = c < C ? __ldg(row + c) : -1;
      }
#pragma unroll
      for (int u = 0; u < EPI_UNROLL; ++u) {
        const unsigned m = __ballot_sync(FULL, v[u] >= 0);
        const int pos = got + __popc(m & below);
        if (v[u] >= 0 && pos < nk && off + pos < cap)
          matches[off + pos] = v[u];
        got += __popc(m);
      }
    }
    if (lane == 0) {
      const int mo = n > K || off + nk > cap ? 1 : 0;
      const int spilled = __ldg(aover + r) > 0 || mo ? 1 : 0;
      mover[r] = mo;
      row_meta[r] = nk | spilled << SPILL_SHIFT;
    }
  }
  for (int j = min(total, cap) + blockIdx.x * EPI_THREADS + threadIdx.x;
       j < cap; j += gridDim.x * EPI_THREADS)
    matches[j] = -1;
}

}  // namespace

// C interface for ctypes.  Pointers are device pointers; `tile_nk` is
// scratch of at least max(1, ceil(B / EPI_ROWS)) ints; `stream` is a
// cudaStream_t.  Returns the cudaError_t of the launches (0 = launched).
extern "C" int flat_epilogue_launch(const int* acc, const int* aover, int B,
                                    int C, int K, int cap, int* matches,
                                    int* nout, int* mover, int* row_meta,
                                    int* tile_nk, void* stream) {
  if (B < 0 || C < 0 || K < 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = B > 0 ? (B + EPI_ROWS - 1) / EPI_ROWS : 1;
  count_rows<<<tiles, EPI_THREADS, 0, (cudaStream_t)stream>>>(
      acc, B, C, K, nout, tile_nk);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  scatter_rows<<<tiles, EPI_THREADS, 0, (cudaStream_t)stream>>>(
      acc, aover, nout, tile_nk, B, C, K, cap, tiles, matches, mover,
      row_meta);
  return (int)cudaGetLastError();
}
