// bitmap_fanout.cu — the subscriber-bitmap work of the multi-device fan-out
// for Hopper (sm_90a): four kernels.
//
// Replaces no Pallas kernel: the reference computes these with XLA inside
// its shard_map steps (emqx_tpu/parallel/), and PyTorch has no op for them
// (no OR reduction over gathered rows, no popcount, uint32 barely usable):
//
// * accept_or — `sharded_match.or_accept_rows` (:88) and the ring's window
//   (`ring_fanout.py:80-88`): out[b, w] = OR over k of
//   bitmap[ids[b, k] - lo, w] for ids in [lo, lo + rows); any other id,
//   -1 among them, reads nothing (or_accept_rows's -1 reads the all-zero
//   sentinel row F, so the OR is the same).  Fused: the row's popcount
//   (`build_sharded_matcher`'s per-shard count before its psum, :247).
// * bitmap_compact — `sharded_match.compact_bitmap_ids` (:100): a bitmap
//   row to its first `cap` set-bit ids in ascending order (`id_base` plus
//   the bit position), -1 padded; the full popcount; overflow where it
//   exceeds `cap`.
// * group_count — `shared_group.build_shared_selector` (:90-93): the
//   popcount of bitmap[b] AND mask[g] for each (row, group).
// * group_pick — the same function's pick (:95-122): for each (row, group)
//   whose hashed ordinal falls in this shard's share, the id of that set
//   bit, else -1 (the pmax over tp follows outside).
//
// The bitmaps are int32 bit patterns (the reference's uint32), each row
// `ld` ints apart, so a column slice of a wider bitmap is read in place.
//
// What bounds them on the H100: bytes.  accept_or reads one bitmap row
// slice for each valid id of a row (K rows of W words, scattered over a
// table far larger than the 50 MB L2) and writes B x W words; the others
// read the B x W bitmap (and G x W masks, L2-resident) once or G times.
// Design: threads along the words of a row, so each row slice is one
// coalesced read; a row's ids staged in shared memory in chunks of the
// block; popcounts by __popc, sums by warp shuffles (integer, so exact in
// any order); compaction by a block scan of word popcounts; the pick by a
// warp scan of word popcounts and __fns.  Correct and simple first: every
// kernel is one pass, none tuned yet.

#include <cstdint>
#include <cuda_runtime.h>

#define BF_THREADS 128
#define BF_WARPS (BF_THREADS / 32)
#define BF_FULL 0xffffffffu

namespace {

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(BF_FULL, v, o);
  return v;
}

// Inclusive prefix sum over the lanes of a warp.
__device__ __forceinline__ int warp_scan(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(BF_FULL, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// One block per (row b, tile of BF_THREADS words); thread = word.  The
// row's ids pass through shared memory BF_THREADS at a time, each turned
// into a local bitmap row (or -1: reads nothing) by the thread that loads
// it; every thread then ORs those rows' words at its column.
__global__ void __launch_bounds__(BF_THREADS)
accept_or_kernel(const int* __restrict__ bitmap, int rows, int W, int ld,
                 const int* __restrict__ ids, int K, int lo, int tiles, int* __restrict__ out, int* __restrict__ popc) {
  __shared__ int local[BF_THREADS];
  const int b = blockIdx.x / tiles;
  const int w = (blockIdx.x % tiles) * BF_THREADS + threadIdx.x;
  unsigned v = 0;
  for (int k0 = 0; k0 < K; k0 += BF_THREADS) {
    const int k = k0 + threadIdx.x;
    int r = -1;
    if (k < K) {
      const long long id = ids[(size_t)b * K + k];
      if (id >= lo && id - lo < rows)
        r = (int)(id - lo);
    }
    local[threadIdx.x] = r;
    __syncthreads();
    const int n = min(BF_THREADS, K - k0);
    if (w < W)
      for (int j = 0; j < n; ++j) {
        const int row = local[j];
        if (row >= 0) v |= (unsigned)__ldg(bitmap + (size_t)row * ld + w);
      }
    __syncthreads();
  }
  if (w < W) out[(size_t)b * W + w] = (int)v;
  const int s = warp_sum(__popc(v));
  if ((threadIdx.x & 31) == 0 && s != 0) atomicAdd(popc + b, s);
}

// One block per row; thread = word, BF_THREADS words a round.  Each word's
// ids go to positions from the count of set bits before it in the row (a
// block scan of word popcounts plus the earlier rounds' total); positions
// at or past cap are not written, and the tail of the row is -1.
__global__ void __launch_bounds__(BF_THREADS)
bitmap_compact_kernel(const int* __restrict__ bitmap, int W, int ld, int cap,
                      int id_base, int* __restrict__ ids,
                      int* __restrict__ counts, int* __restrict__ overflow) {
  __shared__ int warp_total[BF_WARPS];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;  // set bits in the row's earlier rounds (same in all threads)
  for (int w0 = 0; w0 < W; w0 += BF_THREADS) {
    const int w = w0 + threadIdx.x;
    const unsigned v =
        w < W ? (unsigned)__ldg(bitmap + (size_t)b * ld + w) : 0u;
    const int c = __popc(v);
    const int incl = warp_scan(c, lane);
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int pos = carry + incl - c;
    int round = 0;
    for (int i = 0; i < BF_WARPS; ++i) {
      if (i < warp) pos += warp_total[i];
      round += warp_total[i];
    }
    for (unsigned rest = v; rest != 0u && pos < cap; rest &= rest - 1u)
      ids[(size_t)b * cap + pos++] =
          (int)((unsigned)id_base + (unsigned)(w * 32 + __ffs(rest) - 1));
    carry += round;
    __syncthreads();  // warp_total is rewritten by the next round
  }
  for (int p = carry + threadIdx.x; p < cap; p += BF_THREADS)
    ids[(size_t)b * cap + p] = -1;
  if (threadIdx.x == 0) {
    counts[b] = carry;
    overflow[b] = carry > cap ? 1 : 0;
  }
}

// One warp per (row b, group g) pair: pair = b * G + g.
__global__ void __launch_bounds__(BF_THREADS)
group_count_kernel(const int* __restrict__ bitmap, int ldb,
                   const int* __restrict__ masks, int ldm, int B, int G,
                   int W, int* __restrict__ counts) {
  const int pair = blockIdx.x * BF_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const bool live = pair < B * G;  // a dead warp still joins its shuffles
  const int b = live ? pair / G : 0;
  const int g = live ? pair % G : 0;
  int s = 0;
  if (live)
    for (int w = lane; w < W; w += 32)
      s += __popc((unsigned)(__ldg(bitmap + (size_t)b * ldb + w) &
                             __ldg(masks + (size_t)g * ldm + w)));
  s = warp_sum(s);
  if (live && lane == 0) counts[pair] = s;
}

// One warp per (row b, group g) pair.  The ordinal is sel_hash[b] modulo
// max(total, 1), taken as the reference's integer remainder (the sign of
// the divisor); it is this shard's when it falls in [before, before +
// count).  The warp then walks the candidate words (bitmap AND mask) 32
// at a time: a scan of their popcounts finds the word that holds the
// ordinal, __fns the bit in it.  Every decision is the same in all lanes
// of the warp, so the warp leaves the loop together.
__global__ void __launch_bounds__(BF_THREADS)
group_pick_kernel(const int* __restrict__ bitmap, int ldb,
                  const int* __restrict__ masks, int ldm, int B, int G, int W,
                  const int* __restrict__ sel_hash,
                  const int* __restrict__ total,
                  const int* __restrict__ before,
                  const int* __restrict__ count, int col_base,
                  int* __restrict__ picked) {
  const int pair = blockIdx.x * BF_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const bool live = pair < B * G;
  const int b = live ? pair / G : 0;
  const int g = live ? pair % G : 0;
  int result = -1;
  if (live) {
    const int tot = total[pair];
    const int m = max(tot, 1);
    int sel = sel_hash[b] % m;
    if (sel < 0) sel += m;
    const int o = sel - before[pair];
    if (o >= 0 && o < count[pair] && tot > 0) {
      int base = 0;
      for (int w0 = 0; w0 < W; w0 += 32) {
        const int w = w0 + lane;
        const unsigned v =
            w < W ? (unsigned)(__ldg(bitmap + (size_t)b * ldb + w) &
                               __ldg(masks + (size_t)g * ldm + w))
                  : 0u;
        const int c = __popc(v);
        const int incl = warp_scan(c, lane);
        const int round = __shfl_sync(BF_FULL, incl, 31);
        if (base + round > o) {
          const unsigned hit = __ballot_sync(BF_FULL, base + incl > o);
          const int at = __ffs((int)hit) - 1;
          int id = -1;
          if (lane == at)
            id = (col_base + w) * 32 +
                 (int)__fns(v, 0u, o - (base + incl - c) + 1);
          result = __shfl_sync(BF_FULL, id, at);
          break;
        }
        base += round;
      }
    }
  }
  if (live && lane == 0) picked[pair] = result;
}

}  // namespace

// C interface for ctypes.  Pointers are device pointers (int32 arrays);
// `stream` is a cudaStream_t.  Each returns the cudaError_t of its launch
// (0 = launched); an empty launch (no rows) launches nothing and returns 0.

// out (B, W) and popc (B,), which the caller zeroes: the bitmap is `rows`
// rows `ld` ints apart, ids (B, K).
extern "C" int accept_or_launch(const int* bitmap, int rows, int W, int ld,
                                const int* ids, int B, int K, int lo,
                                int* out, int* popc, void* stream) {
  if (B < 0 || W < 0 || K < 0 || rows < 0 || ld < W || lo < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || W == 0) return 0;
  const int tiles = (W + BF_THREADS - 1) / BF_THREADS;
  const long long blocks_ll = (long long)B * tiles;
  if (blocks_ll > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int blocks = (int)blocks_ll;
  accept_or_kernel<<<blocks, BF_THREADS, 0, (cudaStream_t)stream>>>(
      bitmap, rows, W, ld, ids, K, lo, tiles, out, popc);
  return (int)cudaGetLastError();
}

// ids (B, cap), counts (B,), overflow (B,): the bitmap is (B, W), rows
// `ld` ints apart.
extern "C" int bitmap_compact_launch(const int* bitmap, int B, int W, int ld,
                                     int cap, int id_base, int* ids,
                                     int* counts, int* overflow,
                                     void* stream) {
  if (B < 0 || W < 0 || ld < W || cap < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  bitmap_compact_kernel<<<B, BF_THREADS, 0, (cudaStream_t)stream>>>(
      bitmap, W, ld, cap, id_base, ids, counts, overflow);
  return (int)cudaGetLastError();
}

// counts (B, G): the bitmap (B, W) and the masks (G, W), rows `ldb` and
// `ldm` ints apart.
extern "C" int group_count_launch(const int* bitmap, int ldb,
                                  const int* masks, int ldm, int B, int G,
                                  int W, int* counts, void* stream) {
  if (B < 0 || G < 0 || W < 0 || ldb < W || ldm < W)
    return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)B * G;
  if (pairs == 0) return 0;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((pairs + BF_WARPS - 1) / BF_WARPS);
  group_count_kernel<<<blocks, BF_THREADS, 0, (cudaStream_t)stream>>>(
      bitmap, ldb, masks, ldm, B, G, W, counts);
  return (int)cudaGetLastError();
}

// picked (B, G): the operands of group_count, then sel_hash (B,), and
// total, before and count (B, G) (the group's candidates over the whole
// row, in the shards before this one, in this one); col_base is this
// shard's first word in the whole row.
extern "C" int group_pick_launch(const int* bitmap, int ldb, const int* masks,
                                 int ldm, int B, int G, int W,
                                 const int* sel_hash, const int* total,
                                 const int* before, const int* count,
                                 int col_base, int* picked, void* stream) {
  if (B < 0 || G < 0 || W < 0 || ldb < W || ldm < W || col_base < 0)
    return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)B * G;
  if (pairs == 0) return 0;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((pairs + BF_WARPS - 1) / BF_WARPS);
  group_pick_kernel<<<blocks, BF_THREADS, 0, (cudaStream_t)stream>>>(
      bitmap, ldb, masks, ldm, B, G, W, sel_hash, total, before, count,
      col_base, picked);
  return (int)cudaGetLastError();
}
