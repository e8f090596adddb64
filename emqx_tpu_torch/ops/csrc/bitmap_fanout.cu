// bitmap_fanout.cu — the subscriber-bitmap work of the multi-device fan-out
// for Hopper (sm_90a): six kernels.
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
// * ring_or — the whole ring step on one device, after the raw walk:
//   `ring_fanout.build_ring_fanout` (:47) and `build_ring_fanout_compact`
//   (:103).  Per row, the first K valid raw accept slots in column order
//   (the compact epilogue's ids); each id names one bitmap row in one
//   window r = id / f_local; the rows of window r OR into its partial P_r.
//   Plain form: P_0 | ... | P_{ring-1}, what the ring's rotation leaves at
//   position 0.  Compact form: P_0 | T(P_1) | ... | T(P_{ring-1}), T
//   keeping a partial's lowest `cap` set bits across the row (the
//   compacted id list each position sends, re-expanded by `bits_of`
//   :153-166), and truncated[b] = the windows, position 0 among them,
//   whose partial holds more than `cap` bits (the `psum(over, "ring")`).
// * ulysses_or — the Ulysses step on one device, after the raw walk:
//   `ulysses.build_ulysses_step` (:91).  The same first K valid ids OR
//   their rows of the full-width bitmap; word w of row b goes to dispatch
//   part w / Wl at (b, w % Wl) (the tiled all_to_all's landed layout);
//   each set bit adds one to its subscriber's count (:129-131); the row's
//   count of valid raw slots (n_matches) and its spill flag go beside.
//
// The bitmaps are int32 bit patterns (the reference's uint32), each row
// `ld` ints apart, so a column slice of a wider bitmap is read in place.
//
// What bounds them on the H100: bytes.  accept_or reads one bitmap row
// slice for each valid id of a row (K rows of W words, scattered over a
// table far larger than the 50 MB L2) and writes B x W words; the others
// read the B x W bitmap (and G x W masks, L2-resident) once or G times.
// ring_or and ulysses_or read a row's C raw accept slots, the bitmap rows
// its first K valid ids name (W words each) and write B x W words (and
// the W x 32 counts, or a flag a row).
// Design: threads along the words of a row, so each row slice is one
// coalesced read; a row's ids staged in shared memory (accept_or: in
// chunks of the block; ring_or and ulysses_or: the first K valid ids once,
// by a block scan of the raw slots, then grouped by window); the row
// gather-OR one device function for all three; popcounts by __popc, sums
// by warp shuffles (integer, so exact in any order); compaction by a
// block scan of word popcounts; ring_or's cap by the same scan, a running
// count a window carried from tile to tile of words (a partial is never
// held whole: 125 KB at config 5's 1M subscribers) and __fns in the word
// where it is crossed; ulysses_or's counts by one atomicAdd a set bit
// into counters its entry zeroes (integer, so exact in any order); the
// pick by a warp scan of word popcounts and __fns.  Correct and simple
// first: every kernel is one pass, none tuned yet.

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

// The row gather-OR of accept_or, ring_or and ulysses_or: the OR of word w
// of the bitmap rows listed in rows[0, n) (a -1 entry reads nothing), each
// row `ld` ints apart.
__device__ __forceinline__ unsigned or_rows(const int* __restrict__ bitmap,
                                            int ld, const int* rows, int n,
                                            int w) {
  unsigned v = 0;
  for (int j = 0; j < n; ++j) {
    const int row = rows[j];
    if (row >= 0) v |= (unsigned)__ldg(bitmap + (size_t)row * ld + w);
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
    if (w < W) v |= or_rows(bitmap, ld, local, min(BF_THREADS, K - k0), w);
    __syncthreads();
  }
  if (w < W) out[(size_t)b * W + w] = (int)v;
  const int s = warp_sum(__popc(v));
  if ((threadIdx.x & 31) == 0 && s != 0) atomicAdd(popc + b, s);
}

// Exclusive prefix sum of `c` over the threads of the block in thread
// order; the block's sum in *total.  Every thread of the block calls it
// (two barriers); `warp_total` is BF_WARPS ints of shared memory.
__device__ __forceinline__ int block_scan(int c, int* warp_total, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_scan(c, lane);
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int before = incl - c;
  int sum = 0;
  for (int i = 0; i < BF_WARPS; ++i) {
    if (i < warp) before += warp_total[i];
    sum += warp_total[i];
  }
  __syncthreads();  // warp_total is rewritten by the next call
  *total = sum;
  return before;
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
  int carry = 0;  // set bits in the row's earlier rounds (same in all threads)
  for (int w0 = 0; w0 < W; w0 += BF_THREADS) {
    const int w = w0 + threadIdx.x;
    const unsigned v =
        w < W ? (unsigned)__ldg(bitmap + (size_t)b * ld + w) : 0u;
    int round;
    int pos = carry + block_scan(__popc(v), warp_total, &round);
    for (unsigned rest = v; rest != 0u && pos < cap; rest &= rest - 1u)
      ids[(size_t)b * cap + pos++] =
          (int)((unsigned)id_base + (unsigned)(w * 32 + __ffs(rest) - 1));
    carry += round;
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

// The ids of one raw accept row (`C` slots, -1 empty) that the compact
// epilogue keeps (`match_kernel._compact`): its first K valid slots in
// column order, grouped by window for the gather-OR.  An id at or past
// `rows` reads nothing and is dropped here; any other falls in window
// id / f_local of `nwin` (f_local = 0: one window).  On return (after a
// barrier) window r's ids are list[start[r], start[r + 1]) in shared
// memory, in no particular order within the window (an OR takes them in
// any); `stage` holds K ints, `list` K, `start` nwin + 1, `cursor` nwin.
// Returns the row's count of valid slots, which may exceed K.
__device__ int stage_windows(const int* __restrict__ acc, int C, int K,
                             int rows, int f_local, int nwin, int* stage,
                             int* list, int* start, int* cursor,
                             int* warp_total) {
  int seen = 0;
  for (int c0 = 0; c0 < C; c0 += BF_THREADS) {
    const int c = c0 + threadIdx.x;
    const int id = c < C ? __ldg(acc + c) : -1;
    int round;
    const int pos = seen + block_scan(id >= 0 ? 1 : 0, warp_total, &round);
    if (id >= 0 && pos < K) stage[pos] = id;
    seen += round;
  }
  const int n = min(seen, K);
  for (int r = threadIdx.x; r < nwin; r += BF_THREADS) cursor[r] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += BF_THREADS) {
    const int id = stage[j];
    if (id < rows) atomicAdd(cursor + (f_local ? id / f_local : 0), 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    start[0] = 0;
    for (int r = 0; r < nwin; ++r) {
      start[r + 1] = start[r] + cursor[r];
      cursor[r] = start[r];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += BF_THREADS) {
    const int id = stage[j];
    if (id < rows)
      list[atomicAdd(cursor + (f_local ? id / f_local : 0), 1)] = id;
  }
  __syncthreads();
  return seen;
}

// The lowest `keep` set bits of v (0 < keep < popc(v)).
__device__ __forceinline__ unsigned low_bits(unsigned v, int keep) {
  const unsigned at = __fns(v, 0u, keep);  // the keep-th set bit
  return at >= 31u ? v : v & ((2u << at) - 1u);
}

// One block per batch row; thread = word, BF_THREADS words a tile, tiles
// in ascending order.  cap < 0 is the plain form (one window: the OR of
// every row).  With a cap, each window's partial word is ORed and counted
// in turn: a block scan of the word popcounts plus the window's running
// count from the earlier tiles (`carry`) gives the set bits before the
// word; windows past the first keep only the bits below the cap.
__global__ void __launch_bounds__(BF_THREADS)
ring_or_kernel(const int* __restrict__ acc, int C,
               const int* __restrict__ bitmap, int rows, int W, int ld,
               int f_local, int ring, int K, int cap, int* __restrict__ out,
               int* __restrict__ trunc) {
  extern __shared__ int smem[];
  __shared__ int warp_total[BF_WARPS];
  const int b = blockIdx.x;
  const int nwin = cap < 0 ? 1 : ring;
  int* stage = smem;
  int* list = stage + K;
  int* start = list + K;
  int* cursor = start + nwin + 1;
  int* carry = cursor + nwin;
  stage_windows(acc + (size_t)b * C, C, K, rows, cap < 0 ? 0 : f_local,
                nwin, stage, list, start, cursor, warp_total);
  for (int r = threadIdx.x; r < nwin; r += BF_THREADS) carry[r] = 0;
  __syncthreads();
  for (int w0 = 0; w0 < W; w0 += BF_THREADS) {
    const int w = w0 + threadIdx.x;
    unsigned v = 0;
    for (int r = 0; r < nwin; ++r) {
      unsigned p = w < W ? or_rows(bitmap, ld, list + start[r],
                                   start[r + 1] - start[r], w)
                         : 0u;
      if (cap >= 0) {
        const int c = __popc(p);
        const int base = carry[r];
        int tile;
        const int before = base + block_scan(c, warp_total, &tile);
        if (r > 0) {
          const int keep = cap - before;
          p = keep <= 0 ? 0u : keep >= c ? p : low_bits(p, keep);
        }
        if (threadIdx.x == 0) carry[r] = base + tile;
      }
      v |= p;
    }
    if (w < W) out[(size_t)b * W + w] = (int)v;
    if (cap >= 0) __syncthreads();  // carry is read again in the next tile
  }
  if (cap >= 0 && threadIdx.x == 0) {
    int over = 0;
    for (int r = 0; r < ring; ++r) over += carry[r] > cap ? 1 : 0;
    trunc[b] = over;
  }
}

// One block per batch row; thread = word, BF_THREADS words a tile.  The
// row's first K valid ids (one window) OR their bitmap rows; word w lands
// in dispatch part w / Wl, and each of its set bits adds one to counts[w *
// 32 + bit].  meta[b] is the row's count of valid raw slots, meta[B + b]
// its spill flag.
__global__ void __launch_bounds__(BF_THREADS)
ulysses_or_kernel(const int* __restrict__ acc,
                  const int* __restrict__ aover, int B, int C,
                  const int* __restrict__ bitmap, int rows, int W, int ld,
                  int K, int Wl, int* __restrict__ disp,
                  int* __restrict__ counts, int* __restrict__ meta) {
  extern __shared__ int smem[];
  __shared__ int warp_total[BF_WARPS];
  const int b = blockIdx.x;
  int* stage = smem;
  int* list = stage + K;
  int* start = list + K;
  int* cursor = start + 2;
  const int seen = stage_windows(acc + (size_t)b * C, C, K, rows, 0, 1,
                                 stage, list, start, cursor, warp_total);
  const int n = start[1];
  for (int w = threadIdx.x; w < W; w += BF_THREADS) {
    const unsigned v = or_rows(bitmap, ld, list, n, w);
    const int part = w / Wl;
    disp[((size_t)part * B + b) * Wl + (w - part * Wl)] = (int)v;
    for (unsigned rest = v; rest != 0u; rest &= rest - 1u)
      atomicAdd(counts + (size_t)w * 32 + (__ffs(rest) - 1), 1);
  }
  if (threadIdx.x == 0) {
    meta[b] = seen;
    meta[B + b] = aover[b];
  }
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

// The dynamic shared memory of ring_or and ulysses_or: the staged and the
// grouped ids (K each), the windows' starts, cursors and running counts.
static size_t windows_smem(int K, int nwin) {
  return (size_t)(2 * K + 3 * nwin + 1) * sizeof(int);
}

// out (B, W) and, with cap >= 0, trunc (B,): acc (B, C) raw accept slots,
// the bitmap `rows` rows `ld` ints apart, window r its rows [r * f_local,
// (r + 1) * f_local); cap < 0 is the plain form (trunc unused).
extern "C" int ring_or_launch(const int* acc, int B, int C,
                              const int* bitmap, int rows, int W, int ld,
                              int f_local, int ring, int K, int cap, int* out,
                              int* trunc, void* stream) {
  if (B < 0 || C < 0 || W < 0 || ld < W || K < 0 || rows < 0 || ring < 1 ||
      f_local < 1 || (long long)f_local * ring < rows)
    return (int)cudaErrorInvalidValue;
  const size_t smem = windows_smem(K, cap < 0 ? 1 : ring);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  ring_or_kernel<<<B, BF_THREADS, smem, (cudaStream_t)stream>>>(
      acc, C, bitmap, rows, W, ld, f_local, ring, K, cap, out, trunc);
  return (int)cudaGetLastError();
}

// disp (U, B, W / U), counts (W * 32,) (zeroed here, on the stream) and
// meta (2 * B,): acc (B, C) and aover (B,), the bitmap `rows` rows `ld`
// ints apart.
extern "C" int ulysses_or_launch(const int* acc, const int* aover, int B,
                                 int C, const int* bitmap, int rows, int W,
                                 int ld, int K, int U, int* disp, int* counts,
                                 int* meta, void* stream) {
  if (B < 0 || C < 0 || W < 0 || ld < W || K < 0 || rows < 0 || U < 1 ||
      W % U)
    return (int)cudaErrorInvalidValue;
  const size_t smem = windows_smem(K, 1);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (W) {
    const cudaError_t e = cudaMemsetAsync(
        counts, 0, (size_t)W * 32 * sizeof(int), (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (B == 0) return 0;
  ulysses_or_kernel<<<B, BF_THREADS, smem, (cudaStream_t)stream>>>(
      acc, aover, B, C, bitmap, rows, W, ld, K, W ? W / U : 1, disp, counts,
      meta);
  return (int)cudaGetLastError();
}
