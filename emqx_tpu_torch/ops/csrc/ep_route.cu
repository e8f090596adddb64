// ep_route.cu — the routing grid and the merge of the multichip step (K8a)
// and of the prefix-EP step (K8c) for Hopper (sm_90a): two kernels.
//
// Replaces no Pallas kernel: the reference computes both inside one XLA
// program in a shard_map, around its walks —
// `emqx_tpu/parallel/multichip_serve.py` build_multichip_step (:181; the
// routed front end :327-354, merge_micro :230, the placement and the
// psums :356-400) and `emqx_tpu/parallel/prefix_ep.py` build_ep_matcher
// (:174; the grid :207-235, the return all_to_all and the placement after
// it).  Run as PyTorch ops, each dispatch of those steps was ~150 small
// launches around ~0.1 ms of walks, and the card waited on the host that
// enqueued them.  Here a dispatch is the walks plus these two launches.
//
// * ep_route — one block a source slice of Bs rows.  The owner of a row is
//   word_owner[clamp(words[r, 0])] (K8a: routable when lens <= D), or
//   words[r, 0] mod tp with the sign of the divisor, as Python's % (K8c:
//   every row routable).  A row's rank among its owner's rows keeps source
//   order, so it equals the reference's cumsum rank: one __ballot_sync and
//   __popc a owner in each warp, an exclusive scan of the warps' counts in
//   shared memory, and a running count a owner across the block's rounds.
//   A row lands at grid slot base + owner * so + rank when rank < C; the
//   block then pads its own empty slots (words 0, len D + 2, is_sys 1, src
//   -1), so the grid needs no memset.  Per source row it writes the
//   overflow flag (rank >= C) and, for K8c, the owner, and it sets the
//   row's output to "nobody wrote it" (ids -1, counts and sums 0), which
//   the merge overwrites for every row that landed.  With base and so
//   chosen for it, the grid is the landed (owner, source, C, .) layout on
//   one device, and no all_to_all is needed.
// * ep_merge — one warp a landed slot (routed) or a batch row
//   (replicated).  It reads the raw accept slots of the shard walk and of
//   the micro-table walk (the walk runs in raw mode, so no compaction runs
//   between the two kernels), keeps the first K (Km) valid ids in column
//   order (`match_kernel._compact`'s order) by ballots, translates them
//   through the shard's aid map with the reference's clamp (-1 stays -1;
//   no map: the identity), packs the micro ids behind the row's own count,
//   and writes the segment, its count and overflow, and the row's
//   n_matches, active_overflow and match_overflow straight into the
//   assembled output.  A routed row has one owner, so one warp writes it;
//   a replicated row's warp sums its tp segments in shard order.  Integer
//   sums, so the result is exact and the same in any order.
//
// What bounds them on the H100: bytes.  ep_route reads the batch once and
// writes the grid and the per-row outputs once; ep_merge reads each
// landed row's raw accept slots (2 x cols ints) and writes the segments.
// Both are a few MB at the served shapes, microseconds at 3.35 TB/s; what
// they remove is the host's enqueue of the eager ops.  Design: the rank by
// ballots (no atomics, no second pass); ids in 32-column rounds, four
// rounds of loads in flight before their ballots; every write addressed
// once, so no memset.  Correct and simple first: not tuned.

#include <cstdint>
#include <cuda_runtime.h>

#define EP_MAX_SRC 64
#define EP_MAX_OWNERS 32
#define EP_MAX_PAIRS 16
#define EP_ROUTE_THREADS 256
#define EP_ROUTE_WARPS (EP_ROUTE_THREADS / 32)
#define EP_MERGE_THREADS 256
#define EP_MERGE_WARPS (EP_MERGE_THREADS / 32)
#define EP_UNROLL 4
#define EP_FULL 0xffffffffu

// The routing grid's launch: `n_src` blocks, block b the rows
// [row0[b], row0[b] + Bs) of the batch, its grid slots at
// base[b] + owner * so + rank.
struct EpRouteArgs {
  const int* words;              // (rows, D) int32
  const int* lens;               // (rows,)
  const unsigned char* is_sys;   // (rows,) 0/1
  const int* word_owner;         // owner of each root word; null: w0 mod tp
  int n_word_owner;
  int n_src, Bs, D, tp, C, so;
  int row0[EP_MAX_SRC];
  int base[EP_MAX_SRC];
  int* grid_w;                   // (slots, D)
  int* grid_l;                   // (slots,)
  unsigned char* grid_s;         // (slots,)
  int* grid_src;                 // (slots,) the row within its source slice
  int* fill_ids;                 // (rows, ld_ids) set to -1 at the block's rows
  int ld_ids;
  int* zero[4];                  // (rows, zero_w[k]) set to 0 there
  int zero_w[4];
  int* flag;                     // (rows,) 1 where a routable row overflowed C
  int* owner_out;                // (rows,) the row's owner (-1: not routable)
};

// One walk pair of the merge: the shard walk's raw accept slots and
// spills, the micro-table walk's (null: none), the aid maps (null: the
// identity), the landed slots' source rows (routed), the output segment,
// the first output row of its row group, and whether the micro answers
// merge into its segment.
struct EpPair {
  const int* acc;
  const int* aover;
  const int* macc;
  const int* maover;
  const int* amap;
  const int* mamap;
  const int* src;
  int amap_n, mamap_n, seg, row_base, micro;
};

// The merge's launch.  Routed: a warp a (pair, landed slot s < rows); the
// slot's row goes to row_base + (s / C) * Bs + src[s].  Replicated: a warp
// a (row group g, row j < rows): pairs [gstart[g], gstart[g + 1]) share
// row_base and write their segments of row row_base + j.  Outputs left
// null are not written.
struct EpMergeArgs {
  EpPair pair[EP_MAX_PAIRS];
  int n_pairs, routed, rows, cols, K, Km, C, Bs, segs;
  int n_groups;
  int gstart[EP_MAX_PAIRS + 1];
  int* ids;                      // (out rows, ld_ids): segment seg at seg * (K + Km)
  int ld_ids;
  int* counts;                   // (out rows, segs)
  int* ov;                       // (out rows, segs)
  int* nm;                       // (out rows,)
  int* ao;                       // (out rows,)
  int* mo;                       // (out rows,)
};

namespace {

__global__ void __launch_bounds__(EP_ROUTE_THREADS)
ep_route_kernel(const EpRouteArgs a) {
  __shared__ int carry[EP_MAX_OWNERS];
  __shared__ int wcount[EP_ROUTE_WARPS][EP_MAX_OWNERS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int r0 = a.row0[blockIdx.x];
  const int base = a.base[blockIdx.x];
  if (tid < a.tp) carry[tid] = 0;
  __syncthreads();
  for (int j0 = 0; j0 < a.Bs; j0 += EP_ROUTE_THREADS) {
    const int j = j0 + tid;
    const int r = r0 + j;
    int own = -1;
    if (j < a.Bs) {
      const int w0 = a.words[(size_t)r * a.D];
      if (a.word_owner != nullptr) {
        if (a.lens[r] <= a.D)
          own = a.word_owner[min(max(w0, 0), a.n_word_owner - 1)];
      } else {
        own = w0 % a.tp;
        if (own < 0) own += a.tp;
      }
      if (own < 0 || own >= a.tp) own = -1;  // an owner outside the mesh
    }
    int rank = 0;
    for (int o = 0; o < a.tp; ++o) {
      const unsigned bal = __ballot_sync(EP_FULL, own == o);
      if (own == o) rank = __popc(bal & below);
      if (lane == 0) wcount[warp][o] = __popc(bal);
    }
    __syncthreads();
    if (tid < a.tp) {  // owner tid: exclusive scan of the warps' counts
      int run = carry[tid];
      for (int w = 0; w < EP_ROUTE_WARPS; ++w) {
        const int c = wcount[w][tid];
        wcount[w][tid] = run;
        run += c;
      }
      carry[tid] = run;
    }
    __syncthreads();
    if (own >= 0) {
      rank += wcount[warp][own];
      if (rank < a.C) {
        const size_t slot = (size_t)base + (size_t)own * a.so + rank;
        for (int k = 0; k < a.D; ++k)
          a.grid_w[slot * a.D + k] = a.words[(size_t)r * a.D + k];
        a.grid_l[slot] = a.lens[r];
        a.grid_s[slot] = a.is_sys[r];
        a.grid_src[slot] = j;
      }
    }
    if (j < a.Bs) {
      if (a.flag != nullptr) a.flag[r] = (own >= 0 && rank >= a.C) ? 1 : 0;
      if (a.owner_out != nullptr) a.owner_out[r] = own;
    }
    __syncthreads();  // wcount is rewritten by the next round
  }
  // this block's empty slots: carry[o] rows landed at owner o (past C: none)
  for (int idx = tid; idx < a.tp * a.C; idx += EP_ROUTE_THREADS) {
    const int o = idx / a.C;
    const int c = idx - o * a.C;
    if (c >= carry[o]) {
      const size_t slot = (size_t)base + (size_t)o * a.so + c;
      for (int k = 0; k < a.D; ++k) a.grid_w[slot * a.D + k] = 0;
      a.grid_l[slot] = a.D + 2;
      a.grid_s[slot] = 1;
      a.grid_src[slot] = -1;
    }
  }
  if (a.fill_ids != nullptr) {
    int* ids = a.fill_ids + (size_t)r0 * a.ld_ids;
    const size_t n = (size_t)a.Bs * a.ld_ids;
    for (size_t i = tid; i < n; i += EP_ROUTE_THREADS) ids[i] = -1;
  }
  for (int z = 0; z < 4; ++z) {
    if (a.zero[z] == nullptr) continue;
    int* out = a.zero[z] + (size_t)r0 * a.zero_w[z];
    const size_t n = (size_t)a.Bs * a.zero_w[z];
    for (size_t i = tid; i < n; i += EP_ROUTE_THREADS) out[i] = 0;
  }
}

// One raw accept row through a warp: its first `cap` valid ids in column
// order, each through `map` (clamped into it; null: the identity), go to
// out[0 .. cap) (null: nowhere).  Returns the row's valid ids, all of
// them: the same in every lane.
__device__ __forceinline__ int take_ids(const int* __restrict__ row, int cols,
                                        const int* __restrict__ map,
                                        int map_n, int cap, int* out,
                                        int lane) {
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
  for (int c0 = 0; c0 < cols; c0 += 32 * EP_UNROLL) {
    int v[EP_UNROLL];
#pragma unroll
    for (int u = 0; u < EP_UNROLL; ++u) {
      const int c = c0 + u * 32 + lane;
      v[u] = c < cols ? __ldg(row + c) : -1;
    }
#pragma unroll
    for (int u = 0; u < EP_UNROLL; ++u) {
      const unsigned bal = __ballot_sync(EP_FULL, v[u] >= 0);
      const int pos = n + __popc(bal & below);
      if (v[u] >= 0 && pos < cap && out != nullptr)
        out[pos] = map != nullptr ? __ldg(map + min(v[u], map_n - 1)) : v[u];
      n += __popc(bal);
    }
  }
  return n;
}

// Pair p's segment of walk row `wrow` into output row `orow`: the first K
// own ids, the first Km micro ids behind them (p.micro), -1 after; its
// count and overflow.  Adds the row's matches, spills and overflow to the
// sums.
__device__ __forceinline__ void merge_row(const EpMergeArgs& a,
                                          const EpPair& p, int wrow,
                                          int orow, int lane, int& n_sum,
                                          int& ao_sum, int& ov_sum) {
  const int W = a.K + a.Km;
  int* seg = a.ids != nullptr
                 ? a.ids + (size_t)orow * a.ld_ids + (size_t)p.seg * W
                 : nullptr;
  const int n = take_ids(p.acc + (size_t)wrow * a.cols, a.cols, p.amap,
                         p.amap_n, a.K, seg, lane);
  const int own = min(n, a.K);
  int mn = 0, mcnt = 0, maov = 0;
  if (p.micro && p.macc != nullptr) {
    mn = take_ids(p.macc + (size_t)wrow * a.cols, a.cols, p.mamap,
                  p.mamap_n, a.Km, seg != nullptr ? seg + own : nullptr,
                  lane);
    mcnt = min(mn, a.Km);
    maov = p.maover[wrow];
  }
  if (seg != nullptr)
    for (int k = own + mcnt + lane; k < W; k += 32) seg[k] = -1;
  const int sov = (n > a.K ? 1 : 0) + (mn > a.Km ? 1 : 0);
  if (lane == 0) {
    if (a.counts != nullptr) a.counts[(size_t)orow * a.segs + p.seg] = own + mcnt;
    if (a.ov != nullptr) a.ov[(size_t)orow * a.segs + p.seg] = sov;
  }
  n_sum += n + mn;
  ao_sum += p.aover[wrow] + maov;
  ov_sum += sov;
}

__global__ void __launch_bounds__(EP_MERGE_THREADS)
ep_merge_kernel(const EpMergeArgs a) {
  const int w = blockIdx.x * EP_MERGE_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  int n = 0, ao = 0, ov = 0, orow;
  if (a.routed) {
    if (w >= a.n_pairs * a.rows) return;  // the whole warp
    const int pi = w / a.rows;
    const int s = w - pi * a.rows;
    const EpPair& p = a.pair[pi];
    const int src = p.src[s];
    if (src < 0) return;  // an empty slot: its row is no one's here
    orow = p.row_base + (s / a.C) * a.Bs + src;
    merge_row(a, p, s, orow, lane, n, ao, ov);
  } else {
    if (w >= a.n_groups * a.rows) return;
    const int g = w / a.rows;
    const int j = w - g * a.rows;
    orow = a.pair[a.gstart[g]].row_base + j;
    for (int pi = a.gstart[g]; pi < a.gstart[g + 1]; ++pi)
      merge_row(a, a.pair[pi], j, orow, lane, n, ao, ov);
  }
  if (lane == 0) {
    if (a.nm != nullptr) a.nm[orow] = n;
    if (a.ao != nullptr) a.ao[orow] = ao;
    if (a.mo != nullptr) a.mo[orow] = ov;
  }
}

}  // namespace

// C interface for ctypes.  `args` is a host pointer to the launch's
// arguments (copied into the kernel's parameters); its pointers are device
// pointers.  `stream` is a cudaStream_t.  Each returns the cudaError_t of
// its launch (0 = launched); an empty launch launches nothing and returns 0.

extern "C" int ep_route_args_size() { return (int)sizeof(EpRouteArgs); }
extern "C" int ep_merge_args_size() { return (int)sizeof(EpMergeArgs); }

extern "C" int ep_route_launch(const EpRouteArgs* args, void* stream) {
  const EpRouteArgs& a = *args;
  if (a.n_src < 0 || a.n_src > EP_MAX_SRC || a.Bs < 0 || a.D < 1 ||
      a.tp < 1 || a.tp > EP_MAX_OWNERS || a.C < 0 || a.so < 0 ||
      (a.word_owner != nullptr && a.n_word_owner < 1))
    return (int)cudaErrorInvalidValue;
  if (a.n_src == 0) return 0;
  ep_route_kernel<<<a.n_src, EP_ROUTE_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int ep_merge_launch(const EpMergeArgs* args, void* stream) {
  const EpMergeArgs& a = *args;
  if (a.n_pairs < 0 || a.n_pairs > EP_MAX_PAIRS || a.rows < 0 ||
      a.cols < 0 || a.K < 0 || a.Km < 0 || a.segs < 1 ||
      (a.routed && a.C < 1) || a.n_groups < 0 || a.n_groups > a.n_pairs)
    return (int)cudaErrorInvalidValue;
  const long long warps =
      (long long)(a.routed ? a.n_pairs : a.n_groups) * a.rows;
  if (warps == 0) return 0;
  const long long blocks = (warps + EP_MERGE_WARPS - 1) / EP_MERGE_WARPS;
  if (warps > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ep_merge_kernel<<<(int)blocks, EP_MERGE_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
