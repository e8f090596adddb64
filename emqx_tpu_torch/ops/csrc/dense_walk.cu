// dense_walk.cu — K6, the dense walk of a multi-hot frontier, for Hopper
// (sm_90a): a frontier-sparse push walk.
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
// an OR: state c is active at t + 1 iff t < len and some active state p
// has c as a `+` child (except at t = 0 for a $-topic) or as a literal
// child whose label equals words[t].  So the walk pushes from the active
// states instead of pulling every column: the wrapper turns lmat and pmat
// once per table into each state's literal children, sorted by (label,
// child), and its `+` children (CSR), and packs them with the accept ids
// and the accept-id bitmaps into one int32 buffer (dense_match.
// dense_table; the segment layout is `layout` below).  Exact for any 0/1
// matrix: several parents a column and several children a label included.
//
// A step.  The row's frontier is an S-bit set; each lane of the row's
// group owns the words k = lane, lane + G, ...  It ORs its words into the
// hash (not at t = 0 for a $-topic) and end (at t = len) accept bitmaps,
// clears the next frontier's words, and one ballot says whether the row
// goes on (t < min(D, len) and some bit set).  Then each lane expands the
// set bits of its own words: every `+` child, then a binary search of the
// state's literal children for words[t] and every child of the equal
// range, each set with atomicOr on the next frontier's shared word.  A
// step costs O(active states x log degree) instead of O(S); a trie's
// frontier is a handful of states (each state has one incoming literal
// edge and at most one `+` parent).
//
// Layout: G lanes a row, G = 8 for S <= 256, 16 for S <= 512, else 32, so
// that a lane owns about one frontier word at the hot tier's S = 256 (a
// warp a row would leave 24 of 32 lanes without a word in every scan) and
// a warp walks 32 / G rows at once.  The warp's rows step together (its
// ballots and shuffles take every lane): a finished row's group idles
// until the warp's last row is done.  Each group keeps four S-bit sets in
// shared memory (frontier, next, hash and end accepts).  The packed table
// is staged once per block with cp.async (16 B a copy) when it fits beside
// the bitsets; else it is read through L1 from device memory.  The grid is
// capped at the blocks that can be resident, so each block stages once.
//
// Compaction, per pass (hash, then end accepts): the group scans its
// accept words G at a time, each word ANDed with the table's bitmap of
// states that carry an id; one warp ballot skips a chunk in which no word
// has a bit; a shuffle scan of the per-lane popcounts gives each lane its
// first position, and it writes the ids of its bits (read from shared
// memory) while the position is below K.  Then -1 up to K, n and mover.
//
// What bounds it on the H100: bytes, by far the smaller part of its time.
// One call must move the batch (4 B D + 5 B), the packed table and the
// outputs (4 B (K + 3)): about 1.3 MB at B = 4096, D = 8, K = 64, 0.4 us
// at 3.35 TB/s.  The work is one visit per active state and child set, a
// few per row step.  What the kernel waits on is the chain of a step:
// the frontier's shared loads, the search and the atomics, then two warp
// syncs; the design keeps every operand of a step in shared memory and
// visits only the active states.

#include <cstdint>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#define DENSE_THREADS 256  // threads per block: 8 warps, 32 / G rows each

namespace {

constexpr unsigned FULL = 0xffffffffu;

// Segments of the packed table, in ints, each padded to 4 ints (16 B) so
// that the whole buffer stages in 16-byte copies: the same layout as
// dense_match._layout.
struct Layout {
  int lptr, llab, lchild, pptr, pchild, hacc, eacc, hmask, emask, total;
};

__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

__host__ __device__ __forceinline__ Layout layout(int S, int nl, int np) {
  const int nw = (S + 31) >> 5;
  Layout L;
  L.lptr = 0;                         // S + 1 offsets into llab / lchild
  L.llab = L.lptr + pad4(S + 1);      // nl labels, ascending per state
  L.lchild = L.llab + pad4(nl);       // nl literal children
  L.pptr = L.lchild + pad4(nl);       // S + 1 offsets into pchild
  L.pchild = L.pptr + pad4(S + 1);    // np `+` children
  L.hacc = L.pchild + pad4(np);       // S hash-accept ids (-1 none)
  L.eacc = L.hacc + pad4(S);          // S end-accept ids (-1 none)
  L.hmask = L.eacc + pad4(S);         // nw words: bit s = hacc[s] >= 0
  L.emask = L.hmask + pad4(nw);       // nw words: bit s = eacc[s] >= 0
  L.total = L.emask + pad4(nw);
  return L;
}

__device__ __forceinline__ void set_bit(unsigned* bits, int s) {
  atomicOr(bits + (s >> 5), 1u << (s & 31));
}

template <int G>
__global__ void __launch_bounds__(DENSE_THREADS)
dense_walk_kernel(const int* __restrict__ words, const int* __restrict__ lens,
                  const uint8_t* __restrict__ is_sys,
                  const int* __restrict__ table, int stage, int B, int D,
                  int S, int nl, int np, int K, int* __restrict__ matches,
                  int* __restrict__ nout, int* __restrict__ aover,
                  int* __restrict__ mover) {
  extern __shared__ unsigned dense_smem[];
  const int nw = (S + 31) >> 5;
  const Layout L = layout(S, nl, np);
  const int* tab = table;
  unsigned* bits = dense_smem;
  if (stage) {  // the same for every thread of the block
    int* staged = reinterpret_cast<int*>(dense_smem);
    for (int i = threadIdx.x * 4; i < L.total; i += DENSE_THREADS * 4)
      __pipeline_memcpy_async(staged + i, table + i, 16);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    tab = staged;
    bits = dense_smem + L.total;
  }
  const int* lptr = tab + L.lptr;
  const int* llab = tab + L.llab;
  const int* lchild = tab + L.lchild;
  const int* pptr = tab + L.pptr;
  const int* pchild = tab + L.pchild;
  const int lane = threadIdx.x & 31;
  const int lg = lane % G;                     // lane within the row's group
  const int g = lane / G;                      // the group within the warp
  const unsigned gmask = G == 32 ? FULL : ((1u << G) - 1u) << (g * G);
  unsigned* const sets = bits + (threadIdx.x / G) * 4 * nw;
  unsigned* const acch = sets + 2 * nw;
  unsigned* const acce = sets + 3 * nw;
  const int warps = gridDim.x * (DENSE_THREADS / 32);
  for (int first = (blockIdx.x * (DENSE_THREADS / 32) + (threadIdx.x >> 5)) *
                   (32 / G);
       first < B; first += warps * (32 / G)) {  // the same in the warp
    const int r = first + g;
    const bool row = r < B;
    const int len = row ? __ldg(lens + r) : -1;
    const bool sys = row && __ldg(is_sys + r) != 0;
    unsigned* cur = sets;
    unsigned* nxt = sets + nw;
    for (int k = lg; k < nw; k += G) {
      cur[k] = k == 0 && row ? 1u : 0u;  // {root}
      acch[k] = 0u;
      acce[k] = 0u;
    }
    __syncwarp();
    for (int t = 0;; ++t) {
      const bool root_sys = t == 0 && sys;  // no root fire, no root '+'
      unsigned live = 0u;
      for (int k = lg; k < nw; k += G) {
        const unsigned a = cur[k];
        live |= a;
        if (!root_sys) acch[k] |= a;
        if (t == len) acce[k] |= a;
        nxt[k] = 0u;
      }
      const unsigned lit = __ballot_sync(FULL, live != 0u);
      const bool go = t < D && t < len && (lit & gmask) != 0u;
      if (__ballot_sync(FULL, go) == 0u) break;
      __syncwarp();  // nxt is clear in every lane before any bit is set
      if (go) {
        const int word = __ldg(words + (size_t)r * D + t);
        for (int k = lg; k < nw; k += G) {
          for (unsigned a = cur[k]; a != 0u; a &= a - 1u) {
            const int p = (k << 5) + __ffs(a) - 1;
            if (!root_sys)
              for (int i = pptr[p], e = pptr[p + 1]; i < e; ++i)
                set_bit(nxt, pchild[i]);
            int lo = lptr[p];
            const int end = lptr[p + 1];
            for (int hi = end; lo < hi;) {  // the first label >= word
              const int mid = (lo + hi) >> 1;
              if (llab[mid] < word)
                lo = mid + 1;
              else
                hi = mid;
            }
            for (; lo < end && llab[lo] == word; ++lo)
              set_bit(nxt, lchild[lo]);
          }
        }
      }
      __syncwarp();  // nxt is whole before it becomes the frontier
      unsigned* const done = cur;
      cur = nxt;
      nxt = done;
    }
    __syncwarp();  // the accept bitmaps are whole
    int n = 0;
    int* const out = matches + (size_t)r * K;  // written only for a row
    for (int pass = 0; pass < 2; ++pass) {
      const unsigned* acc = pass ? acce : acch;
      const unsigned* has_id =
          reinterpret_cast<const unsigned*>(tab + (pass ? L.emask : L.hmask));
      const int* ids = tab + (pass ? L.eacc : L.hacc);
      for (int k0 = 0; k0 < nw; k0 += G) {  // the same in the warp
        const int k = k0 + lg;
        unsigned w = k < nw ? acc[k] & has_id[k] : 0u;
        if (__ballot_sync(FULL, w != 0u) == 0u) continue;
        const int cnt = __popc(w);
        int incl = cnt;
        for (int d = 1; d < G; d <<= 1) {
          const int v = __shfl_up_sync(FULL, incl, d, G);
          if (lg >= d) incl += v;
        }
        const int total = __shfl_sync(FULL, incl, G - 1, G);
        for (int pos = n + incl - cnt; w != 0u && pos < K; ++pos) {
          out[pos] = ids[(k << 5) + __ffs(w) - 1];
          w &= w - 1u;
        }
        n += total;
      }
    }
    if (row) {
      for (int j = min(n, K) + lg; j < K; j += G) out[j] = -1;
      if (lg == 0) {
        nout[r] = n;
        aover[r] = 0;
        mover[r] = n > K ? 1 : 0;
      }
    }
    __syncwarp();  // the next rows may reset the bitsets
  }
}

}  // namespace

// C interface for ctypes.  Pointers are device pointers (`table` the
// packed buffer of dense_match.dense_table, 16-byte aligned); `stream` is
// a cudaStream_t.  Returns the cudaError_t of the set-up and the launch
// (0 = launched).
extern "C" int dense_walk_launch(const int* words, const int* lens,
                                 const uint8_t* is_sys, const int* table,
                                 int B, int D, int S, int nl, int np, int K,
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
  const int nw = (S + 31) / 32;
  const int G = nw <= 8 ? 8 : nw <= 16 ? 16 : 32;
  const size_t bit_bytes =
      (size_t)(DENSE_THREADS / G) * 4 * nw * sizeof(unsigned);
  const size_t tab_bytes = sizeof(int) * (size_t)layout(S, nl, np).total;
  const int stage = bit_bytes + tab_bytes <= (size_t)max_smem;
  const size_t smem = stage ? bit_bytes + tab_bytes : bit_bytes;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  auto kernel = G == 8    ? dense_walk_kernel<8>
                : G == 16 ? dense_walk_kernel<16>
                          : dense_walk_kernel<32>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      DENSE_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const int rows_per_block = DENSE_THREADS / G;
  const int want = (B + rows_per_block - 1) / rows_per_block;
  const int grid = min(want, max(1, per_sm * sms));
  kernel<<<grid, DENSE_THREADS, smem, (cudaStream_t)stream>>>(
      words, lens, is_sys, table, stage, B, D, S, nl, np, K, matches, nout,
      aover, mover);
  return (int)cudaGetLastError();
}
