// walk_common.cuh — the (D+1)-step NFA walk of a topic batch, shared by
// the hash walk (nfa_walk.cu) and the join walk (nfa_join_walk.cu).  The
// literal-edge lookup is a template argument: the factoring of
// emqx_tpu/ops/pallas_match.py `_walk_tile`, which both of its Pallas
// kernels call with their own lookup.  The output is a second template
// argument, one of two policies:
//
//   * RawOut, the raw accept-slot layout of `nfa_match(compact_output=
//     False)`, bit for bit: acc (B, C) int32 with C = sum_t 2*w_t (w_0 =
//     1, w_{t+1} = min(2*w_t, A)), and aover (B,) int32, the per-row
//     active-set spill.  Compact and raw modes, the tiered cold walk,
//     the retained replay and the ACL batch read it.
//   * FlatOut, the flat mode of `nfa_match(flat_cap=cap)` in the same
//     launch (K3, the reference's XLA `match_kernel.flat_epilogue` with
//     `_compact`, fused): no acc is written; see "Flat mode" below.
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
//
// Flat mode (FlatOut), bit for bit with match_kernel.flat_epilogue_plain:
//   n (B,)          the valid ids of each row;
//   matches (cap,)  each row's first K valid ids in column order, rows
//                   one after another at the exclusive prefix sum off of
//                   nk = min(n, K); every position past the last id
//                   written, or past the cap, -1;
//   mover (B,)      (n > K) | (off + nk > cap);
//   row_meta (B,)   nk | ((aover > 0) | mover) << 16; aover as in raw.
// What bounds it is fixed cost, not bytes: the ids are a few a row, so
// the flat outputs are ~0.1 MB at B = 2048, cap = 8 B.  A separate
// epilogue writes and re-reads the whole raw plane (C = 446 ints a row
// at D = 16) and waits for the walk's launch to drain.  Here each step's
// valid ids are already in the row's lanes: they ballot hash_accept >= 0
// and then accept >= 0 (the column order col + j, then col + w + j) and
// append each id at got + popc(lower lanes) to a per-row list of K ints
// in shared memory (rows x K x 4 B a block: 4 KB at A = 16, K = 128);
// n counts every id, the list keeps the first K.  After the walk the
// block scans its rows' nk, and a single-pass decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA 2016) over per-tile state words gives the tile's
// offset: warp 0 publishes the tile's aggregate, reads its 256 nearest
// predecessors' states at once (8 loads a lane in flight) until one holds
// an inclusive prefix, then publishes its own.  Tiles are numbered by an
// atomic ticket taken when the block starts, so a block only waits on
// tiles that are already running.  Each row then copies its list to matches[off + j] (j < nk,
// off + j < cap) and writes its four ints; the tile of the last ticket
// knows the total and fills [min(total, cap), cap) with -1 in 16 B
// stores.  Every output position is written once.
//
// The state words need no memset: a word is epoch << 32 | flag << 30 |
// value, and a launch reads only words of its own epoch.  Word 0 of the
// state buffer is the ticket counter; the wrapper gives each launch the
// counter's value when it starts (the tickets of the launches before on
// the same buffer) and a new epoch, and gives each stream its own buffer
// (walk_kernel.FlatScratch).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define NFA_MAX_A 32
#define NFA_THREADS 128  // threads per block, both kernels

#ifndef CUDA_EMU
// The look-back's state words are read and written with relaxed
// operations at device scope: strong, so that a poll racing a publish
// is no data race, and single-copy atomic, so a poll sees a whole word,
// old or new.  A word carries all that it publishes (epoch, flag,
// value), so no other memory is ordered by it and no fence is needed:
// with ld.acquire each of a window's loads would wait for the one before
// it, and a __threadfence a publish costs more than the look-back.
__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}
#endif

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

// The raw output: the accept slots of row r and its spill.
struct RawOut {
  int* acc;
  int* aover;
  int C;
  int* out;  // this row's C slots

  __device__ __forceinline__ void begin(int r, unsigned) {
    out = acc + (size_t)r * C;
  }
  __device__ __forceinline__ void step(bool in, int j, int w, int col,
                                       int hacc, int eacc) {
    if (in && j < w) {
      out[col + j] = hacc;
      out[col + w + j] = eacc;
    }
  }
  __device__ __forceinline__ void end(bool in, int r, int j, int spill) {
    if (in && j == 0) aover[r] = spill;
  }
};

// Flat mode's operands and outputs (see the head of this file).
struct FlatArgs {
  int K, cap;
  int* matches;  // (cap,), 16-byte aligned
  int* n;
  int* aover;
  int* mover;
  int* row_meta;
  unsigned long long* state;  // [0]: ticket counter; [1 + t]: tile t
  unsigned ticket_base, epoch;
};

#define NFA_ROW_META_SPILL_SHIFT 16  // match_kernel.ROW_META_SPILL_SHIFT
#define NFA_TILE_AGGREGATE 1u        // a tile's state word: its own sum
#define NFA_TILE_PREFIX 2u           // ... the sum through it
#define NFA_TILE_VALUE 0x3fffffffu   // value bits (B * K < 2^30)
#define NFA_SPIN_NS 64               // a look-back's sleep between polls
#define NFA_LOOK_TILES 8             // tiles a lane polls at once

// The flat output: a per-row list of the first K ids in shared memory.
struct FlatOut {
  int K;
  int* list;      // this row's K ints of shared memory
  unsigned rows;  // this row's lanes in the warp
  unsigned below; // the lanes of the warp below this one
  int got;        // valid ids so far (n)
  int spill;

  __device__ __forceinline__ void begin(int, unsigned row_bits) {
    rows = row_bits;
    below = (1u << (threadIdx.x & 31)) - 1u;
    got = 0;
  }
  __device__ __forceinline__ void add(bool valid, int id) {
    const unsigned m = __ballot_sync(0xffffffffu, valid) & rows;
    const int pos = got + __popc(m & below);
    if (valid && pos < K) list[pos] = id;
    got += __popc(m);
  }
  __device__ __forceinline__ void step(bool, int j, int w, int, int hacc,
                                       int eacc) {
    // most steps hold no id in any row of the warp: one vote skips both
    if (__ballot_sync(0xffffffffu, hacc >= 0 || eacc >= 0) == 0u) return;
    add(j < w && hacc >= 0, hacc);  // columns col + j
    add(j < w && eacc >= 0, eacc);  // columns col + w + j
  }
  __device__ __forceinline__ void end(bool, int, int, int s) { spill = s; }
};

// `lookup(s, word)` gives the literal edge of valid state `s` on `word`.
// `scratch` is NFA_THREADS ints of shared memory.  The block walks rows
// tile * NFA_THREADS / L on; `out` takes each step's accept slots.
template <class Lookup, class Out>
__device__ __forceinline__ void walk_rows(
    const int* __restrict__ words, const int* __restrict__ lens,
    const uint8_t* __restrict__ is_sys, const int4* __restrict__ node_tab,
    int B, int D, int A, int tile, int* scratch, const Lookup& lookup,
    Out& out) {
  constexpr unsigned FULL = 0xffffffffu;
  const int L = lanes_per_row(A);
  const int j = threadIdx.x & (L - 1);  // this lane's slot
  const int base = threadIdx.x - j;     // the row's scratch in the block
  const unsigned lane_bits = L == 32 ? FULL : (1u << L) - 1;
  const unsigned row_bits = lane_bits << ((threadIdx.x & 31) - j);
  const int r = (tile * NFA_THREADS + threadIdx.x) / L;
  const bool in = r < B;
  const int len = in ? __ldg(lens + r) : -1;
  const bool sys = in && __ldg(is_sys + r) != 0;
  const int* row_words = words + (size_t)r * D;
  out.begin(r, row_bits);

  int s = in && j == 0 ? 0 : -1;  // {root}
  int w = 1;
  int col = 0;  // the step's first column (RawOut)
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
    out.step(in, j, w, col, hacc, eacc);
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
  out.end(in, r, j, spill);
}

// Shared memory of flat mode beside the walk's: the block's row lists
// (dynamic, flat_list_bytes) and FlatShared (static).
struct FlatShared {
  int row_off[NFA_THREADS];  // a row's nk, then its offset in the tile
  int tile, excl, total;
};

__host__ __device__ __forceinline__ size_t flat_list_bytes(int A, int K) {
  return (size_t)(NFA_THREADS / lanes_per_row(A)) * K * sizeof(int);
}

// The block's tile number, from the ticket counter; every thread of the
// block calls it first.
__device__ __forceinline__ int flat_ticket(const FlatArgs& a,
                                           FlatShared& sh) {
  if (threadIdx.x == 0)
    sh.tile = (int)(atomicAdd(reinterpret_cast<unsigned*>(a.state), 1u) -
                    a.ticket_base);
  __syncthreads();
  return sh.tile;
}

__device__ __forceinline__ unsigned long long tile_word(unsigned epoch,
                                                       unsigned flag,
                                                       int value) {
  return (unsigned long long)epoch << 32 | flag << 30 | (unsigned)value;
}


__device__ __forceinline__ int warp_sum(int v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

__device__ __forceinline__ bool tile_live(unsigned long long s,
                                          unsigned epoch) {
  return (unsigned)(s >> 32) == epoch && ((unsigned)s >> 30) != 0u;
}

// Warp 0 of the block: the sum of nk over the tiles before `tile`, by a
// decoupled look-back; `agg` is this tile's sum.  Each poll reads a
// window of 32 * NFA_LOOK_TILES predecessors at once (NFA_LOOK_TILES
// loads a lane in flight; distance d = i * 32 + lane from the nearest):
// when the tiles finish their walks together, few hold a prefix yet, and
// a window of one tile a lane would take one round trip per 32 tiles.
// A poll waits only for the tiles nearer than the nearest prefix.
__device__ __forceinline__ int look_back(const FlatArgs& a, int tile,
                                         int agg) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int WINDOW = 32 * NFA_LOOK_TILES;
  const int lane = threadIdx.x & 31;
  unsigned long long* tiles = a.state + 1;
  if (lane == 0)
    st_relaxed(tiles + tile, tile_word(a.epoch, tile == 0 ? NFA_TILE_PREFIX
                                                       : NFA_TILE_AGGREGATE,
                                    agg));
  if (tile == 0) return 0;
  int excl = 0;
  for (int p = tile - 1;; p -= WINDOW) {  // p: the nearest tile not summed
    unsigned long long s[NFA_LOOK_TILES];
    int stop;  // the distance of the nearest prefix, or WINDOW
    for (;;) {  // until every tile nearer than `stop` has published
#pragma unroll
      for (int i = 0; i < NFA_LOOK_TILES; ++i) {
        const int q = p - (i * 32 + lane);
        s[i] = q >= 0 ? ld_relaxed(tiles + q)
                      : tile_word(a.epoch, NFA_TILE_PREFIX, 0);
      }
      stop = WINDOW;
#pragma unroll
      for (int i = 0; i < NFA_LOOK_TILES; ++i) {
        const unsigned prefix = __ballot_sync(
            FULL, tile_live(s[i], a.epoch) &&
                      ((unsigned)s[i] >> 30) == NFA_TILE_PREFIX);
        if (prefix && stop == WINDOW) stop = i * 32 + __ffs(prefix) - 1;
      }
      bool ready = true;
#pragma unroll
      for (int i = 0; i < NFA_LOOK_TILES; ++i)
        ready &= i * 32 + lane >= stop || tile_live(s[i], a.epoch);
      if (__all_sync(FULL, ready)) break;
      __nanosleep(NFA_SPIN_NS);
    }
    int v = 0;
#pragma unroll
    for (int i = 0; i < NFA_LOOK_TILES; ++i)
      if (i * 32 + lane <= stop) v += (int)((unsigned)s[i] & NFA_TILE_VALUE);
    excl += warp_sum(v);
    if (stop < WINDOW) break;
  }
  if (lane == 0)
    st_relaxed(tiles + tile, tile_word(a.epoch, NFA_TILE_PREFIX, excl + agg));
  return excl;
}

// After walk_rows with FlatOut: the tile's offsets and the flat outputs
// of its rows (see the head of this file).  Every thread of the block
// calls it.
__device__ __forceinline__ void flat_finish(const FlatArgs& a,
                                            FlatShared& sh, int tile,
                                            int B, int A,
                                            const FlatOut& o) {
  constexpr unsigned FULL = 0xffffffffu;
  const int L = lanes_per_row(A);
  const int rows = NFA_THREADS / L;
  const int row = threadIdx.x / L;
  const int j = threadIdx.x & (L - 1);
  const int r = tile * rows + row;
  const int nk = min(o.got, a.K);
  if (j == 0) sh.row_off[row] = nk;
  __syncthreads();
  if (threadIdx.x < 32) {  // warp 0: scan the rows, then the tiles
    const int lane = threadIdx.x;
    const int per = (rows + 31) / 32;  // rows a lane sums: 1 to 4
    int sum = 0;
    for (int i = 0; i < per; ++i) {
      const int k = lane * per + i;
      if (k < rows) sum += sh.row_off[k];
    }
    int incl = sum;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    int run = incl - sum;
    for (int i = 0; i < per; ++i) {
      const int k = lane * per + i;
      if (k < rows) {
        const int x = sh.row_off[k];
        sh.row_off[k] = run;
        run += x;
      }
    }
    const int agg = __shfl_sync(FULL, incl, 31);
    const int excl = look_back(a, tile, agg);
    if (lane == 0) {
      sh.excl = excl;
      sh.total = excl + agg;
    }
  }
  __syncthreads();
  const int off = sh.excl + sh.row_off[row];
  if (r < B) {
    for (int i = j; i < nk; i += L)
      if (off + i < a.cap) a.matches[off + i] = o.list[i];
    if (j == 0) {
      const int mo = o.got > a.K || off + nk > a.cap ? 1 : 0;
      a.n[r] = o.got;
      a.aover[r] = o.spill;
      a.mover[r] = mo;
      a.row_meta[r] = nk | (o.spill > 0 || mo ? 1 : 0)
                               << NFA_ROW_META_SPILL_SHIFT;
    }
  }
  if (tile == (int)gridDim.x - 1) {  // the total is known: the -1 tail
    const int from = min(sh.total, a.cap);
    const int head = min(a.cap, (from + 3) & ~3);
    const int body = a.cap & ~3;
    for (int i = from + threadIdx.x; i < head; i += NFA_THREADS)
      a.matches[i] = -1;
    int4* m4 = reinterpret_cast<int4*>(a.matches);
    for (int q = head / 4 + threadIdx.x; q < body / 4; q += NFA_THREADS)
      m4[q] = make_int4(-1, -1, -1, -1);
    for (int i = max(head, body) + threadIdx.x; i < a.cap; i += NFA_THREADS)
      a.matches[i] = -1;
  }
}

// Check and, past the default 48 KB, opt in to the dynamic shared memory
// `smem` of a flat launch of `kernel`, whose static shared memory is
// `fixed` bytes.  0 or a cudaError_t.
template <class Kernel>
inline int flat_smem_optin(Kernel kernel, size_t smem, size_t fixed) {
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem + fixed > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace nfa
