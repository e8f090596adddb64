// A CPU stand-in for the CUDA features the port's kernels use, so that
// their sources build with g++ and run on the host
// (tests/test_torch_kernel_emu.py).  Every CUDA thread of a block is a
// ucontext coroutine on one host thread; the blocks of a launch run one
// after another.  A sync point (a shuffle, ballot, __syncwarp or
// __syncthreads_count) yields to a scheduler that resumes the block's
// threads in rounds, each thread up to its next sync point.  This is
// exact for code whose sync points are the same sequence in every lane
// of a warp (and of the block, for __syncthreads_count), as CUDA asks:
// after one round every lane has posted its value, after the next every
// lane has read.  __syncthreads is a real barrier: a thread waits until
// every thread of the block has arrived, and all of them leave in the
// same round, so the warps' rounds line up again after it.  It checks the
// kernels' logic (lane layout, shuffles, scans, ranks, searches, atomics
// on shared words, the flat mode's look-back over tile states), not their
// speed or memory model.  Blocks run in order, so a look-back always
// finds its predecessors published: one that would wait (a kernel's
// __nanosleep) is a fault, which ends the launch and makes
// cudaGetLastError() return cudaErrorLaunchFailure, with the reason in
// emu_fault_message(), where spinning would hang the test.  A launch
// `k<<<grid, block, smem, stream>>>(args)` is rewritten to
// `emu_launch_smem(k, grid, block, smem, args)` by the test.
#pragma once
#include <ucontext.h>

#define CUDA_EMU 1  // the sources' card-only helpers step aside

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <vector>

struct int4 {
  int x, y, z, w;
};
struct emu_dim {
  unsigned x;
};
inline emu_dim threadIdx, blockIdx, gridDim;  // set before each resume
// A kernel's `extern __shared__` array, rewritten by the test to a pointer
// into this buffer (one block runs at a time).
inline std::vector<unsigned> emu_dyn_smem;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __shared__ static  // one block runs at a time

typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorLaunchFailure = 719
};
// The fault that ended the last launch, or null.
inline const char* emu_fault;
inline int cudaGetLastError() {
  const int e = emu_fault ? (int)cudaErrorLaunchFailure : 0;
  return e;
}
extern "C" const char* emu_fault_message() {
  return emu_fault ? emu_fault : "";
}

// The device queries of a launcher: a card of EMU_SMS multiprocessors, one
// resident block each, with the H100's shared memory a block may opt in to.
#define EMU_SMS 3
enum cudaDeviceAttr {
  cudaDevAttrMaxSharedMemoryPerBlockOptin,
  cudaDevAttrMultiProcessorCount
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? EMU_SMS : 232448;
  return cudaSuccess;
}
template <class Kernel>
inline cudaError_t cudaFuncSetAttribute(Kernel, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class Kernel>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, Kernel, int, size_t) {
  *n = 1;
  return cudaSuccess;
}

// A memset on the stream: at once (one launch runs at a time).
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}

template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }
inline unsigned long long ld_relaxed(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}
inline void st_relaxed(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
// PTX fns: the position of the |offset|-th set bit of `mask` counting
// from bit `base` up (offset > 0) or down (offset < 0); offset 0 asks
// whether bit `base` is set.  0xffffffff where there is none.
inline unsigned __fns(unsigned mask, unsigned base, int offset) {
  if (offset == 0) return (mask >> base & 1u) ? base : 0xffffffffu;
  int left = (offset > 0 ? offset : -offset) - 1;
  const int step = offset > 0 ? 1 : -1;
  for (int pos = (int)base; pos >= 0 && pos < 32; pos += step)
    if (mask >> pos & 1u) {
      if (left == 0) return (unsigned)pos;
      --left;
    }
  return 0xffffffffu;
}
using std::max;
using std::min;

struct EmuThread {
  ucontext_t ctx;
  std::vector<char> stack;
  bool done;
};
inline ucontext_t emu_scheduler;
inline std::vector<EmuThread> emu_threads;
inline std::vector<int> emu_posted;  // one value per thread of the block
inline std::function<void()> emu_body;

inline void emu_yield() {
  swapcontext(&emu_threads[threadIdx.x].ctx, &emu_scheduler);
}

// Every thread posts `v`; after a round, reads with `from(posted)`.
template <class From>
inline int emu_exchange(int v, From from) {
  const unsigned me = threadIdx.x;
  emu_posted[me] = v;
  emu_yield();
  const int got = from(emu_posted.data(), me);
  emu_yield();
  return got;
}

inline int __shfl_sync(unsigned, int v, int src, int width = 32) {
  return emu_exchange(v, [=](const int* posted, unsigned me) {
    return posted[(me & ~(unsigned)(width - 1)) + (src & (width - 1))];
  });
}

inline int __shfl_xor_sync(unsigned, int v, int mask, int width = 32) {
  return emu_exchange(v, [=](const int* posted, unsigned me) {
    const unsigned lo = me & ~(unsigned)(width - 1);
    return posted[lo + (((me - lo) ^ mask) & (width - 1))];
  });
}

inline int __shfl_up_sync(unsigned, int v, unsigned delta, int width = 32) {
  return emu_exchange(v, [=](const int* posted, unsigned me) {
    const unsigned lane = me & (width - 1);
    return lane >= delta ? posted[me - delta] : posted[me];
  });
}

// Bits of the lanes in `mask` whose predicate holds (a lane outside the
// mask gives 0, as on the card).
inline unsigned __ballot_sync(unsigned mask, bool p) {
  return (unsigned)emu_exchange(p, [=](const int* posted, unsigned me) {
    const int* warp = posted + (me & ~31u);
    unsigned bits = 0;
    for (int i = 0; i < 32; ++i) bits |= (unsigned)(warp[i] != 0) << i;
    return (int)(bits & mask);
  });
}

// Whether `p` holds in every lane of the warp in `mask`.
inline bool __all_sync(unsigned mask, bool p) {
  return emu_exchange(p, [=](const int* posted, unsigned me) {
           const int* warp = posted + (me & ~31u);
           for (int i = 0; i < 32; ++i)
             if ((mask >> i & 1u) && !warp[i]) return 0;
           return 1;
         }) != 0;
}

inline void __syncwarp(unsigned = 0xffffffffu) { emu_yield(); }

inline int emu_round;           // the scheduler's pass over the block
inline int emu_arrived;         // threads at the block's current barrier
inline int emu_barrier_gen;     // barriers the block has passed
inline int emu_release_round;   // the round in which the last one opens
inline void __syncthreads() {
  const int gen = emu_barrier_gen;
  if (++emu_arrived == (int)emu_threads.size()) {
    emu_arrived = 0;
    ++emu_barrier_gen;
    emu_release_round = emu_round + 1;
  }
  do {
    emu_yield();
  } while (emu_barrier_gen == gen || emu_round < emu_release_round);
}

inline unsigned atomicAdd(unsigned* addr, unsigned v) {
  const unsigned old = *addr;
  *addr = old + v;
  return old;
}

inline int atomicAdd(int* addr, int v) {
  const int old = *addr;
  *addr = old + v;
  return old;
}

// A thread that would wait for another block: blocks run in order here,
// so what it waits for never comes.  Ends the launch with a fault.
inline void __nanosleep(unsigned) {
  emu_fault =
      "a look-back waited on a tile that has not published: blocks run "
      "in order here, so a ticket ahead of its block's turn (or a tile "
      "that never publishes) would wait forever";
  for (;;) emu_yield();  // the scheduler does not resume a faulted launch
}

inline unsigned atomicOr(unsigned* addr, unsigned v) {
  const unsigned old = *addr;
  *addr = old | v;
  return old;
}

inline int __syncthreads_count(bool p) {
  return emu_exchange(p, [](const int* posted, unsigned) {
    int n = 0;
    for (size_t i = 0; i < emu_threads.size(); ++i) n += posted[i] != 0;
    return n;
  });
}

inline void emu_entry() {
  emu_body();
  emu_threads[threadIdx.x].done = true;
}  // returns to emu_scheduler through uc_link

template <class Kernel, class... Args>
void emu_launch(Kernel kernel, int grid, int block, Args... args) {
  emu_body = [=] { kernel(args...); };
  emu_fault = nullptr;
  gridDim.x = grid;
  emu_threads = std::vector<EmuThread>(block);
  emu_posted.assign(block, 0);
  for (int b = 0; b < grid && !emu_fault; ++b) {
    blockIdx.x = b;
    for (auto& t : emu_threads) {
      t.stack.assign(1 << 16, 0);
      t.done = false;
      getcontext(&t.ctx);
      t.ctx.uc_stack.ss_sp = t.stack.data();
      t.ctx.uc_stack.ss_size = t.stack.size();
      t.ctx.uc_link = &emu_scheduler;
      makecontext(&t.ctx, emu_entry, 0);
    }
    emu_arrived = 0;
    for (int live = block; live > 0 && !emu_fault; ++emu_round) {
      for (int t = 0; t < block && !emu_fault; ++t) {
        if (emu_threads[t].done) continue;
        threadIdx.x = t;
        swapcontext(&emu_scheduler, &emu_threads[t].ctx);
        live -= emu_threads[t].done;
      }
    }
  }
}

// `k<<<grid, block, smem, stream>>>(args)` with dynamic shared memory.
template <class Kernel, class... Args>
void emu_launch_smem(Kernel kernel, int grid, int block, size_t smem,
                     Args... args) {
  emu_dyn_smem.assign((smem + sizeof(unsigned) - 1) / sizeof(unsigned),
                      0xdeadbeefu);
  emu_launch(kernel, grid, block, args...);
}
