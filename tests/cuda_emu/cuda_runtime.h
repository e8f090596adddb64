// A CPU stand-in for the CUDA features the walk kernels use, so that
// their sources build with g++ and run on the host
// (tests/test_torch_kernel_emu.py).  Every CUDA thread of a block is a
// ucontext coroutine on one host thread; the blocks of a launch run one
// after another.  A sync point (a shuffle, ballot, __syncwarp or
// __syncthreads_count) yields to a scheduler that resumes the block's
// threads in rounds, each thread up to its next sync point.  This is
// exact for code whose sync points are the same sequence in every lane
// of a warp (and of the block, for __syncthreads_count), as CUDA asks:
// after one round every lane has posted its value, after the next every
// lane has read.  It checks the kernels' logic (lane layout, shuffles,
// ranks, searches), not their speed or memory model.  A launch
// `k<<<grid, block, 0, stream>>>(args)` is rewritten to
// `emu_launch(k, grid, block, args)` by the test.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cstdint>
#include <functional>
#include <vector>

struct int4 {
  int x, y, z, w;
};
struct emu_dim {
  unsigned x;
};
inline emu_dim threadIdx, blockIdx;  // set before each resume

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __shared__ static  // one block runs at a time

typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }

template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
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

inline unsigned __ballot_sync(unsigned, bool p) {
  return (unsigned)emu_exchange(p, [](const int* posted, unsigned me) {
    const int* warp = posted + (me & ~31u);
    unsigned bits = 0;
    for (int i = 0; i < 32; ++i) bits |= (unsigned)(warp[i] != 0) << i;
    return (int)bits;
  });
}

inline void __syncwarp(unsigned = 0xffffffffu) { emu_yield(); }

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
  emu_threads = std::vector<EmuThread>(block);
  emu_posted.assign(block, 0);
  for (int b = 0; b < grid; ++b) {
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
    for (int live = block; live > 0;) {
      for (int t = 0; t < block; ++t) {
        if (emu_threads[t].done) continue;
        threadIdx.x = t;
        swapcontext(&emu_scheduler, &emu_threads[t].ctx);
        live -= emu_threads[t].done;
      }
    }
  }
}
