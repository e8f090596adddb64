// The stand-in's asynchronous copies (tests/cuda_emu/cuda_runtime.h):
// `__pipeline_memcpy_async` copies at once, so commit and wait have
// nothing left to do.
#pragma once
#include <cuda_runtime.h>

#include <cstring>

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size,
                                    size_t zfill = 0) {
  std::memcpy(dst, src, size - zfill);
  std::memset(static_cast<char*>(dst) + size - zfill, 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
