// The asynchronous copies of cuda_pipeline.h (cp.async) on the stand-in
// runtime of cuda_runtime.h. A copy is only queued when it is started; each
// CUDA thread's copies form a group at __pipeline_commit(), and
// __pipeline_wait_prior(n) carries out the thread's groups older than its n
// newest, as the card guarantees them complete there. A kernel that reads a
// stage before waiting for it reads what was there before, as it could on
// the card.
#pragma once
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "cuda_runtime.h"

namespace emu {
struct AsyncCopy {
  void* dst;
  const void* src;
  size_t size;
};
struct AsyncThread {
  std::vector<AsyncCopy> open;
  std::vector<std::vector<AsyncCopy>> groups;  // oldest first
};
// the CUDA threads of the CTA on this OS thread
inline thread_local std::vector<AsyncThread> async_threads;
inline AsyncThread& async_thread() {
  if (async_threads.size() <= threadIdx.x)
    async_threads.resize(threadIdx.x + 1);
  return async_threads[threadIdx.x];
}
}  // namespace emu

// a copy of 4, 8 or 16 bytes between addresses aligned to its size; the
// card faults on any other, so the stand-in stops the process
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size,
                                    size_t = 0) {
  if ((size != 4 && size != 8 && size != 16) || (size_t)dst % size ||
      (size_t)src % size) {
    std::fprintf(stderr, "cp.async of %zu bytes from %p to %p\n", size, src,
                 dst);
    std::abort();
  }
  emu::async_thread().open.push_back({dst, src, size});
}

inline void __pipeline_commit() {
  emu::AsyncThread& t = emu::async_thread();
  t.groups.push_back(std::move(t.open));
  t.open.clear();
}

inline void __pipeline_wait_prior(size_t n) {
  emu::AsyncThread& t = emu::async_thread();
  while (t.groups.size() > n) {
    for (const emu::AsyncCopy& c : t.groups.front())
      std::memcpy(c.dst, c.src, c.size);
    t.groups.erase(t.groups.begin());
  }
}
