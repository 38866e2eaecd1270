// The fibers, barriers and clusters behind cuda_runtime.h's stand-in.
#include <ucontext.h>

#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <mutex>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

// a CTA's dynamic shared memory: 128 KB, the most one of the kernels uses
__thread unsigned long long row[1 << 14];
thread_local uint3e threadIdx, blockIdx;
uint3e blockDim;

namespace emu {

struct Cluster {
  unsigned size;
  std::vector<char*> base;  // each CTA's row
  std::mutex m;
  std::condition_variable cv;
  unsigned arrived = 0, gen = 0;
  void barrier() {
    std::unique_lock<std::mutex> lock(m);
    const unsigned g = gen;
    if (++arrived == size) {
      arrived = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return gen != g; });
    }
  }
};

struct Cta {
  ucontext_t main;
  std::vector<ucontext_t> fibers;
  std::vector<std::vector<char>> stacks;
  std::vector<char> done;
  unsigned current = 0, arrived = 0, gen = 0, rank = 0;
  Cluster* cluster = nullptr;
  void (*body)(void*) = nullptr;
  void* ctx = nullptr;
};

thread_local Cta* cta;

// every fiber of the CTA arrives before any leaves; the last to arrive at a
// cluster barrier also waits for the cluster's other CTAs
static void barrier(bool cluster) {
  Cta* c = cta;
  const unsigned g = c->gen;
  if (++c->arrived == c->fibers.size()) {
    if (cluster) c->cluster->barrier();
    c->arrived = 0;
    ++c->gen;
    return;
  }
  while (c->gen == g) swapcontext(&c->fibers[c->current], &c->main);
}

void syncthreads() { barrier(false); }
void cluster_sync() { barrier(true); }
unsigned cluster_rank() { return cta->rank; }
unsigned cluster_size() { return cta->cluster->size; }
void* cluster_map(void* p, unsigned rank) {
  Cluster* cl = cta->cluster;
  return cl->base[rank] + ((char*)p - cl->base[cta->rank]);
}

static void fiber_entry() {
  cta->body(cta->ctx);
  cta->done[cta->current] = 1;
}

static void run_cta(Cluster* cl, unsigned rank, unsigned block, unsigned b,
                    void (*body)(void*), void* ctx) {
  Cta c;
  c.rank = rank;
  c.cluster = cl;
  c.body = body;
  c.ctx = ctx;
  cta = &c;
  blockIdx = {b, 0, 0};
  cl->base[rank] = (char*)row;
  c.fibers.resize(block);
  c.stacks.resize(block);
  c.done.assign(block, 0);
  for (unsigned t = 0; t < block; ++t) {
    c.stacks[t].resize(1 << 16);
    getcontext(&c.fibers[t]);
    c.fibers[t].uc_stack.ss_sp = c.stacks[t].data();
    c.fibers[t].uc_stack.ss_size = c.stacks[t].size();
    c.fibers[t].uc_link = &c.main;
    makecontext(&c.fibers[t], fiber_entry, 0);
  }
  cl->barrier();  // every CTA's row is known before any fiber runs
  for (bool any = true; any;) {
    any = false;
    for (unsigned t = 0; t < block; ++t) {
      if (c.done[t]) continue;
      any = true;
      c.current = t;
      threadIdx = {t, 0, 0};
      swapcontext(&c.main, &c.fibers[t]);
    }
  }
}

void run(unsigned grid, unsigned block, unsigned cluster, void (*body)(void*),
         void* ctx) {
  blockDim = {block, 1, 1};
  for (unsigned first = 0; first < grid; first += cluster) {
    Cluster cl;
    cl.size = cluster;
    cl.base.resize(cluster);
    std::vector<std::thread> ctas;
    for (unsigned r = 0; r < cluster; ++r)
      ctas.emplace_back(run_cta, &cl, r, block, first + r, body, ctx);
    for (auto& t : ctas) t.join();
  }
}

}  // namespace emu
