// A CPU stand-in for the parts of the CUDA runtime that the port's pass
// kernels (csrc/ntt.cu, ntt32.cu, tensor_intt.cu, intt_scale.cu,
// relin_tail.cu, rotate_tail.cu), ct_pt_dot.cu and ks_accumulate.cu use,
// so that their sources compile with g++ and run on the host:
//
//   g++ -std=c++17 -shared -fPIC -I tests/cuda_emu -include cuda_runtime.h \
//       -x c++ tpufhe_torch/csrc/ntt.cu -x none tests/cuda_emu/emu.cpp
//
// cudaLaunchKernelEx runs the grid one cluster at a time: each CTA of a
// cluster is an OS thread, each CUDA thread of a CTA a fiber that yields
// at __syncthreads(), and cluster.sync() is a barrier across the cluster's
// OS threads. A CTA's dynamic shared memory is its OS thread's `row` (the
// name every one of those kernels gives its extern __shared__ array), and
// map_shared_rank maps an address into another CTA's `row`. Fibers switch
// only at barriers, so a missing barrier shows as a wrong result; what the
// stand-in cannot show is a race the card's scheduling would expose, or
// anything about speed.
#pragma once
#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <tuple>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ __thread
#define __grid_constant__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) ulonglong2 {
  unsigned long long x, y;
};
inline ulonglong2 make_ulonglong2(unsigned long long a, unsigned long long b) {
  return {a, b};
}
struct alignas(8) uint2 {
  unsigned x, y;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
template <class T>
inline T min(T a, T b) {
  return a < b ? a : b;
}
template <class T>
inline T max(T a, T b) {
  return a > b ? a : b;
}

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributeNonPortableClusterSizeAllowed
};
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct {
    struct {
      unsigned x, y, z;
    } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// occupancy has no meaning off the card
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, F, int,
                                                                 size_t) {
  return cudaErrorInvalidValue;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveClusters(int*, F,
                                                  const cudaLaunchConfig_t*) {
  return cudaErrorInvalidValue;
}

struct uint3e {
  unsigned x, y, z;
};
extern thread_local uint3e threadIdx, blockIdx;
extern uint3e blockDim;

namespace emu {
void syncthreads();
void cluster_sync();
unsigned cluster_rank();
unsigned cluster_size();
void* cluster_map(void* p, unsigned rank);
void run(unsigned grid, unsigned block, unsigned cluster, void (*body)(void*),
         void* ctx);
}  // namespace emu

inline void __syncthreads() { emu::syncthreads(); }

template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(P...), A&&... args) {
  unsigned cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cluster = cfg->attrs[i].val.clusterDim.x;
  struct Launch {
    void (*kernel)(P...);
    std::tuple<std::decay_t<A>...> args;
  } launch{kernel, {args...}};
  emu::run(cfg->gridDim.x, cfg->blockDim.x, cluster,
           [](void* p) {
             auto* l = (Launch*)p;
             std::apply(l->kernel, l->args);
           },
           &launch);
  return cudaSuccess;
}

// The triple-chevron launch, which g++ cannot parse: a source that uses it
// is compiled after `kernel<<<grid, block, shmem, stream>>>(args)` is
// rewritten as `emu_chevron(kernel, grid, block, shmem, stream)(args)`.
template <class... P>
auto emu_chevron(void (*kernel)(P...), dim3 grid, dim3 block,
                 size_t shmem = 0, cudaStream_t stream = nullptr) {
  return [=](auto&&... args) {
    cudaLaunchConfig_t cfg{grid, block, shmem, stream, nullptr, 0};
    cudaLaunchKernelEx(&cfg, kernel, args...);
  };
}
