// K2: HPS RNS base conversion with rational scaling (fhe.rs
// rns/scaler.rs:249-352), one thread per (row, coefficient).
//
// Replaces tpufhe/ops/pallas/rns_kernel.py:_scale_kernel_bc (core
// _scale_core_bc; _scale_kernel under TPUFHE_BC_SCALER=0), which forms the
// three per-coefficient inner products as int8 digit-plane matmuls for the
// TPU's matrix unit. Here each thread keeps its k_in residues in registers
// and runs the exact integer body of rns_scale_device.cuh (shared with the
// fused inverse NTT + scale, K8) on them. The same kernel serves tpufhe's
// XLA narrow scaler (tpufhe/ops/rns.py, the `narrow` branch of scale):
// instantiated for 32-bit words it loads and stores the int32 rows of
// narrow (w30) contexts, with the same 64-bit arithmetic in registers.
//
// Data: x (rows, k_in, n), out (rows, size, n), int64 words read as u64
// (or int32 words read as u32). Loads and stores are coalesced along n.
// The constant table (a few dozen words) is read by every thread and stays
// in L1.
//
// Bound on this card: per coefficient it reads 8 k_in bytes and writes
// 8 size bytes (4 each for 32-bit words), and does roughly
// 8 k_in + 8 + size (3 k_in + 15) 64-bit products. At the main path's
// shapes both bounds are a few tens of microseconds; with no shared memory
// and no barriers the kernel is a plain streaming pass, limited by the
// integer multiplies' issue rate.
#include <cuda_runtime.h>

#include "rns_scale_device.cuh"

template <typename W>
__global__ void rns_scale_kernel(const W* __restrict__ x, W* __restrict__ y,
                                 long long total, int n, int k_in,
                                 const u64* __restrict__ tab, int start,
                                 int size, int shift, int is_one,
                                 int theta_gamma_sign) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long row = idx / n;
  const int c = (int)(idx - row * n);

  u64 r[MAX_K_IN];
#pragma unroll
  for (int i = 0; i < MAX_K_IN; ++i)
    if (i < k_in) r[i] = x[(row * k_in + i) * n + c];
  rns_scale_coeff(r, k_in, tab, start, size, shift, is_one, theta_gamma_sign,
                  y + row * size * n + c, n);
}

// total = rows * n coefficients; word_bytes = 8 for int64 rows, 4 for the
// int32 rows of narrow contexts.
extern "C" int tpufhe_rns_scale(const void* x, void* y, long long total,
                                int n, int k_in, const void* tab, int start,
                                int size, int shift, int is_one,
                                int theta_gamma_sign, int word_bytes,
                                void* stream) {
  if (k_in > MAX_K_IN || k_in < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (word_bytes == 8) {
    rns_scale_kernel<u64><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>((const u64*)x, (u64*)y, total, n, k_in, (const u64*)tab, start, size, shift, is_one, theta_gamma_sign);
  } else if (word_bytes == 4) {
    rns_scale_kernel<u32><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>((const u32*)x, (u32*)y, total, n, k_in, (const u64*)tab, start, size, shift, is_one, theta_gamma_sign);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
