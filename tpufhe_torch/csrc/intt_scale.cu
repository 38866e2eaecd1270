// K8: the inverse NTT of every limb of a row fused with the HPS base
// conversion and scaling: rns_scale(ntt_backward(x)) in one launch, the
// extend step of a multiplication.
//
// Replaces tpufhe/ops/pallas/intt_scale_kernel.py:_intt_scale_kernel
// (wrapper intt_scale_pallas), which inverse-transforms a batch tile of
// rows with the four-step int8 matmul NTT and feeds the byte planes of the
// result to the digit-plane scaler, with all limbs' constants resident in
// VMEM.
//
// Data: x (rows, k_in, n) NTT-domain canonical residues of the `from`
// basis; out (rows, size, n) power-basis residues of the `to` basis, rows
// start .. start + size - 1. One thread block per batch row: its k_in limbs
// are loaded once into shared memory (k_in n words: 192 KB for 3 limbs at
// n = 8192), inverse-transformed in lockstep, each limb with its own
// modulus and twiddles (one barrier per stage for all limbs), and then
// each thread runs the scaler body of rns_scale_device.cuh (its general
// form, rns_scale_chunked, shared with K2) on the residues of its
// coefficients, read from shared memory in chunks, and writes the size
// outputs once. The power-basis residues never reach device memory.
//
// Bound on this card: per coefficient it reads 8 k_in bytes and writes
// 8 size bytes; it runs k_in inverse transforms (3 log2(n) / 2 + 3 64-bit
// products per element) and the scaler's products, so at n = 8192 the
// integer-multiply bound is the larger. One block fills an SM's shared
// memory, so 512 threads per block (up to 128 registers each) and one wave
// of rows per 132 blocks.
#include <cuda_runtime.h>

#include "ntt_device.cuh"
#include "rns_scale_device.cuh"

#define INTT_SCALE_THREADS 512

__global__ void __launch_bounds__(INTT_SCALE_THREADS, 1)
    intt_scale_kernel(const u64* __restrict__ x, u64* __restrict__ y, int k_in,
                      int n, int logn, const u64* __restrict__ zi,
                      const u64* __restrict__ zis,
                      const u64* __restrict__ limb_p,
                      const u64* __restrict__ ninv,
                      const u64* __restrict__ ninv_s,
                      const u64* __restrict__ tab, int size, int shift,
                      int is_one, int theta_gamma_sign) {
  extern __shared__ u64 smem[];
  const long long row = blockIdx.x;
  const u64* src = x + row * k_in * n;
  for (int e = threadIdx.x; e < k_in * n; e += blockDim.x) smem[e] = src[e];
  __syncthreads();
  ntt_inverse_limbs(smem, k_in, n, logn, zi, zis, ninv, ninv_s, limb_p);
  u64* dst = y + row * size * n;
  for (int c = threadIdx.x; c < n; c += blockDim.x)
    rns_scale_chunked<K2_CHUNK>(smem + c, (long long)n, k_in, tab, size,
                                shift, is_one, theta_gamma_sign, dst + c,
                                (long long)n);
}

// rows: batch rows (one block each). zi / zis: the `from` context's
// (k_in, n) inverse twiddles; limb_p, ninv, ninv_s: its (k_in,) scalars;
// tab: the scaler's table for the outputs start .. start + size - 1
// (layout in rns_scale_device.cuh).
extern "C" int tpufhe_intt_scale(const void* x, void* y, long long rows,
                                 int k_in, int n, const void* zi,
                                 const void* zis, const void* limb_p,
                                 const void* ninv, const void* ninv_s,
                                 const void* tab, int size, int shift,
                                 int is_one, int theta_gamma_sign,
                                 void* stream) {
  if (k_in < 1) return (int)cudaErrorInvalidValue;
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  const size_t smem = (size_t)k_in * n * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(intt_scale_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = n / 2 < INTT_SCALE_THREADS ? n / 2 : INTT_SCALE_THREADS;
  intt_scale_kernel<<<(unsigned)rows, threads, smem, (cudaStream_t)stream>>>((const u64*)x, (u64*)y, k_in, n, logn, (const u64*)zi, (const u64*)zis, (const u64*)limb_p, (const u64*)ninv, (const u64*)ninv_s, (const u64*)tab, size, shift, is_one, theta_gamma_sign);
  return (int)cudaGetLastError();
}
