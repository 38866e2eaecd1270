// K7: the degree-2 tensor product in the NTT domain,
//   c0 = a0 b0,  c1 = a0 b1 + a1 b0,  c2 = a1 b1  (mod p_j),
// elementwise over (rows, k, n) canonical residues (fhe.rs
// bfv/ops/mod.rs:318-325). The square + relinearize forms its tensor here,
// with (a0, a1, a0, a1) as operands.
//
// Replaces tpufhe/ops/pallas/tensor_kernel.py:_tensor_kernel (wrapper
// tensor_product_pallas), which reads each operand block into VMEM once
// per (limb, batch tile) and writes the three stacked parts. Here one
// thread per coefficient reads its four operand words once, forms the
// products with mul_mod / mul_add_mod of modarith.cuh (64 x 64 -> 128-bit
// products, one Barrett reduction per part, as tensor_intt.cu does) and
// writes the three parts once into out (3, rows, k, n). tpufhe's
// Karatsuba form (TPUFHE_TENSOR_KARA) gives the same canonical outputs, so
// this kernel has no switch for it.
//
// Bound on this card: 56 bytes of traffic per coefficient (40 when the
// operands repeat, as in the square: the second read of a word hits L1)
// against about 100 int32 multiplies; the memory bound is about three
// times the multiply bound, so this is a streaming pass: loads and stores
// coalesced along n, no shared memory.
#include <cuda_runtime.h>

#include "modarith.cuh"

__global__ void tensor_kernel(const u64* __restrict__ a0,
                              const u64* __restrict__ a1,
                              const u64* __restrict__ b0,
                              const u64* __restrict__ b1,
                              u64* __restrict__ out, long long total, int k,
                              int n, const u64* __restrict__ limb_p,
                              const u64* __restrict__ b_lo,
                              const u64* __restrict__ b_hi) {
  // blockIdx.x: one (row, limb) pair; blockIdx.y: a chunk of its n words
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int j = (int)(blockIdx.x % k);
  const long long idx = (long long)blockIdx.x * n + e;
  const Barrett br = {limb_p[j], b_lo[j], b_hi[j]};
  const u64 x0 = a0[idx], x1 = a1[idx], y0 = b0[idx], y1 = b1[idx];
  out[idx] = mul_mod(x0, y0, br);
  out[total + idx] = mul_add_mod(x0, y1, x1, y0, br);
  out[2 * total + idx] = mul_mod(x1, y1, br);
}

// rows_k = rows * k (row, limb) pairs of n words each per operand.
extern "C" int tpufhe_tensor(const void* a0, const void* a1, const void* b0,
                             const void* b1, void* out, long long rows_k,
                             int k, int n, const void* limb_p,
                             const void* b_lo, const void* b_hi,
                             void* stream) {
  const int threads = n < 256 ? n : 256;
  const dim3 grid((unsigned)rows_k, (unsigned)((n + threads - 1) / threads));
  const long long total = rows_k * n;
  tensor_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>((const u64*)a0, (const u64*)a1, (const u64*)b0, (const u64*)b1, (u64*)out, total, k, n, (const u64*)limb_p, (const u64*)b_lo, (const u64*)b_hi);
  return (int)cudaGetLastError();
}
