// K5: the Galois key-switch tail. From the substituted c0 (s0, NTT domain)
// and the inverse NTT of the substituted c1 (c2, power basis) it computes,
// in the NTT domain,
//   out0 = s0 + sum_i NTT(d_i) ksk0_i,  out1 = sum_i NTT(d_i) ksk1_i
// where d_i is c2's limb i reduced modulo the block's limb p_j (fhe.rs
// galois_key.rs:62-87 with key_switching_key.rs:214-241).
//
// Replaces tpufhe/ops/pallas/mxu_ntt_kernel.py:_relin_tail_kernel in mode
// "rotate" (wrapper rotate_tail_pallas). As there, s0 rides along
// untransformed and is added to the first accumulator; as in K4, c2's
// limb i is read directly and reduced mod p_j in the block, so the k x k
// digit broadcast never exists.
//
// Data: s0, c2 (rows, k, n) canonical; ksk0, ksk0_shoup, ksk1, ksk1_shoup
// (k, k, n) with [i][j] = decomposition row i, limb j; out (2, rows, k, n).
// One thread block per (row, limb j) with three shared rows of n words
// (192 KB at n = 8192): the work row and the two accumulators of
// keyswitch_device.cuh, which K4 shares.
//
// Bound on this card: per (row, limb) coefficient it reads 16 bytes of
// ciphertext and 32 k bytes of key (shared by all rows, so it stays in L2)
// and writes 16; it runs k forward transforms, so at n = 8192 the
// integer-multiply bound is about twice the memory bound. As in K4, one
// 1024-thread block per SM and the stage barriers limit this simple
// design first.
#include <cuda_runtime.h>

#include "keyswitch_device.cuh"

__global__ void rotate_tail_kernel(const u64* __restrict__ s0,
                                   const u64* __restrict__ c2,
                                   u64* __restrict__ out, long long plane,
                                   int k, int n, int logn,
                                   const u64* __restrict__ k0,
                                   const u64* __restrict__ k0s,
                                   const u64* __restrict__ k1,
                                   const u64* __restrict__ k1s,
                                   const u64* __restrict__ w,
                                   const u64* __restrict__ ws,
                                   const u64* __restrict__ limb_p,
                                   const u64* __restrict__ b_lo,
                                   const u64* __restrict__ b_hi) {
  extern __shared__ u64 smem[];
  u64* buf = smem;
  u64* acc0 = smem + n;
  u64* acc1 = smem + 2 * n;
  const long long blk = blockIdx.x;
  const long long row = blk / k;
  const int j = (int)(blk - row * k);
  const Barrett br = {limb_p[j], b_lo[j], b_hi[j]};
  const u64 p = br.p;

  keyswitch_accumulate(c2 + row * k * n, k, j, n, logn, br,
                       w + (long long)j * n, ws + (long long)j * n, k0, k0s,
                       k1, k1s, buf, acc0, acc1);

  const u64* src = s0 + blk * n;
  u64* dst0 = out + blk * n;
  u64* dst1 = out + plane + blk * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    dst0[e] = add_mod(src[e], acc0[e], p);
    dst1[e] = acc1[e];
  }
}

// rows_k = rows * k blocks; plane = rows * k * n words per output part.
extern "C" int tpufhe_rotate_tail(const void* s0, const void* c2, void* out,
                                  long long rows_k, int k, int n,
                                  const void* k0, const void* k0s,
                                  const void* k1, const void* k1s,
                                  const void* w, const void* ws,
                                  const void* limb_p, const void* b_lo,
                                  const void* b_hi, void* stream) {
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  const size_t smem = 3 * (size_t)n * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(rotate_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = n / 2 < 1024 ? n / 2 : 1024;
  const long long plane = rows_k * n;
  rotate_tail_kernel<<<(unsigned)rows_k, threads, smem, (cudaStream_t)stream>>>((const u64*)s0, (const u64*)c2, (u64*)out, plane, k, n, logn, (const u64*)k0, (const u64*)k0s, (const u64*)k1, (const u64*)k1s, (const u64*)w, (const u64*)ws, (const u64*)limb_p, (const u64*)b_lo, (const u64*)b_hi);
  return (int)cudaGetLastError();
}
