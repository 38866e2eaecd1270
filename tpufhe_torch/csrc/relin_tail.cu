// K4: the relinearization tail. From the down-scaled power-basis rows
// (c0, c1, c2) it computes, in the NTT domain,
//   out0 = NTT(c0) + sum_i NTT(d_i) ksk0_i,  out1 = NTT(c1) + sum_i NTT(d_i) ksk1_i
// where d_i is c2's limb i reduced modulo the block's limb p_j (the Garner
// decomposition of fhe.rs key_switching_key.rs:214-241).
//
// Replaces tpufhe/ops/pallas/mxu_ntt_kernel.py:_relin_tail_kernel in mode
// "relin" (wrapper relin_tail_pallas). That kernel reads the k x k
// broadcast rows of pipeline._ksk_digits; this one reads c2's limb i
// directly and reduces it mod p_j itself, so the broadcast never exists.
//
// Data: dsc (3, rows, k, n) canonical; ksk0, ksk0_shoup, ksk1, ksk1_shoup
// (k, k, n) with [i][j] = decomposition row i, limb j; out (2, rows, k, n).
// One thread block per (row, limb j), with three shared rows of n words
// (192 KB at n = 8192): a work row that is forward-transformed in turn for
// d_0 .. d_{k-1}, c0 and c1, and the two key-switch accumulators. The
// lifted rows and the accumulators never reach device memory. The digit
// lift and accumulate loop is keyswitch_device.cuh, shared with K5.
//
// Bound on this card: per (row, limb) coefficient it reads 24 bytes of
// ciphertext and 32 k bytes of key (the key is shared by all rows and
// stays in L2) and writes 16; it runs k + 2 forward transforms, so at
// n = 8192 the integer-multiply bound is about twice the memory bound.
// As in K3, one 1024-thread block per SM and the stage barriers limit this
// simple design first.
#include <cuda_runtime.h>

#include "keyswitch_device.cuh"

__global__ void relin_tail_kernel(const u64* __restrict__ dsc,
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
  const u64* tw = w + (long long)j * n;
  const u64* tws = ws + (long long)j * n;
  const u64* c2 = dsc + 2 * plane + row * k * n;  // limb i at c2 + i n

  keyswitch_accumulate(c2, k, j, n, logn, br, tw, tws, k0, k0s, k1, k1s, buf,
                       acc0, acc1);

  for (int part = 0; part < 2; ++part) {
    const u64* src = dsc + part * plane + blk * n;
    const u64* acc = part ? acc1 : acc0;
    for (int e = threadIdx.x; e < n; e += blockDim.x) buf[e] = src[e];
    __syncthreads();
    ntt_forward_rows(buf, 1, n, logn, tw, tws, p);
    u64* dst = out + part * plane + blk * n;
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      dst[e] = add_mod(canon4(buf[e], p), acc[e], p);
    __syncthreads();
  }
}

// rows_k = rows * k blocks; plane = rows * k * n words per part.
extern "C" int tpufhe_relin_tail(const void* dsc, void* out, long long rows_k,
                                 int k, int n, const void* k0,
                                 const void* k0s, const void* k1,
                                 const void* k1s, const void* w,
                                 const void* ws, const void* limb_p,
                                 const void* b_lo, const void* b_hi,
                                 void* stream) {
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  const size_t smem = 3 * (size_t)n * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(relin_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = n / 2 < 1024 ? n / 2 : 1024;
  const long long plane = rows_k * n;
  relin_tail_kernel<<<(unsigned)rows_k, threads, smem, (cudaStream_t)stream>>>((const u64*)dsc, (u64*)out, plane, k, n, logn, (const u64*)k0, (const u64*)k0s, (const u64*)k1, (const u64*)k1s, (const u64*)w, (const u64*)ws, (const u64*)limb_p, (const u64*)b_lo, (const u64*)b_hi);
  return (int)cudaGetLastError();
}
