// K1: forward / inverse negacyclic NTT of a batch of RNS rows.
//
// Replaces tpufhe/ops/pallas/mxu_ntt_kernel.py:_mxu4_kernel (wrapper
// mxu4_pallas), which computes the same transform on the TPU as a
// four-step product of int8 digit planes so that the matrix unit can do
// the work. Hopper has 64-bit integer multiplies on every core, so this
// kernel runs the radix-2 Harvey butterflies directly.
//
// Data: x (rows, k_sel, n) int64 words read as u64, canonical residues.
// One thread block per (row, limb): the row is loaded once into shared
// memory (n words; 64 KB at n = 8192, so dynamic shared memory above the
// 48 KB default), transformed in place through log2(n) stages with one
// __syncthreads each, and written once. Twiddles and their Shoup constants
// come from the per-limb global tables (limb0 + j selects the table row,
// the counterpart of limb_slice); they are shared by all rows of a limb and
// stay in L2.
//
// Bound on this card: each element moves 16 bytes through device memory
// and needs about 3 log2(n) / 2 + 3 64-bit products (about 4 int32
// multiplies each), so at n = 8192 the memory and integer-multiply
// bounds are of the same order. The simple design is limited first by
// shared-memory traffic and by the stage barriers; it keeps the transform
// out of device memory, which is what matters for the memory bound.
#include <cuda_runtime.h>

#include "ntt_device.cuh"

__global__ void ntt_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                           int k_sel, int n, int logn,
                           const u64* __restrict__ tw,
                           const u64* __restrict__ tws,
                           const u64* __restrict__ limb_p,
                           const u64* __restrict__ ninv,
                           const u64* __restrict__ ninv_s, int limb0,
                           int inverse) {
  extern __shared__ u64 smem[];
  const long long blk = blockIdx.x;
  const int limb = limb0 + (int)(blk % k_sel);
  const u64 p = limb_p[limb];
  const u64* src = x + blk * n;
  u64* dst = y + blk * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) smem[i] = src[i];
  __syncthreads();
  const u64* t = tw + (long long)limb * n;
  const u64* ts = tws + (long long)limb * n;
  if (inverse) {
    ntt_inverse_rows(smem, 1, n, logn, t, ts, ninv[limb], ninv_s[limb], p);
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = smem[i];
  } else {
    ntt_forward_rows(smem, 1, n, logn, t, ts, p);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      dst[i] = canon4(smem[i], p);
  }
}

// rows: number of (row, limb) blocks = batch rows * k_sel.
// tw / tws: (k_ctx, n) tables of the direction (omegas for forward,
// zetas_inv for inverse); limb_p, ninv, ninv_s: (k_ctx,) per limb.
extern "C" int tpufhe_ntt(const void* x, void* y, long long rows, int k_sel,
                          int n, const void* tw, const void* tws,
                          const void* limb_p, const void* ninv,
                          const void* ninv_s, int limb0, int inverse,
                          void* stream) {
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  const size_t smem = (size_t)n * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(ntt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = n / 2 < 512 ? n / 2 : 512;
  ntt_kernel<<<(unsigned)rows, threads, smem, (cudaStream_t)stream>>>((const u64*)x, (u64*)y, k_sel, n, logn, (const u64*)tw, (const u64*)tws, (const u64*)limb_p, (const u64*)ninv, (const u64*)ninv_s, limb0, inverse);
  return (int)cudaGetLastError();
}
