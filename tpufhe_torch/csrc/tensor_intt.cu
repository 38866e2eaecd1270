// K3: degree-2 tensor product in the NTT domain fused with the inverse NTT
// of its three parts, over the multiplication basis.
//
// Replaces tpufhe/ops/pallas/mxu_ntt_kernel.py:_tensor_intt_kernel
// (wrapper tensor_intt_pallas), which forms the tensor rows in VMEM and
// inverse-transforms them with the four-step int8 matmul NTT.
//
// Data: ext (4, rows, k, n) holding a0, a1, b0, b1 in NTT form; out
// (3, rows, k, n) holding c0 = a0 b0, c1 = a0 b1 + a1 b0, c2 = a1 b1 mod p
// in power basis. One thread block per (row, limb): each operand word is
// read once, the three products are reduced into three shared-memory rows
// (3 n words: 192 KB at n = 8192, under the 227 KB a block may use), the
// rows are inverse-transformed in lockstep (one barrier per stage for all
// three) and each output word is written once. The tensor never reaches
// device memory.
//
// Bound on this card: 56 bytes of traffic per coefficient (4 reads, 3
// writes) against about 8 + 3 (3 log2(n) / 2 + 3) 64-bit products; at
// n = 8192 the two bounds are close. With one 1024-thread block per SM
// (shared memory allows no second) the barriers of the 13 stages are
// the first limit of this simple design.
#include <cuda_runtime.h>

#include "ntt_device.cuh"

__global__ void tensor_intt_kernel(const u64* __restrict__ ext,
                                   u64* __restrict__ out, long long plane,
                                   int k, int n, int logn,
                                   const u64* __restrict__ zi,
                                   const u64* __restrict__ zis,
                                   const u64* __restrict__ limb_p,
                                   const u64* __restrict__ b_lo,
                                   const u64* __restrict__ b_hi,
                                   const u64* __restrict__ ninv,
                                   const u64* __restrict__ ninv_s) {
  extern __shared__ u64 smem[];
  const long long blk = blockIdx.x;
  const int j = (int)(blk % k);
  const Barrett br = {limb_p[j], b_lo[j], b_hi[j]};
  const u64* a0 = ext + blk * n;
  const u64* a1 = a0 + plane;
  const u64* b0 = a1 + plane;
  const u64* b1 = b0 + plane;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const u64 x0 = a0[e], x1 = a1[e], y0 = b0[e], y1 = b1[e];
    smem[e] = mul_mod(x0, y0, br);
    smem[n + e] = mul_add_mod(x0, y1, x1, y0, br);
    smem[2 * n + e] = mul_mod(x1, y1, br);
  }
  __syncthreads();
  ntt_inverse_rows(smem, 3, n, logn, zi + (long long)j * n,
                   zis + (long long)j * n, ninv[j], ninv_s[j], br.p);
  u64* o = out + blk * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    o[e] = smem[e];
    o[plane + e] = smem[n + e];
    o[2 * plane + e] = smem[2 * n + e];
  }
}

// rows_k = rows * k blocks; plane = rows * k * n words per operand.
extern "C" int tpufhe_tensor_intt(const void* ext, void* out, long long rows_k,
                                  int k, int n, const void* zi,
                                  const void* zis, const void* limb_p,
                                  const void* b_lo, const void* b_hi,
                                  const void* ninv, const void* ninv_s,
                                  void* stream) {
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  const size_t smem = 3 * (size_t)n * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(tensor_intt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = n / 2 < 1024 ? n / 2 : 1024;
  const long long plane = rows_k * n;
  tensor_intt_kernel<<<(unsigned)rows_k, threads, smem, (cudaStream_t)stream>>>((const u64*)ext, (u64*)out, plane, k, n, logn, (const u64*)zi, (const u64*)zis, (const u64*)limb_p, (const u64*)b_lo, (const u64*)b_hi, (const u64*)ninv, (const u64*)ninv_s);
  return (int)cudaGetLastError();
}
