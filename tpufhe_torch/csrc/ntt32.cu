// K9: forward / inverse negacyclic NTT of a batch of narrow (w30) RNS rows:
// one residue per 32-bit word, p < 2^30, Shoup constants scaled by 2^32.
//
// Replaces tpufhe/ops/pallas/ntt32_kernel.py:_ntt32_kernel (wrapper
// ntt32_pallas), tpufhe's narrow transform at 256 <= N < 1024, which runs
// the Harvey butterflies stage by stage on lane-folded (S, 128) tiles with
// rolls and per-stage lane tables. It also stands for tpufhe's narrow route
// at N >= 1024, the four-step int8 digit-plane product of
// ntt_mxu.forward_mxu32 / backward_mxu32 for the TPU's matrix unit: the
// same function, the same twiddles and the same bit-reversed output order
// (tpufhe/ops/ntt.py forward32 / backward32). Hopper multiplies 32-bit
// words natively, so this kernel runs the radix-2 butterflies directly,
// with __umulhi for the Shoup quotient.
//
// Data: x (rows, k_sel, n) int32 words read as u32, canonical residues.
// One thread block per (row, limb), as K1 (ntt.cu) with the same routines
// of ntt_device.cuh instantiated for u32: the row is loaded once into
// shared memory (4 n bytes: 32 KB at n = 8192, half of K1's), transformed
// in place through log2(n) stages with one __syncthreads each, and written
// once, canonical. Lazy bounds as tpufhe/ops/zq32.py: forward values in
// [0, 4p), inverse in [0, 2p), both below 2^32; then the n^{-1} Shoup fold
// (inverse) or two conditional subtractions (forward). Twiddles come from
// the (k_ctx, n) tables of the flat bit-reversed order K1 uses; limb0 + j
// selects the table row (the counterpart of limb_slice).
//
// Bound on this card: each element moves 8 bytes through device memory
// (read once, written once) and takes part in log2(n) / 2 butterflies of
// three 32-bit multiplies, about 20 multiplies at n = 8192. The card
// multiplies about 5 int32 words in the time it moves one byte (16.7 T/s
// against 3.35 TB/s), so the transform is bytes-bound, by about 2:1. The
// design keeps the whole transform in shared memory, so device memory
// sees only those 8 bytes; the stage barriers and shared-memory traffic
// are what remain.
#include <cuda_runtime.h>

#include "ntt_device.cuh"

__global__ void ntt32_kernel(const u32* __restrict__ x, u32* __restrict__ y,
                             int k_sel, int n, int logn,
                             const u32* __restrict__ tw,
                             const u32* __restrict__ tws,
                             const u32* __restrict__ limb_p,
                             const u32* __restrict__ ninv,
                             const u32* __restrict__ ninv_s, int limb0,
                             int inverse) {
  extern __shared__ u32 smem32[];
  const long long blk = blockIdx.x;
  const int limb = limb0 + (int)(blk % k_sel);
  const u32 p = limb_p[limb];
  const u32* src = x + blk * n;
  u32* dst = y + blk * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) smem32[i] = src[i];
  __syncthreads();
  const u32* t = tw + (long long)limb * n;
  const u32* ts = tws + (long long)limb * n;
  if (inverse) {
    ntt_inverse_rows(smem32, 1, n, logn, t, ts, ninv[limb], ninv_s[limb], p);
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = smem32[i];
  } else {
    ntt_forward_rows(smem32, 1, n, logn, t, ts, p);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      dst[i] = canon4(smem32[i], p);
  }
}

// rows: number of (row, limb) blocks = batch rows * k_sel.
// tw / tws: (k_ctx, n) tables of the direction (omegas for forward,
// zetas_inv for inverse); limb_p, ninv, ninv_s: (k_ctx,) per limb. The
// same interface as tpufhe_ntt (ntt.cu), on 32-bit words.
extern "C" int tpufhe_ntt32(const void* x, void* y, long long rows, int k_sel,
                            int n, const void* tw, const void* tws,
                            const void* limb_p, const void* ninv,
                            const void* ninv_s, int limb0, int inverse,
                            void* stream) {
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  const size_t smem = (size_t)n * sizeof(u32);
  cudaError_t err = cudaFuncSetAttribute(ntt32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = n / 2 < 512 ? n / 2 : 512;
  ntt32_kernel<<<(unsigned)rows, threads, smem, (cudaStream_t)stream>>>((const u32*)x, (u32*)y, k_sel, n, logn, (const u32*)tw, (const u32*)tws, (const u32*)limb_p, (const u32*)ninv, (const u32*)ninv_s, limb0, inverse);
  return (int)cudaGetLastError();
}
