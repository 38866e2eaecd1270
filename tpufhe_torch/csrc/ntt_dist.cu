// The cross-shard step of the distributed negacyclic NTT
// (tpufhe_torch/parallel/ntt_dist.py): for each (row, limb j) of a rank's
// block,
//   y[c] = sum_d W_j[e][d] x_d[c]  (mod p_j),  c = 0 .. B - 1,
// over the D blocks x_d that one all_gather brought together, with W_j the
// D x D matrix of the forward's first log2 D Cooley-Tukey stages (every
// butterfly of those stages pairs whole blocks with one twiddle), or of
// the inverse's last log2 D Gentleman-Sande stages with N^{-1} folded in.
// Row e of W_j (the rank's own) and its Shoup words come from the plan.
//
// Replaces tpufhe's XLA code of tpufhe/parallel/ntt_dist.py:62-96
// (_block_matmul_left, _fold_reduce and _psum_blocks_mod: the four-step
// plan's distributed M1 contraction as int8 digit-plane matrices and a
// modular sum of the partials after its all_to_all); it has no Pallas
// counterpart.
//
// Data: x (D, rows, k_sel, B) words read as u64, any value below 2^64 (the
// forward takes inputs in [0, 4p), as tpufhe's); y (rows, k_sel, B)
// canonical. Row b belongs to limb limb0 + b mod k_sel; w, w_shoup are
// (k_ctx, D), row j holding W_j[e][0 .. D - 1].
//
// Bound on this card: bytes. Per output word it reads D words and writes
// one, and does D Shoup products (about ten int32 multiplies each), far
// below the memory bound. One thread per output word, loads and stores
// coalesced along the coefficients; the D weights of a limb stay in L1.
#include <cuda_runtime.h>

#include "modarith.cuh"

__global__ void ntt_dist_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                                long long plane, int shards, int k_sel,
                                int logb, const u64* __restrict__ w,
                                const u64* __restrict__ w_shoup,
                                const u64* __restrict__ limb_p, int limb0) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  const int j = limb0 + (int)((idx >> logb) % k_sel);
  const u64 p = limb_p[j];
  const u64* wj = w + (long long)j * shards;
  const u64* wsj = w_shoup + (long long)j * shards;
  u64 acc = 0;
  for (int d = 0; d < shards; ++d)
    acc = add_mod(acc, mul_shoup(x[d * plane + idx], wj[d], wsj[d], p), p);
  y[idx] = acc;
}

// plane = rows * k_sel * B words of one block; shards = D; b = B, a power
// of two; w, w_shoup (k_ctx, D); limb_p (k_ctx,).
extern "C" int tpufhe_ntt_dist(const void* x, void* y, long long plane,
                               int shards, int k_sel, int b, const void* w,
                               const void* w_shoup, const void* limb_p,
                               int limb0, void* stream) {
  int logb = 0;
  while ((1 << logb) < b) ++logb;
  if ((1 << logb) != b || shards < 1 || k_sel < 1 || plane < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((plane + threads - 1) / threads);
  ntt_dist_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const u64*)x, (u64*)y, plane, shards, k_sel, logb, (const u64*)w,
      (const u64*)w_shoup, (const u64*)limb_p, limb0);
  return (int)cudaGetLastError();
}
