// The Garner-decomposition key-switch accumulate of one (row, limb j),
// shared by the relin-tail (K4) and rotate-tail (K5) kernels:
//   acc0 = sum_i NTT(d_i) ksk0_i[j],  acc1 = sum_i NTT(d_i) ksk1_i[j]
// where d_i is limb i of the power-basis row c2 reduced modulo p_j
// (fhe.rs key_switching_key.rs:214-241). Each d_i is reduced into the
// shared work row `buf`, forward-transformed there and Shoup-multiplied
// into the two shared accumulators, so neither the lifted rows nor the
// partial sums reach device memory.
//
// c2 points at the row's limb 0 (limb i at c2 + i n); ksk tables are
// (k, k, n) with [i][j] = decomposition row i, limb j. The caller
// synchronises before the call; the routine returns after a final
// __syncthreads, with acc0 / acc1 canonical.
#pragma once

#include "ntt_device.cuh"

__device__ __forceinline__ void keyswitch_accumulate(
    const u64* c2, int k, int j, int n, int logn, Barrett br, const u64* tw,
    const u64* tws, const u64* k0, const u64* k0s, const u64* k1,
    const u64* k1s, u64* buf, u64* acc0, u64* acc1) {
  const u64 p = br.p;
  for (int i = 0; i < k; ++i) {
    const u64* src = c2 + (long long)i * n;
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      buf[e] = reduce_u64(src[e], br);
    __syncthreads();
    ntt_forward_rows(buf, 1, n, logn, tw, tws, p);
    const long long kofs = ((long long)i * k + j) * n;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const u64 d = buf[e];  // lazy, < 4p: Shoup takes any u64
      const u64 t0 = mul_shoup(d, k0[kofs + e], k0s[kofs + e], p);
      const u64 t1 = mul_shoup(d, k1[kofs + e], k1s[kofs + e], p);
      acc0[e] = i ? add_mod(acc0[e], t0, p) : t0;
      acc1[e] = i ? add_mod(acc1[e], t1, p) : t1;
    }
    __syncthreads();
  }
}
