// Block-cooperative negacyclic NTT of rows held in shared memory, shared by
// the NTT, tensor+iNTT, relin-tail, rotate-tail and inverse NTT + scale
// kernels.
//
// Same transform as tpufhe/ops/ntt.py forward/backward (the Harvey
// butterflies of fhe.rs ntt/native.rs:77-132): the bit-reversed twiddle
// tables of NttOperator, the same stage order and the same bit-reversed
// output order. Values stay lazy inside the transform (forward: [0, 4p),
// inverse: [0, 2p)), which needs 4p < 2^64, true for p < 2^62.
//
// `a` points at `cnt` rows of n words each, laid out back to back; the rows
// are transformed in lockstep so each stage costs one __syncthreads for all
// of them. The caller synchronises before the call; the routine returns
// after a final __syncthreads.
#pragma once

#include "modarith.cuh"

// Forward transform. Inputs < 4p, outputs < 4p (caller reduces).
// w / ws: the limb's bit-reversed omegas and their Shoup constants.
__device__ __forceinline__ void ntt_forward_rows(u64* a, int cnt, int n,
                                                 int logn, const u64* w,
                                                 const u64* ws, u64 p) {
  const u64 p2 = 2 * p;
  const int half = n >> 1;
  for (int s = 0; s < logn; ++s) {
    const int logl = logn - 1 - s;  // half-length l = n >> (s + 1)
    const int l = 1 << logl;
    const int m = 1 << s;  // groups in this stage
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int g = i >> logl;
      const int i0 = (g << (logl + 1)) + (i & (l - 1));
      const u64 tw = w[m + g], tws = ws[m + g];
      for (int c = 0; c < cnt; ++c) {
        u64* r = a + c * n;
        u64 x = r[i0];
        const u64 y = r[i0 + l];
        x = x >= p2 ? x - p2 : x;
        const u64 t = lazy_mul_shoup(y, tw, tws, p);
        r[i0] = x + t;
        r[i0 + l] = x + p2 - t;
      }
    }
    __syncthreads();
  }
}

// One Gentleman-Sande butterfly of the inverse transform on r[i0] and
// r[i0 + l], inputs and outputs < 2p.
__device__ __forceinline__ void inverse_butterfly(u64* r, int i0, int l,
                                                  u64 tz, u64 tzs, u64 p) {
  const u64 p2 = 2 * p;
  const u64 x = r[i0];
  const u64 y = r[i0 + l];
  const u64 sum = x + y;
  r[i0] = sum >= p2 ? sum - p2 : sum;
  r[i0 + l] = lazy_mul_shoup(x + p2 - y, tz, tzs, p);
}

// Inverse transform including the final n^{-1} fold. Inputs < 2p,
// outputs canonical. z / zs: the limb's bit-reversed zetas_inv and Shoup
// constants; ninv / ninv_s: n^{-1} mod p and its Shoup constant.
__device__ __forceinline__ void ntt_inverse_rows(u64* a, int cnt, int n,
                                                 int logn, const u64* z,
                                                 const u64* zs, u64 ninv,
                                                 u64 ninv_s, u64 p) {
  const int half = n >> 1;
  int k = 0;
  for (int s = 0; s < logn; ++s) {
    const int logl = s;  // l = 1, 2, 4, ...
    const int l = 1 << logl;
    const int m = half >> s;  // groups in this stage
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int g = i >> logl;
      const int i0 = (g << (logl + 1)) + (i & (l - 1));
      const u64 tz = z[k + g], tzs = zs[k + g];
      for (int c = 0; c < cnt; ++c)
        inverse_butterfly(a + c * n, i0, l, tz, tzs, p);
    }
    k += m;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    for (int c = 0; c < cnt; ++c) {
      u64* r = a + c * n;
      r[i] = mul_shoup(r[i], ninv, ninv_s, p);
    }
  }
  __syncthreads();
}

// Inverse transform of `cnt` rows where row c belongs to limb c, with its
// own modulus and tables: z / zs point at (cnt, n) twiddle tables, ninv /
// ninv_s / limb_p at (cnt,) scalars. All rows advance one stage per
// __syncthreads. Inputs < 2p_c, outputs canonical.
__device__ __forceinline__ void ntt_inverse_limbs(u64* a, int cnt, int n,
                                                  int logn, const u64* z,
                                                  const u64* zs,
                                                  const u64* ninv,
                                                  const u64* ninv_s,
                                                  const u64* limb_p) {
  const int half = n >> 1;
  int k = 0;
  for (int s = 0; s < logn; ++s) {
    const int logl = s;
    const int l = 1 << logl;
    for (int c = 0; c < cnt; ++c) {
      const u64 p = limb_p[c];
      const u64* zc = z + (long long)c * n + k;
      const u64* zsc = zs + (long long)c * n + k;
      for (int i = threadIdx.x; i < half; i += blockDim.x) {
        const int g = i >> logl;
        const int i0 = (g << (logl + 1)) + (i & (l - 1));
        inverse_butterfly(a + c * n, i0, l, zc[g], zsc[g], p);
      }
    }
    k += half >> s;
    __syncthreads();
  }
  for (int c = 0; c < cnt; ++c) {
    const u64 p = limb_p[c], f = ninv[c], fs = ninv_s[c];
    u64* r = a + c * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      r[i] = mul_shoup(r[i], f, fs, p);
  }
  __syncthreads();
}

// Canonical form of a lazy forward output (< 4p).
__device__ __forceinline__ u64 canon4(u64 x, u64 p) {
  const u64 p2 = 2 * p;
  x = x >= p2 ? x - p2 : x;
  return x >= p ? x - p : x;
}
