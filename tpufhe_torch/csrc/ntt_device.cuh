// Block-cooperative radix-2 negacyclic NTT of rows held in shared memory,
// one barrier a stage, shared by the narrow NTT (K9, ntt32.cu) and the
// inverse NTT + scale (K8, intt_scale.cu). K1, K3, K4 and K5 run the
// passes of ntt_pass_device.cuh instead.
//
// Same transform as tpufhe/ops/ntt.py forward/backward (the Harvey
// butterflies of fhe.rs ntt/native.rs:77-132): the bit-reversed twiddle
// tables of NttOperator, the same stage order and the same bit-reversed
// output order. Values stay lazy inside the transform (forward: [0, 4p),
// inverse: [0, 2p)), which needs 4p below 2^64 for the 64-bit words W = u64
// (p < 2^62) and below 2^32 for the narrow W = u32 words of ntt32.cu
// (p < 2^30, tpufhe's forward32 / backward32); the arithmetic is the
// overload of modarith.cuh for W.
//
// `a` points at `cnt` rows of n words each, laid out back to back; the rows
// are transformed in lockstep so each stage costs one __syncthreads for all
// of them. The caller synchronises before the call; the routine returns
// after a final __syncthreads.
#pragma once

#include "modarith.cuh"

// Forward transform. Inputs < 4p, outputs < 4p (caller reduces).
// w / ws: the limb's bit-reversed omegas and their Shoup constants.
template <typename W>
__device__ __forceinline__ void ntt_forward_rows(W* a, int cnt, int n,
                                                 int logn, const W* w,
                                                 const W* ws, W p) {
  const W p2 = 2 * p;
  const int half = n >> 1;
  for (int s = 0; s < logn; ++s) {
    const int logl = logn - 1 - s;  // half-length l = n >> (s + 1)
    const int l = 1 << logl;
    const int m = 1 << s;  // groups in this stage
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int g = i >> logl;
      const int i0 = (g << (logl + 1)) + (i & (l - 1));
      const W tw = w[m + g], tws = ws[m + g];
      for (int c = 0; c < cnt; ++c) {
        W* r = a + c * n;
        W x = r[i0];
        const W y = r[i0 + l];
        x = x >= p2 ? x - p2 : x;
        const W t = lazy_mul_shoup(y, tw, tws, p);
        r[i0] = x + t;
        r[i0 + l] = x + p2 - t;
      }
    }
    __syncthreads();
  }
}

// One Gentleman-Sande butterfly of the inverse transform on r[i0] and
// r[i0 + l], inputs and outputs < 2p.
template <typename W>
__device__ __forceinline__ void inverse_butterfly(W* r, int i0, int l, W tz,
                                                  W tzs, W p) {
  const W p2 = 2 * p;
  const W x = r[i0];
  const W y = r[i0 + l];
  const W sum = x + y;
  r[i0] = sum >= p2 ? sum - p2 : sum;
  r[i0 + l] = lazy_mul_shoup(x + p2 - y, tz, tzs, p);
}

// Inverse transform including the final n^{-1} fold. Inputs < 2p,
// outputs canonical. z / zs: the limb's bit-reversed zetas_inv and Shoup
// constants; ninv / ninv_s: n^{-1} mod p and its Shoup constant.
template <typename W>
__device__ __forceinline__ void ntt_inverse_rows(W* a, int cnt, int n,
                                                 int logn, const W* z,
                                                 const W* zs, W ninv,
                                                 W ninv_s, W p) {
  const int half = n >> 1;
  int k = 0;
  for (int s = 0; s < logn; ++s) {
    const int logl = s;  // l = 1, 2, 4, ...
    const int l = 1 << logl;
    const int m = half >> s;  // groups in this stage
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int g = i >> logl;
      const int i0 = (g << (logl + 1)) + (i & (l - 1));
      const W tz = z[k + g], tzs = zs[k + g];
      for (int c = 0; c < cnt; ++c)
        inverse_butterfly(a + c * n, i0, l, tz, tzs, p);
    }
    k += m;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    for (int c = 0; c < cnt; ++c) {
      W* r = a + c * n;
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
template <typename W>
__device__ __forceinline__ W canon4(W x, W p) {
  const W p2 = 2 * p;
  x = x >= p2 ? x - p2 : x;
  return x >= p ? x - p : x;
}
