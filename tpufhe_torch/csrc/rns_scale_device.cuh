// The HPS base conversion with rational scaling of one coefficient (fhe.rs
// rns/scaler.rs:249-352), shared by the scaler (K2) and the fused inverse
// NTT + scale (K8) kernels. From the k_in residues r_i of one coefficient it
// computes, exactly as tpufhe/ops/rns.py RnsScaler.scale_host:
//   v = ceil(((sum_i r_i theta_garner_i mod 2^256) >> (shift - 1)
//             mod 2^128) / 2)
//   w = signed rounding of (sum_i +-r_i theta_omega_i -+ v theta_gamma)
//       / 2^127, from the 256-bit two's complement sum (only when the
//       factor is not one)
//   y_j = sum_i r_i omega_ji - v gamma_j +- w  (mod p_j), canonical,
// for the output moduli j = start .. start + size - 1.
#pragma once

#include "modarith.cuh"

#define MAX_K_IN 16

struct U256 {
  u64 w[4];
};

__device__ __forceinline__ void add256(U256& a, u64 b0, u64 b1, u64 b2,
                                       u64 b3) {
  u64 s0 = a.w[0] + b0;
  u64 c = s0 < b0;
  u64 t1 = a.w[1] + c;
  u64 c1 = t1 < c;
  u64 s1 = t1 + b1;
  c1 += s1 < b1;
  u64 t2 = a.w[2] + c1;
  u64 c2 = t2 < c1;
  u64 s2 = t2 + b2;
  c2 += s2 < b2;
  u64 s3 = a.w[3] + c2 + b3;
  a.w[0] = s0;
  a.w[1] = s1;
  a.w[2] = s2;
  a.w[3] = s3;
}

// a += sign * (b0, b1, b2, b3) mod 2^256; negation is ~b + 1.
__device__ __forceinline__ void addsub256(U256& a, u64 b0, u64 b1, u64 b2,
                                          u64 b3, bool negate) {
  if (negate) {
    b0 = ~b0;
    b1 = ~b1;
    b2 = ~b2;
    b3 = ~b3;
    add256(a, 1, 0, 0, 0);
  }
  add256(a, b0, b1, b2, b3);
}

// a += sign * r * (t_hi 2^64 + t_lo), mod 2^256.
__device__ __forceinline__ void mac_64x128(U256& a, u64 r, u64 t_lo,
                                           u64 t_hi, bool negate) {
  u64 p0 = r * t_lo;
  u64 m1 = mulhi64(r, t_lo);
  u64 q1 = r * t_hi;
  u64 q2 = mulhi64(r, t_hi);
  u64 p1 = m1 + q1;
  u64 p2 = q2 + (p1 < m1);
  addsub256(a, p0, p1, p2, 0, negate);
}

__device__ __forceinline__ u64 word_of(const U256& a, int i) {
  switch (i) {
    case 0: return a.w[0];
    case 1: return a.w[1];
    case 2: return a.w[2];
    case 3: return a.w[3];
    default: return 0;
  }
}

// Bits [s, s + 128) of a, for 0 <= s < 256.
__device__ __forceinline__ void shr_low128(const U256& a, int s, u64& lo,
                                           u64& hi) {
  const int q = s >> 6, b = s & 63;
  const u64 w0 = word_of(a, q), w1 = word_of(a, q + 1), w2 = word_of(a, q + 2);
  if (b == 0) {
    lo = w0;
    hi = w1;
  } else {
    lo = (w0 >> b) | (w1 << (64 - b));
    hi = (w1 >> b) | (w2 << (64 - b));
  }
}

// ceil(t / 2) of a 128-bit t: (t >> 1) + (t & 1), which cannot overflow.
__device__ __forceinline__ void ceil_half(u64& lo, u64& hi) {
  const u64 odd = lo & 1;
  lo = (lo >> 1) | (hi << 63);
  hi >>= 1;
  const u64 s = lo + odd;
  hi += s < lo;
  lo = s;
}

// Table layout (u64 words), built by tpufhe_torch/ops/rns.py RnsScaler.table:
//   [0, 2)                theta_gamma (lo, hi)
//   2 + 5 i + [0, 5)      theta_garner_i (lo, hi), theta_omega_i (lo, hi),
//                         theta_omega_sign_i             for i < k_in
//   2 + 5 k_in + j (5 + 2 k_in) + [0, 5 + 2 k_in)
//                         p_j, barrett lo, barrett hi, gamma_j,
//                         shoup(gamma_j), then (omega_ji, shoup) for i
//
// r: the k_in canonical residues of one coefficient (entries from k_in on
// are not read). Output j goes to out[j * stride], for j < size, as a word
// of type W: u64, or u32 for narrow (w30) rows, whose outputs are below
// 2^30. The arithmetic is the same 64-bit code for both.
template <typename W>
__device__ __forceinline__ void rns_scale_coeff(
    const u64 (&r)[MAX_K_IN], int k_in, const u64* __restrict__ tab,
    int start, int size, int shift, int is_one, int theta_gamma_sign,
    W* __restrict__ out, long long stride) {
  // v: the estimate of round(x / q)
  U256 acc = {{0, 0, 0, 0}};
#pragma unroll
  for (int i = 0; i < MAX_K_IN; ++i)
    if (i < k_in) mac_64x128(acc, r[i], tab[2 + 5 * i], tab[3 + 5 * i], false);
  u64 v_lo, v_hi;
  shr_low128(acc, shift - 1, v_lo, v_hi);
  ceil_half(v_lo, v_hi);

  // w and its sign
  u64 w_lo = 0, w_hi = 0;
  bool w_sign = false;
  if (!is_one) {
    U256 s = {{0, 0, 0, 0}};
#pragma unroll
    for (int i = 0; i < MAX_K_IN; ++i)
      if (i < k_in)
        mac_64x128(s, r[i], tab[4 + 5 * i], tab[5 + 5 * i],
                   tab[6 + 5 * i] != 0);
    // v * theta_gamma, 128 x 128 -> 256 bits
    const u64 g_lo = tab[0], g_hi = tab[1];
    U256 vg = {{0, 0, 0, 0}};
    add256(vg, v_lo * g_lo, mulhi64(v_lo, g_lo), 0, 0);
    add256(vg, 0, v_lo * g_hi, mulhi64(v_lo, g_hi), 0);
    add256(vg, 0, v_hi * g_lo, mulhi64(v_hi, g_lo), 0);
    add256(vg, 0, 0, v_hi * g_hi, mulhi64(v_hi, g_hi));
    addsub256(s, vg.w[0], vg.w[1], vg.w[2], vg.w[3], !theta_gamma_sign);
    w_sign = (s.w[2] >> 63) != 0 || s.w[3] != 0;
    if (w_sign) {
      s.w[0] = ~s.w[0];
      s.w[1] = ~s.w[1];
      s.w[2] = ~s.w[2];
      s.w[3] = ~s.w[3];
    }
    // positive: ceil(t / 2); negative: (t' + 1) / 2 -- the same formula
    shr_low128(s, 126, w_lo, w_hi);
    ceil_half(w_lo, w_hi);
  }

  const int tstride = 5 + 2 * k_in;
  for (int jj = 0; jj < size; ++jj) {
    const u64* t = tab + 2 + 5 * k_in + (long long)(start + jj) * tstride;
    const Barrett br = {t[0], t[1], t[2]};
    const u64 p = br.p;
    const u64 v_red = reduce_u128(v_lo, v_hi, br);
    u64 lo = 2 * p - lazy_mul_shoup(v_red, t[3], t[4], p);  // in (0, 2p]
    u64 hi = 0;
    if (!is_one) {
      const u64 w_red = reduce_u128(w_lo, w_hi, br);
      const u64 term = w_sign ? (w_red ? p - w_red : 0) : w_red;
      lo += term;  // < 3p: no carry
    }
#pragma unroll
    for (int i = 0; i < MAX_K_IN; ++i) {
      if (i < k_in) {
        const u64 term = lazy_mul_shoup(r[i], t[5 + 2 * i], t[6 + 2 * i], p);
        const u64 s = lo + term;
        hi += s < lo;
        lo = s;
      }
    }
    out[jj * stride] = (W)reduce_u128(lo, hi, br);
  }
}
