// The HPS base conversion with rational scaling of one coefficient (fhe.rs
// rns/scaler.rs:249-352), shared by the scaler (K2) and the fused inverse
// NTT + scale (K8) kernels. From the k_in residues r_i of one coefficient it
// computes, exactly as tpufhe/ops/rns.py RnsScaler.scale_host:
//   v = ceil(((sum_i r_i theta_garner_i) >> (shift - 1) mod 2^128) / 2)
//   w = signed rounding of (sum_i +-r_i theta_omega_i -+ v theta_gamma)
//       / 2^127, from the 256-bit two's complement sum (only when the
//       factor is not one)
//   y_j = sum_i r_i omega_ji - v gamma_j +- w  (mod p_j), canonical,
// for the output moduli j = start .. start + size - 1.
//
// The sums are sized by their bounds. theta_garner_i < 2^shift with
// shift <= 191 - log2(p_i k_in) (RnsScaler.theta_garner_shift), so the v sum
// is below 2^191 and three words hold it exactly. Each output's
// sum_i r_i omega_ji is formed from plain 128-bit products (r_i, omega_ji
// < 2^62) with one Barrett reduction at the end: up to 16 products and
// the < 3p start stay below 2^128. The w sum keeps 256 bits.
//
// Two forms of the body: rns_scale_fixed holds K_IN residues (a compile-time
// count) in registers and unrolls every loop over them;
// rns_scale_chunked_get takes any k_in, reading the residues in chunks of
// CHUNK through an accessor (rns_scale_chunked: from `src` at stride
// `sstride`) for the sums and again for each output, whose sum is reduced
// after every chunk.
#pragma once

#include "modarith.cuh"

// Residues per chunk of the general body (its register array).
#define K2_CHUNK 8

// Table layout (u64 words), built by tpufhe_torch/ops/rns.py
// RnsScaler.table for the outputs start .. start + size - 1 only:
//   [0, 2)                theta_gamma (lo, hi)
//   2 + 5 i + [0, 5)      theta_garner_i (lo, hi), theta_omega_i (lo, hi),
//                         theta_omega_sign_i             for i < k_in
//   2 + 5 k_in + jj (5 + k_in) + [0, 5 + k_in)
//                         p_j, barrett lo, barrett hi, gamma_j,
//                         shoup(gamma_j), then omega_ji for i < k_in,
//                         with j = start + jj
__host__ __device__ constexpr int k2_table_words(int k_in, int size) {
  return 2 + 5 * k_in + size * (5 + k_in);
}

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

// The 192-bit product r * (t_hi 2^64 + t_lo) as (p0, p1, p2).
__device__ __forceinline__ void mul_64x128(u64 r, u64 t_lo, u64 t_hi, u64& p0,
                                           u64& p1, u64& p2) {
  p0 = r * t_lo;
  const u64 m1 = mulhi64(r, t_lo);
  const u64 q1 = r * t_hi;
  p1 = m1 + q1;
  p2 = mulhi64(r, t_hi) + (p1 < m1);
}

// The sums of v and w: a (3 words) and s (256 bits, only when the factor
// is not one).
struct ScaleSums {
  u64 a0, a1, a2;
  U256 s;
};

// Adds residue r of input limb i; ti = tab + 2 + 5 i.
__device__ __forceinline__ void sums_add(ScaleSums& acc, u64 r, const u64* ti,
                                         int is_one) {
  u64 p0, p1, p2;
  mul_64x128(r, ti[0], ti[1], p0, p1, p2);
  const u64 s0 = acc.a0 + p0;
  const u64 c0 = s0 < p0;
  const u64 s1 = acc.a1 + p1;
  u64 c1 = s1 < p1;
  const u64 s1c = s1 + c0;
  c1 += s1c < c0;
  acc.a0 = s0;
  acc.a1 = s1c;
  acc.a2 += p2 + c1;
  if (!is_one) {
    mul_64x128(r, ti[2], ti[3], p0, p1, p2);
    addsub256(acc.s, p0, p1, p2, 0, ti[4] != 0);
  }
}

// Bits [s, s + 128) of the 256-bit (w0, w1, w2, w3), for 0 <= s < 192.
__device__ __forceinline__ void shr_low128(u64 w0, u64 w1, u64 w2, u64 w3,
                                           int s, u64& lo, u64& hi) {
  const int q = s >> 6, b = s & 63;
  const u64 x0 = q == 0 ? w0 : q == 1 ? w1 : w2;
  const u64 x1 = q == 0 ? w1 : q == 1 ? w2 : w3;
  const u64 x2 = q == 0 ? w2 : q == 1 ? w3 : 0;
  if (b == 0) {
    lo = x0;
    hi = x1;
  } else {
    lo = (x0 >> b) | (x1 << (64 - b));
    hi = (x1 >> b) | (x2 << (64 - b));
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

// v and w of one coefficient, from its sums.
struct ScaleVW {
  u64 v_lo, v_hi, w_lo, w_hi;
  bool w_sign;
};

__device__ __forceinline__ ScaleVW sums_finish(ScaleSums& acc,
                                               const u64* tab, int shift,
                                               int is_one,
                                               int theta_gamma_sign) {
  ScaleVW out;
  shr_low128(acc.a0, acc.a1, acc.a2, 0, shift - 1, out.v_lo, out.v_hi);
  ceil_half(out.v_lo, out.v_hi);
  out.w_lo = out.w_hi = 0;
  out.w_sign = false;
  if (!is_one) {
    U256& s = acc.s;
    // v * theta_gamma, 128 x 128 -> 256 bits
    const u64 g_lo = tab[0], g_hi = tab[1];
    const u64 v_lo = out.v_lo, v_hi = out.v_hi;
    U256 vg = {{0, 0, 0, 0}};
    add256(vg, v_lo * g_lo, mulhi64(v_lo, g_lo), 0, 0);
    add256(vg, 0, v_lo * g_hi, mulhi64(v_lo, g_hi), 0);
    add256(vg, 0, v_hi * g_lo, mulhi64(v_hi, g_lo), 0);
    add256(vg, 0, 0, v_hi * g_hi, mulhi64(v_hi, g_hi));
    addsub256(s, vg.w[0], vg.w[1], vg.w[2], vg.w[3], !theta_gamma_sign);
    out.w_sign = (s.w[2] >> 63) != 0 || s.w[3] != 0;
    if (out.w_sign) {
      s.w[0] = ~s.w[0];
      s.w[1] = ~s.w[1];
      s.w[2] = ~s.w[2];
      s.w[3] = ~s.w[3];
    }
    // positive: ceil(t / 2); negative: (t' + 1) / 2 -- the same formula
    shr_low128(s.w[0], s.w[1], s.w[2], s.w[3], 126, out.w_lo, out.w_hi);
    ceil_half(out.w_lo, out.w_hi);
  }
  return out;
}

// The start of output row t (= its table row): -v gamma_j +- w in (0, 3p)
// as a 128-bit sum (lo, hi = 0).
__device__ __forceinline__ u64 out_start(const u64* t, const Barrett& br,
                                         const ScaleVW& vw, int is_one) {
  const u64 p = br.p;
  const u64 v_red = reduce_u128(vw.v_lo, vw.v_hi, br);
  u64 lo = 2 * p - lazy_mul_shoup(v_red, t[3], t[4], p);  // in (0, 2p]
  if (!is_one) {
    const u64 w_red = reduce_u128(vw.w_lo, vw.w_hi, br);
    lo += vw.w_sign ? (w_red ? p - w_red : 0) : w_red;  // < 3p: no carry
  }
  return lo;
}

// (lo, hi) += r * omega, a plain 128-bit product.
__device__ __forceinline__ void out_add(u64& lo, u64& hi, u64 r, u64 omega) {
  const u64 a = r * omega;
  lo += a;
  hi += mulhi64(r, omega) + (lo < a);
}

// The body on the K_IN residues of one coefficient in registers, every
// loop unrolled. Output jj goes to out[jj * stride], as a word of type W
// (u64, or u32 for narrow rows).
template <int K_IN, typename W>
__device__ __forceinline__ void rns_scale_fixed(const u64 (&r)[K_IN],
                                                const u64* tab, int size,
                                                int shift, int is_one,
                                                int theta_gamma_sign,
                                                W* __restrict__ out,
                                                long long stride) {
  static_assert(K_IN >= 1 && K_IN <= 16, "a sum's products must fit 128 bits");
  ScaleSums acc = {0, 0, 0, {{0, 0, 0, 0}}};
#pragma unroll
  for (int i = 0; i < K_IN; ++i) sums_add(acc, r[i], tab + 2 + 5 * i, is_one);
  const ScaleVW vw = sums_finish(acc, tab, shift, is_one, theta_gamma_sign);
  for (int jj = 0; jj < size; ++jj) {
    const u64* t = tab + 2 + 5 * K_IN + jj * (5 + K_IN);
    const Barrett br = {t[0], t[1], t[2]};
    u64 lo = out_start(t, br, vw, is_one), hi = 0;
#pragma unroll
    for (int i = 0; i < K_IN; ++i) out_add(lo, hi, r[i], t[5 + i]);
    out[jj * stride] = (W)reduce_u128(lo, hi, br);
  }
}

// The body on any k_in >= 1 residues, residue i read as get(i) (a u64),
// CHUNK at a time. Output jj goes to out[jj * stride], as a word of type
// W: u64, or u32 for narrow (w30) rows, whose outputs are below 2^30.
template <int CHUNK, typename Get, typename W>
__device__ __forceinline__ void rns_scale_chunked_get(
    const Get& get, int k_in, const u64* tab, int size, int shift,
    int is_one, int theta_gamma_sign, W* __restrict__ out, long long stride) {
  static_assert(CHUNK >= 1 && CHUNK <= 15, "a chunk's products must fit 128 bits");
  ScaleSums acc = {0, 0, 0, {{0, 0, 0, 0}}};
  for (int base = 0; base < k_in; base += CHUNK) {
#pragma unroll
    for (int i = 0; i < CHUNK; ++i)
      if (base + i < k_in)
        sums_add(acc, get(base + i), tab + 2 + 5 * (base + i), is_one);
  }
  const ScaleVW vw = sums_finish(acc, tab, shift, is_one, theta_gamma_sign);
  for (int jj = 0; jj < size; ++jj) {
    const u64* t = tab + 2 + 5 * k_in + jj * (5 + k_in);
    const Barrett br = {t[0], t[1], t[2]};
    u64 lo = out_start(t, br, vw, is_one), hi = 0;
    for (int base = 0; base < k_in; base += CHUNK) {
      if (base) {  // reduce, so that the next chunk's sum fits 128 bits
        lo = reduce_u128(lo, hi, br);
        hi = 0;
      }
#pragma unroll
      for (int i = 0; i < CHUNK; ++i)
        if (base + i < k_in) out_add(lo, hi, get(base + i), t[5 + base + i]);
    }
    out[jj * stride] = (W)reduce_u128(lo, hi, br);
  }
}

// The same on the residues src[i * sstride] (words of type S).
template <int CHUNK, typename S, typename W>
__device__ __forceinline__ void rns_scale_chunked(const S* src,
                                                  long long sstride, int k_in,
                                                  const u64* tab, int size,
                                                  int shift, int is_one,
                                                  int theta_gamma_sign,
                                                  W* __restrict__ out,
                                                  long long stride) {
  rns_scale_chunked_get<CHUNK>(
      [&](int i) { return (u64)src[i * sstride]; }, k_in, tab, size, shift,
      is_one, theta_gamma_sign, out, stride);
}
