// Modular arithmetic on 64-bit words for moduli p < 2^62, shared by every
// kernel of tpufhe_torch (the counterpart of tpufhe/ops/zq.py and u64.py,
// which build the same operations from 32-bit lanes for the TPU).
//
// Residues are canonical (< p) unless a function says it is lazy. Every
// function is __host__ __device__ so the same arithmetic compiles for the
// card and for a host-side check.
#pragma once

#include <cstdint>

typedef unsigned long long u64;

#if defined(__CUDACC__)
#define TF_HD __host__ __device__ __forceinline__
#else
#define TF_HD inline
#endif

// High 64 bits of the 128-bit product a * b.
TF_HD u64 mulhi64(u64 a, u64 b) {
#if defined(__CUDA_ARCH__)
  return __umul64hi(a, b);
#else
  return (u64)(((unsigned __int128)a * b) >> 64);
#endif
}

// x mod p for x < 2p (zq/mod.rs:659-668).
TF_HD u64 reduce1(u64 x, u64 p) { return x >= p ? x - p : x; }

TF_HD u64 add_mod(u64 a, u64 b, u64 p) { return reduce1(a + b, p); }

TF_HD u64 sub_mod(u64 a, u64 b, u64 p) { return reduce1(a + p - b, p); }

// Shoup: a * b mod p in [0, 2p) for any u64 a, b < p and
// b_shoup = floor(b 2^64 / p) (zq/mod.rs:224-234).
TF_HD u64 lazy_mul_shoup(u64 a, u64 b, u64 b_shoup, u64 p) {
  u64 q = mulhi64(a, b_shoup);
  return a * b - q * p;
}

TF_HD u64 mul_shoup(u64 a, u64 b, u64 b_shoup, u64 p) {
  return reduce1(lazy_mul_shoup(a, b, b_shoup, p), p);
}

// Barrett constants of one modulus: floor(2^128 / p) = hi 2^64 + lo.
struct Barrett {
  u64 p, lo, hi;
};

// x = xh 2^64 + xl reduced mod p, canonical, for any 128-bit x.
// The quotient estimate of zq/mod.rs:693-707 drops only the low half of
// xl * lo, so it is at most two below the true quotient: the remainder is
// below 3p < 2^64 and two conditional subtractions finish.
TF_HD u64 reduce_u128(u64 xl, u64 xh, Barrett b) {
  u64 t0 = mulhi64(xl, b.lo);
  u64 a_lo = xl * b.hi, a_hi = mulhi64(xl, b.hi);
  u64 c_lo = xh * b.lo, c_hi = mulhi64(xh, b.lo);
  u64 s = a_lo + c_lo;
  u64 carry = s < a_lo;
  u64 s2 = s + t0;
  carry += s2 < s;
  u64 q = a_hi + c_hi + carry + xh * b.hi;  // only q mod 2^64 is needed
  u64 r = xl - q * b.p;
  r = reduce1(r, b.p);
  return reduce1(r, b.p);
}

TF_HD u64 reduce_u64(u64 x, Barrett b) { return reduce_u128(x, 0, b); }

// a * b mod p for a, b < 2^64 (canonical output).
TF_HD u64 mul_mod(u64 a, u64 b, Barrett br) {
  return reduce_u128(a * b, mulhi64(a, b), br);
}

// a0 * b0 + a1 * b1 mod p with one reduction (a_i, b_i < p < 2^62, so the
// sum is below 2^125).
TF_HD u64 mul_add_mod(u64 a0, u64 b0, u64 a1, u64 b1, Barrett br) {
  u64 l0 = a0 * b0, h0 = mulhi64(a0, b0);
  u64 l1 = a1 * b1, h1 = mulhi64(a1, b1);
  u64 lo = l0 + l1;
  u64 hi = h0 + h1 + (lo < l0);
  return reduce_u128(lo, hi, br);
}

// The narrow (w30) words: one residue per 32-bit word, p < 2^30, Shoup
// constants floor(b 2^32 / p) (tpufhe/ops/zq32.py). The functions below
// overload the 64-bit ones on u32, so the transform passes of
// ntt_pass_device.cuh serve both word sizes; Harvey's lazy bounds need
// 4p < 2^32.
typedef unsigned int u32;

// High 32 bits of the 64-bit product a * b.
TF_HD u32 mulhi32(u32 a, u32 b) {
#if defined(__CUDA_ARCH__)
  return __umulhi(a, b);
#else
  return (u32)(((u64)a * b) >> 32);
#endif
}

TF_HD u32 reduce1(u32 x, u32 p) { return x >= p ? x - p : x; }

TF_HD u32 add_mod(u32 a, u32 b, u32 p) { return reduce1(a + b, p); }

// a * b mod p in [0, 2p) for any u32 a, b < p and
// b_shoup = floor(b 2^32 / p).
TF_HD u32 lazy_mul_shoup(u32 a, u32 b, u32 b_shoup, u32 p) {
  u32 q = mulhi32(a, b_shoup);
  return a * b - q * p;
}

TF_HD u32 mul_shoup(u32 a, u32 b, u32 b_shoup, u32 p) {
  return reduce1(lazy_mul_shoup(a, b, b_shoup, p), p);
}
