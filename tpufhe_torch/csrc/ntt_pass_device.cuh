// The transform passes of the Hopper NTT kernels: the forward NTT of K1
// (ntt.cu) and of the key-switch tails K4 and K5 (keyswitch_device.cuh),
// the inverse NTT of K1, of K3 (tensor_intt.cu) and of K8 (intt_scale.cu),
// and both directions of the narrow K9 (ntt32.cu).
//
// Same transforms as the radix-2 stages of ops/ntt.py (the Harvey
// butterflies of fhe.rs ntt/native.rs:77-132, the bit-reversed tables of
// NttOperator, its bit-reversed output order), regrouped into passes of
// S = PASS_STAGES butterfly stages each: a thread loads a unit of 2^S
// words, applies the 2^S - 1 twiddles of the pass's stages in registers,
// and stores the unit back, so a row costs ceil(log2(n) / 2) barriers (7 at
// n = 8192, where the radix-2 loop has 13) and half the shared-memory
// traffic. Values stay lazy inside (forward [0, 4p), inverse [0, 2p)) and
// every output is canonical, so the regrouping gives the same integers;
// only the lazy forward (LAZY, K1's and K9's lazy instances) writes the
// last pass's words as they are, below 4p and congruent to those.
//
// The forward passes follow kernels.ntt_passes: one pass of log2(n) mod S
// stages first, so that the last passes have the unit strides pass_slot
// serves, then S a pass. The inverse runs the same passes in reverse
// order, each with Gentleman-Sande butterflies on the same units, so its
// passes have the forward schedule's strides and the same slots. Twiddles
// come from tables in pass order (kernels.forward_twiddle_order /
// inverse_twiddle_order, built once per NttTables): a unit's 2^S - 1
// (twiddle, Shoup) pairs lie together, one 16-byte load each.
//
// A pass moves a unit between shared memory and registers; the first pass
// of a row may read its units from device memory instead, and the last may
// write them there (canonical, the inverse with the n^{-1} fold), which
// saves a round trip through shared memory and a barrier at each end.
//
// The word type W is a template parameter: 64-bit words (p < 2^62, Shoup
// constants scaled by 2^64, (twiddle, Shoup) pairs as ulonglong2) or the
// narrow 32-bit words of K9 (p < 2^30, Shoup constants scaled by 2^32 as
// tpufhe/ops/zq32.py has them, pairs as uint2, one 8-byte load). The lazy
// bounds hold in both, since 4p < 2^32 for p < 2^30. The narrow rows also
// take S = 3 stages a pass (kernels.NARROW_PASS_STAGES): a unit of eight
// 4-byte words fits the registers where eight 8-byte words spilled.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "modarith.cuh"

// Butterfly stages a pass keeps in registers (kernels.PASS_STAGES). Three
// stages a pass (eight words and seven twiddle pairs) spill at the 40
// registers a thread has with three 512-thread CTAs an SM, and ran no
// faster in the tails.
#define PASS_STAGES 2

// Word i's place in shared memory. A two-stage pass's half-warp touches
// sixteen words that differ in bits 0..3 (unit stride 2^ls >= 16), or in
// {2, 3, 4, 5} (ls = 0) or {0, 1, 4, 5} (ls = 2); XORing bits 4, 5 into
// bits 0, 2 and 1, 3 maps each set one to one onto the low four bits, so
// the sixteen words fall in sixteen bank pairs.
__device__ __forceinline__ int pass_slot(int i) {
  return i ^ (((i >> 4) & 3) * 5);
}

// The same for 4-byte words, where a warp's 32 accesses must fall in 32
// distinct banks (slot mod 32). A warp's 32 units of a pass of S stages
// at stride 2^ls touch, for each word t of the unit, words that differ in
// bits {0 .. ls - 1} and {ls + S .. S + 4} (ls < 5), or in bits 0 .. 4.
// The passes of 2 and 3 stages have ls in {0, 2, 4} and {0, 3} below 5;
// XORing bit 5 into bits {0, 2}, bit 6 into {1, 3, 4} and bit 7 into
// {2, 4} maps each of those five-bit sets one to one onto bits 0 .. 4.
// The map is linear, so slot(a | b) = slot(a) ^ slot(b) for disjoint bits.
__device__ __forceinline__ int pass_slot32(int i) {
  return i ^ (((i >> 5) & 1) * 5) ^ (((i >> 6) & 1) * 26) ^
         (((i >> 7) & 1) * 20);
}

// The pass body's types per word: the (twiddle, Shoup) pair, and the
// 16-byte vector in which a unit of consecutive words moves.
template <typename W>
struct PassWord;

template <>
struct PassWord<u64> {
  typedef u64 Word;
  typedef ulonglong2 Pair;
  static constexpr int VEC = 2;  // words of a 16-byte vector
  static __device__ __forceinline__ int slot(int i) { return pass_slot(i); }
  static __device__ __forceinline__ void load16(const u64* s, u64* v) {
    const ulonglong2 w = *(const ulonglong2*)s;
    v[0] = w.x;
    v[1] = w.y;
  }
  static __device__ __forceinline__ void store16(u64* d, const u64* v) {
    *(ulonglong2*)d = make_ulonglong2(v[0], v[1]);
  }
};

template <>
struct PassWord<u32> {
  typedef u32 Word;
  typedef uint2 Pair;
  static constexpr int VEC = 4;
  static __device__ __forceinline__ int slot(int i) { return pass_slot32(i); }
  static __device__ __forceinline__ void load16(const u32* s, u32* v) {
    const uint4 w = *(const uint4*)s;
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  }
  static __device__ __forceinline__ void store16(u32* d, const u32* v) {
    *(uint4*)d = make_uint4(v[0], v[1], v[2], v[3]);
  }
};

// a b mod p in [0, 2p) for any u64 a: lazy_mul_shoup with q p subtracted
// as q (2^64 - p) added, the same word in fewer instructions.
__device__ __forceinline__ u64 shoup_np(u64 a, u64 b, u64 b_shoup, u64 np) {
  return a * b + mulhi64(a, b_shoup) * np;
}

// The same on narrow words: any u32 a, b < p < 2^30, b_shoup scaled by 2^32.
__device__ __forceinline__ u32 shoup_np(u32 a, u32 b, u32 b_shoup, u32 np) {
  return a * b + mulhi32(a, b_shoup) * np;
}

// The forward stages of one unit: stage r pairs t with t + 2^(S-1-r) under
// the unit's twiddle t / 2^(S-r) of that stage, at t[2^r - 1 + t / 2^(S-r)].
// Inputs and outputs < 4p.
template <int S, typename W>
__device__ __forceinline__ void forward_unit(
    W (&v)[1 << S], const typename PassWord<W>::Pair* t, W p, W np) {
  constexpr int U = 1 << S;
  const W p2 = 2 * p;
#pragma unroll
  for (int r = 0; r < S; ++r) {
    const int half = U >> (r + 1);
#pragma unroll
    for (int j = 0; j < (1 << r); ++j) {
      const typename PassWord<W>::Pair w = __ldg(t + (1 << r) - 1 + j);
#pragma unroll
      for (int i = 2 * half * j; i < 2 * half * j + half; ++i) {
        W x = v[i];
        x = x >= p2 ? x - p2 : x;
        const W y = shoup_np(v[i + half], w.x, w.y, np);
        v[i] = x + y;
        v[i + half] = x + p2 - y;
      }
    }
  }
}

// The inverse stages of one unit, the mirror of forward_unit: stage r
// pairs t with t + 2^r under the twiddle t / 2^(r+1) of that stage, at
// t[U - U / 2^r + t / 2^(r+1)]. Inputs and outputs < 2p.
template <int S, typename W>
__device__ __forceinline__ void inverse_unit(
    W (&v)[1 << S], const typename PassWord<W>::Pair* t, W p, W np) {
  constexpr int U = 1 << S;
  const W p2 = 2 * p;
#pragma unroll
  for (int r = 0; r < S; ++r) {
    const int half = 1 << r;
#pragma unroll
    for (int j = 0; j < U / (2 * half); ++j) {
      const typename PassWord<W>::Pair z = __ldg(t + U - (U >> r) + j);
#pragma unroll
      for (int i = 2 * half * j; i < 2 * half * j + half; ++i) {
        const W x = v[i], y = v[i + half];
        const W s = x + y;
        v[i] = s >= p2 ? s - p2 : s;
        v[i + half] = shoup_np(x + p2 - y, z.x, z.y, np);
      }
    }
  }
}

// One pass (s0, S) over the row a of 2^logn words in shared memory. Unit q
// of the 2^(logn - S) is the 2^S words first + t 2^ls of stage-s0 group
// g = q / 2^ls (ls = logn - s0 - S); its twiddles start at off + g (2^S - 1)
// in the table. INVERSE selects the Gentleman-Sande stages. FROM: when not
// null, the unit is read from this row in device memory instead of a (the
// row's first pass). TO: when not null, the unit is written to this row in
// device memory, canonical (the row's last pass; the inverse multiplies by
// f = n^{-1}, Shoup constant fs), and the pass ends without a barrier.
// KEEP: with TO null, the same last pass leaves the unit canonical in a at
// its slots, also without a barrier (the caller synchronises). LAZY: the
// forward's last pass writes TO its words as the butterflies leave them,
// below 4p (the lazy output of tpufhe's forward transforms).
// THREADS: the CTA's threads if known at compile time, else 0.
template <int S, int THREADS, bool INVERSE, bool KEEP = false,
          bool LAZY = false, typename W>
__device__ __forceinline__ void ntt_pass(
    W* a, int logn, int s0, int off, const typename PassWord<W>::Pair* tw,
    W p, W np, const typename PassWord<W>::Word* from = nullptr,
    typename PassWord<W>::Word* to = nullptr,
    typename PassWord<W>::Word f = 0, typename PassWord<W>::Word fs = 0) {
  typedef PassWord<W> PW;
  constexpr int U = 1 << S;
  constexpr int VEC = PW::VEC;
  const W p2 = 2 * p;
  const int ls = logn - s0 - S;
  const int units = 1 << (logn - S);
  const int stride = THREADS ? THREADS : (int)blockDim.x;
  // 8-byte words: where the unit's bits ls .. ls + S - 1 miss bits 4 and 5,
  // the bits pass_slot reads, one pass_slot call places all its words;
  // 4-byte words: pass_slot32 is linear, so a word's slot is the unit's
  // XOR the slot of its offset t 2^ls
  const bool apart = ls + S <= 4 || ls >= 6;
#pragma unroll 1
  for (int q = threadIdx.x; q < units; q += stride) {
    const int g = q >> ls;
    const int first = (g << (ls + S)) | (q & ((1 << ls) - 1));
    const int base = PW::slot(first);
    const typename PW::Pair* t = tw + off + g * (U - 1);
    int at[U];
    W v[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if constexpr (sizeof(W) == 8)
        at[i] = apart ? base ^ (i << ls) : pass_slot(first | (i << ls));
      else
        at[i] = base ^ pass_slot32(i << ls);
    }
    if (from) {
      if (ls == 0 && U >= VEC) {
        // the unit is 2^S consecutive words: 16-byte loads
#pragma unroll
        for (int i = 0; i + VEC <= U; i += VEC)
          PW::load16(from + first + i, v + i);
      } else {
#pragma unroll
        for (int i = 0; i < U; ++i) v[i] = from[first + (i << ls)];
      }
    } else {
#pragma unroll
      for (int i = 0; i < U; ++i) v[i] = a[at[i]];
    }
    if (INVERSE)
      inverse_unit<S>(v, t, p, np);
    else
      forward_unit<S>(v, t, p, np);
    if (to) {
#pragma unroll
      for (int i = 0; i < U; ++i) {
        if (INVERSE) {
          v[i] = mul_shoup(v[i], f, fs, p);
        } else if (!LAZY) {
          const W x = v[i] >= p2 ? v[i] - p2 : v[i];
          v[i] = x >= p ? x - p : x;
        }
      }
      if (ls == 0 && U >= VEC) {
#pragma unroll
        for (int i = 0; i + VEC <= U; i += VEC)
          PW::store16(to + first + i, v + i);
      } else {
#pragma unroll
        for (int i = 0; i < U; ++i) to[first + (i << ls)] = v[i];
      }
    } else {
      // KEEP: the same canonical words, kept in shared memory (a loop of
      // its own: sharing one with the branch above changes K1's code)
      if (KEEP) {
#pragma unroll
        for (int i = 0; i < U; ++i) {
          if (INVERSE) {
            v[i] = mul_shoup(v[i], f, fs, p);
          } else {
            const W x = v[i] >= p2 ? v[i] - p2 : v[i];
            v[i] = x >= p ? x - p : x;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < U; ++i) a[at[i]] = v[i];
    }
  }
  if (!to && !KEEP) __syncthreads();
}

// The forward passes of the row a (2^logn words at pass_slot), inputs and
// outputs < 4p, in shared memory: the tails' transform. LOGN: log2(n) if
// known at compile time, else 0 (logn_rt given). The caller synchronises
// before the call; the routine returns after a barrier.
template <int LOGN, int THREADS>
__device__ __forceinline__ void forward_passes(u64* a, int logn_rt,
                                               const ulonglong2* tw, u64 p) {
  const int logn = LOGN ? LOGN : logn_rt;
  const u64 np = 0 - p;
  const int lead = logn % PASS_STAGES;
  int off = 0;
  if (lead) {
    ntt_pass<1, THREADS, false>(a, logn, 0, 0, tw, p, np);
    off = 1;
  }
#pragma unroll
  for (int s0 = lead; s0 < logn; s0 += PASS_STAGES) {
    ntt_pass<PASS_STAGES, THREADS, false>(a, logn, s0, off, tw, p, np);
    off += ((1 << PASS_STAGES) - 1) << s0;
  }
}

// The forward NTT of the row src (2^logn canonical words in device memory)
// into dst, canonical (LAZY: below 4p), through the CTA's shared memory a:
// the first pass reads src and the last writes dst. S stages a pass (2, or
// 3 for narrow words); logn > S, or for S = 3 logn = 3, a row of one pass
// from src to dst.
template <int LOGN, int THREADS, int S = PASS_STAGES, bool LAZY = false,
          typename W>
__device__ __forceinline__ void forward_row(
    W* a, const typename PassWord<W>::Word* src,
    typename PassWord<W>::Word* dst, int logn_rt,
    const typename PassWord<W>::Pair* tw, W p) {
  static_assert(S == 2 || S == 3, "passes of 2 or 3 stages");
  const int logn = LOGN ? LOGN : logn_rt;
  const W np = 0 - p;
  if (S > 2 && logn == S) {
    ntt_pass<S, THREADS, false, false, LAZY>(a, logn, 0, 0, tw, p, np, src,
                                             dst);
    return;
  }
  int s0, off;
  if (logn % S) {
    if (S == 2 || logn % S == 1) {
      ntt_pass<1, THREADS, false>(a, logn, 0, 0, tw, p, np, src);
      s0 = off = 1;
    } else {
      ntt_pass<2, THREADS, false>(a, logn, 0, 0, tw, p, np, src);
      s0 = 2;
      off = 3;
    }
  } else {
    ntt_pass<S, THREADS, false>(a, logn, 0, 0, tw, p, np, src);
    s0 = S;
    off = (1 << S) - 1;
  }
#pragma unroll
  for (; s0 < logn - S; s0 += S) {
    ntt_pass<S, THREADS, false>(a, logn, s0, off, tw, p, np);
    off += ((1 << S) - 1) << s0;
  }
  ntt_pass<S, THREADS, false, false, LAZY>(a, logn, s0, off, tw, p, np,
                                           nullptr, dst);
}

// The inverse passes of a row of 2^logn words up to its last: the forward
// schedule's passes (s0, S) from the last to the one at s0 = lead (the
// forward's second), Gentleman-Sande, on the row a in shared memory. The
// first reads src in device memory if it is not null, else a. Returns the
// table offset the last pass starts at.
template <int LOGN, int THREADS, int S = PASS_STAGES, typename W>
__device__ __forceinline__ int inverse_passes(
    W* a, const typename PassWord<W>::Word* src, int logn,
    const typename PassWord<W>::Pair* tz, W p, W np) {
  const int lead = logn % S ? (S == 2 ? 1 : logn % S) : S;
  int s0 = logn - S, off = 0;
  ntt_pass<S, THREADS, true>(a, logn, s0, off, tz, p, np, src);
  off += ((1 << S) - 1) << s0;
#pragma unroll
  for (s0 -= S; s0 >= lead; s0 -= S) {
    ntt_pass<S, THREADS, true>(a, logn, s0, off, tz, p, np);
    off += ((1 << S) - 1) << s0;
  }
  return off;
}

// The inverse NTT of a row with the n^{-1} fold (f, Shoup constant fs),
// inputs < 2p, into dst in device memory, canonical. The first pass reads
// src in device memory if it is not null, else the row in shared memory a
// (at its slots). KEEP: dst is null and the last pass leaves the row
// canonical in a, at its slots, without a barrier. S and logn as
// forward_row.
template <int LOGN, int THREADS, int S = PASS_STAGES, bool KEEP = false,
          typename W>
__device__ __forceinline__ void inverse_row(
    W* a, const typename PassWord<W>::Word* src,
    typename PassWord<W>::Word* dst, int logn_rt,
    const typename PassWord<W>::Pair* tz, W p, typename PassWord<W>::Word f,
    typename PassWord<W>::Word fs) {
  static_assert(S == 2 || S == 3, "passes of 2 or 3 stages");
  const int logn = LOGN ? LOGN : logn_rt;
  const W np = 0 - p;
  if (S > 2 && logn == S) {
    ntt_pass<S, THREADS, true, KEEP>(a, logn, 0, 0, tz, p, np, src, dst, f,
                                     fs);
    return;
  }
  const int off = inverse_passes<LOGN, THREADS, S>(a, src, logn, tz, p, np);
  if (logn % S) {
    if (S == 2 || logn % S == 1)
      ntt_pass<1, THREADS, true, KEEP>(a, logn, 0, off, tz, p, np, nullptr,
                                       dst, f, fs);
    else
      ntt_pass<2, THREADS, true, KEEP>(a, logn, 0, off, tz, p, np, nullptr,
                                       dst, f, fs);
  } else {
    ntt_pass<S, THREADS, true, KEEP>(a, logn, 0, off, tz, p, np, nullptr,
                                     dst, f, fs);
  }
}

// The row split across a two-CTA cluster (n = 2^logn words, too many for
// one CTA's 64 KB): CTA `rank` holds half `rank` of the row, n / 2 words
// at pass_slot in a. Only stage 0 of the forward (and the inverse's last)
// pairs words of different halves. The tables (kernels.forward_twiddle_order
// / inverse_twiddle_order with split) hold the stages that cross the
// halves first, then each rank's pass-ordered twiddles of its half.
//
// Forward: each CTA reads all four quarters of the row from device memory
// (its partner reads the same lines at the same time, so L2 serves most of
// the second read) and applies stages 0 and 1 in registers as it stores
// its half: words i, i + n/4, i + n/2, i + 3n/4 in, the half's words i and
// i + n/4 out. Stages 2 .. logn - 1 are the half's own, a forward of
// logn - 1 stages whose twiddles carry the rank in their group's top bit:
// the passes kernels.ntt_passes(logn - 2, 1) over local stages 1 ..
// logn - 2, the last of which writes the half to dst (LAZY: below 4p).
// logn >= 4.
template <int LOGN, int THREADS, bool LAZY = false>
__device__ __forceinline__ void split_forward_row(u64* a, const u64* src,
                                                  u64* dst, int logn_rt,
                                                  int rank,
                                                  const ulonglong2* tw,
                                                  u64 p) {
  constexpr int S = PASS_STAGES;
  const int logn = LOGN ? LOGN : logn_rt;
  const int logh = logn - 1;  // the half's log2 size
  const int quarter = 1 << (logn - 2);
  const int stride = THREADS ? THREADS : (int)blockDim.x;
  const u64 np = 0 - p, p2 = 2 * p;
  const ulonglong2 w0 = __ldg(tw);  // stage 0: omega 1
  const ulonglong2* rt = tw + 1 + rank * ((1 << logh) - 1);
  const ulonglong2 w1 = __ldg(rt);  // stage 1, group rank: omega 2 + rank
#pragma unroll 2
  for (int i = threadIdx.x; i < quarter; i += stride) {
    const u64 x0 = src[i], x1 = src[i + quarter];
    const u64 y0 = shoup_np(src[i + 2 * quarter], w0.x, w0.y, np);
    const u64 y1 = shoup_np(src[i + 3 * quarter], w0.x, w0.y, np);
    // stage 0: the rank's side of (x0, y0) and (x1, y1), below 3p
    u64 b0 = rank ? x0 + p2 - y0 : x0 + y0;
    const u64 b1 = rank ? x1 + p2 - y1 : x1 + y1;
    // stage 1 on the half's pair (i, i + n/4)
    b0 = b0 >= p2 ? b0 - p2 : b0;
    const u64 t = shoup_np(b1, w1.x, w1.y, np);
    a[pass_slot(i)] = b0 + t;
    a[pass_slot(i + quarter)] = b0 + p2 - t;
  }
  __syncthreads();
  // local stages 1 .. logh - 1: one pass of (logh - 1) mod S stages if
  // odd, then S a pass; the last writes the half
  int s0 = 1, off = 1;
  if ((logh - 1) % S) {
    ntt_pass<1, THREADS, false>(a, logh, 1, 1, rt, p, np);
    s0 = 2;
    off = 3;
  }
  u64* out = dst + ((long long)rank << logh);
#pragma unroll
  for (; s0 < logh - S; s0 += S) {
    ntt_pass<S, THREADS, false>(a, logh, s0, off, rt, p, np);
    off += ((1 << S) - 1) << s0;
  }
  ntt_pass<S, THREADS, false, false, LAZY>(a, logh, s0, off, rt, p, np,
                                           nullptr, out);
}

// The inverse passes of one half of a split row (2^logh words at pass_slot
// in a) up to the row's last two stages: local stages 0 .. logh - 2, the
// passes of split_forward_row's half in reverse down to the one at local
// stage 1, the first reading the half from src in device memory. rt: the
// half's part of the split table (split_inverse_row; K8's pair of CTAs).
template <int THREADS>
__device__ __forceinline__ void split_inverse_half(u64* a, const u64* src,
                                                   int logh,
                                                   const ulonglong2* rt,
                                                   u64 p, u64 np) {
  constexpr int S = PASS_STAGES;
  int s0 = logh - S, off = 0;
  ntt_pass<S, THREADS, true>(a, logh, s0, off, rt, p, np, src);
  off += ((1 << S) - 1) << s0;
  const int lead = (logh - 1) % S ? 2 : 1;
#pragma unroll
  for (s0 -= S; s0 >= lead; s0 -= S) {
    ntt_pass<S, THREADS, true>(a, logh, s0, off, rt, p, np);
    off += ((1 << S) - 1) << s0;
  }
  if (lead == 2) ntt_pass<1, THREADS, true>(a, logh, 1, off, rt, p, np);
}

// Stage logn - 2 of a split row's inverse, within each half, on one word
// group: (x0, x1) = words i, i + n/4 of half 0 under z0, (y0, y1) those of
// half 1 under z1; the sums come back below 2p.
__device__ __forceinline__ void split_inner_stage(u64& x0, u64& x1, u64& y0,
                                                  u64& y1, ulonglong2 z0,
                                                  ulonglong2 z1, u64 p2,
                                                  u64 np) {
  u64 s = x0 + x1;
  x1 = shoup_np(x0 + p2 - x1, z0.x, z0.y, np);
  x0 = s >= p2 ? s - p2 : s;
  s = y0 + y1;
  y1 = shoup_np(y0 + p2 - y1, z1.x, z1.y, np);
  y0 = s >= p2 ? s - p2 : s;
}

// Inverse: each CTA runs the inverse passes of local stages 0 .. logn - 3
// on its half (read from device memory by the first), then after
// cluster.sync() reads its partner's half through distributed shared
// memory and applies the last two stages (logn - 2 within each half,
// logn - 1 across them) and the n^{-1} fold to its half's words i and
// i + n/4, which it writes straight to dst. A second cluster.sync() keeps
// each half alive until its partner has read it.
template <int LOGN, int THREADS>
__device__ __forceinline__ void split_inverse_row(u64* a, const u64* src,
                                                  u64* dst, int logn_rt,
                                                  int rank,
                                                  const ulonglong2* tz, u64 p,
                                                  u64 f, u64 fs) {
  namespace cg = cooperative_groups;
  const int logn = LOGN ? LOGN : logn_rt;
  const int logh = logn - 1;
  const int quarter = 1 << (logn - 2);
  const int stride = THREADS ? THREADS : (int)blockDim.x;
  const u64 np = 0 - p, p2 = 2 * p;
  const ulonglong2* rt = tz + 3 + rank * ((1 << logh) - 2);
  const long long half_at = (long long)rank << logh;
  split_inverse_half<THREADS>(a, src + half_at, logh, rt, p, np);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const u64* h0 = cluster.map_shared_rank(a, 0);
  const u64* h1 = cluster.map_shared_rank(a, 1);
  const ulonglong2 z0 = __ldg(tz), z1 = __ldg(tz + 1), z2 = __ldg(tz + 2);
  u64* out = dst + half_at;
#pragma unroll 2
  for (int i = threadIdx.x; i < quarter; i += stride) {
    const int s_lo = pass_slot(i), s_hi = pass_slot(i + quarter);
    u64 x0 = h0[s_lo], x1 = h0[s_hi], y0 = h1[s_lo], y1 = h1[s_hi];
    split_inner_stage(x0, x1, y0, y1, z0, z1, p2, np);
    // stage logn - 1 across the halves, the rank's side, then n^{-1}
    u64 o0, o1;
    if (rank) {
      o0 = shoup_np(x0 + p2 - y0, z2.x, z2.y, np);
      o1 = shoup_np(x1 + p2 - y1, z2.x, z2.y, np);
    } else {
      o0 = x0 + y0;
      o1 = x1 + y1;
    }
    out[i] = mul_shoup(o0, f, fs, p);
    out[i + quarter] = mul_shoup(o1, f, fs, p);
  }
  cluster.sync();
}

// The kernel's attributes, and the configuration of a launch of `ctas`
// CTAs of `threads` threads and `smem` dynamic shared bytes in clusters of
// `cluster` CTAs (above 8 the card's non-portable cluster size).
template <typename Args>
inline cudaError_t pass_config(void (*kernel)(Args), long long ctas,
                               int cluster, int threads, int smem,
                               cudaStream_t stream, cudaLaunchConfig_t* cfg,
                               cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)ctas);
  cfg->blockDim = dim3((unsigned)threads);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename Args>
inline int pass_launch(void (*kernel)(Args), const Args& a, long long ctas,
                       int cluster, int threads, int smem, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = pass_config(kernel, ctas, cluster, threads, smem,
                                (cudaStream_t)stream, &cfg, &attr);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// CTAs of the kernel one SM holds, and clusters the card holds at once.
template <typename Args>
inline int pass_occupancy(void (*kernel)(Args), int cluster, int threads,
                          int smem, int* blocks_per_sm, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      pass_config(kernel, cluster, cluster, threads, smem, 0, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, threads, cfg.dynamicSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  return (int)err;
}
