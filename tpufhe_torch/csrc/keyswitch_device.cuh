// The Garner-decomposition key switch of the relinearization tail (K4,
// relin_tail.cu), the Galois tail (K5, rotate_tail.cu) and the key switch
// alone (ks_tail, relin_tail.cu): per (batch row, limb j), in the NTT
// domain,
//   acc0 = sum_i NTT(d_i) ksk0_i[j],  acc1 = sum_i NTT(d_i) ksk1_i[j]
// where d_i is limb i of the power-basis row c2 reduced modulo p_j (fhe.rs
// key_switching_key.rs:214-241); K4 adds NTT(c0), NTT(c1) of limb j, K5
// adds the NTT-domain s0, ks_tail adds nothing (tpufhe's mode "ks_only").
// K4 and K5 have as many digit rows as limbs (d = k); ks_tail also takes
// the d < k rows of a leveled key, one per ciphertext modulus over the
// key's k moduli, whose first d moduli are the ciphertext's (the wrapper
// checks it), so limb i of c2 is a residue modulo key limb i.
//
// What bounds it: per (row, limb) the d (K5, ks_tail) or d + 2 (K4) forward
// transforms and 2k Shoup products a coefficient are integer multiplies
// (about twice the memory bound at n = 8192); the design that held three
// 64 KB rows in one 1024-thread block ran one block per SM, 13 barriers a
// transform, and lost most of its time to both.
//
// Design: one thread-block cluster per (batch row, limb j). The (row, limb)
// has R rows to transform: the digits d_0 .. d_{d-1}, then for K4 c0 and c1.
// CTA r of the cluster's C = min(R, 16) CTAs (kernels.tail_plan) holds row
// r alone in shared memory (n words: 64 KB at n = 8192, a K1 block's
// footprint, so three 512-thread CTAs share an SM), reduces it and
// forward-transforms it. After
// cluster.sync() CTA r finishes its 1/C slice of the n coefficients of both
// outputs: it reads that slice of every row of the cluster through
// distributed shared memory, forms the Shoup products with the key, adds,
// and writes each output word once. A second cluster.sync() keeps every row
// alive until the cluster's last read. Neither the lifted rows nor the sums
// reach device memory. R > 16 (no program has it; C > 8 needs the
// non-portable cluster size) runs in rounds of C rows, each CTA keeping its
// slice's partial sums in the output between rounds.
//
// The transform is the forward of ntt_pass_device.cuh (forward_passes),
// which K1 shares: two butterfly stages a pass in registers, so seven
// barriers a row at n = 8192, its twiddles from the pass-ordered table of
// NttTables.pass_twiddles (a unit's three (omega, Shoup) pairs lie
// together), a fixed instance for n = 8192 and 4096 (the programs' rings)
// and a general one for any other n. Words sit in shared memory at
// pass_slot(i), a swizzle that keeps each pass's 8-byte accesses free of
// bank conflicts.
//
// Every output is canonical, and every sum is an exact sum mod p of
// canonical terms, so the order of the adds does not change the integers.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ntt_pass_device.cuh"

// Threads of a tail CTA (at most; n / 2 below n = 1024), and the CTAs an SM
// must hold: three rows of 64 KB share its 228 KB.
#define TAIL_THREADS 512
#define TAIL_MIN_BLOCKS 3
// Optional timestamps at the phases of a CTA (scripts/tail_profile.py).
#ifndef TAIL_STAMP
#define TAIL_STAMP(phase)
#endif

struct TailArgs {
  const u64* c2;    // (rows, d, n) power basis; limb i of a row gives d_i
  const u64* add;   // K4: (2, rows, k, n) power-basis c0, c1; K5: s0;
                    // ks_tail: null
  u64* out;         // (2, rows, k, n)
  long long plane;  // rows * k * n words
  const u64 *k0, *k0s, *k1, *k1s;  // (d, k, n): [i][j] = digit i, limb j
  const ulonglong2* tw;  // (k, n) pass-ordered (omega, Shoup) pairs
  const u64 *limb_p, *b_lo, *b_hi;  // (k,) moduli and Barrett constants
  int k, n, logn;
  int d;  // digit rows; last, so K4's and K5's parameters keep their places
};

typedef void (*TailKernel)(TailArgs);

// The modes of the tail body: K4's rows and adds, K5's add of s0, or the
// key switch alone.
enum TailMode { TAIL_RELIN, TAIL_ROTATE, TAIL_KS };

// The body of a tail kernel in mode MODE. LOGN: log2(n) of a fixed instance
// (TAIL_THREADS threads), 0 for any n.
template <TailMode MODE, int LOGN>
__device__ __forceinline__ void keyswitch_tail(const TailArgs& a) {
  constexpr bool RELIN = MODE == TAIL_RELIN;
  namespace cg = cooperative_groups;
  extern __shared__ u64 row[];
  constexpr int THREADS = LOGN ? TAIL_THREADS : 0;
  TAIL_STAMP(0);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // K4 and K5 have a digit row per limb: with digits = k known to the
  // compiler their code stays that of a k-row body
  const int k = a.k, digits = MODE == TAIL_KS ? a.d : k;
  const int n = LOGN ? 1 << LOGN : a.n;
  const int stride = THREADS ? THREADS : (int)blockDim.x;
  const long long blk = blockIdx.x / C;  // (batch row, limb j)
  const long long brow = blk / k;
  const int j = (int)(blk - brow * k);
  const Barrett br = {a.limb_p[j], a.b_lo[j], a.b_hi[j]};
  const u64 p = br.p, np = 0 - p;
  const ulonglong2* tw = a.tw + (long long)j * n;
  const u64* c2 = a.c2 + brow * digits * n;
  const long long at = blk * n;  // this (row, limb) within a plane
  const int rows = RELIN ? digits + 2 : digits;
  // the slice this CTA finishes, in whole 32-word pieces
  const int span = ((n + C - 1) / C + 31) & ~31;
  const int lo = rank * span;
  const int hi = min(n, lo + span);
  const u64 p2 = 2 * p, p4 = 4 * p;
  for (int base = 0; base < rows; base += C) {
    const int mine = base + rank;
    if (mine < rows) {
      if (mine < digits) {
        // the transform takes inputs below 4p, so a limb of c2 whose
        // modulus is at most 4 p_j (every limb when the moduli differ by
        // less than a factor 4) needs no reduction
        const u64* src = c2 + (long long)mine * n;
        if (a.limb_p[mine] > p4) {
          for (int e = threadIdx.x; e < n; e += stride) {
            const u64 x = src[e];
            row[pass_slot(e)] = x < p4 ? x : reduce_u64(x, br);
          }
        } else {
#pragma unroll 4
          for (int e = threadIdx.x; e < n; e += stride)
            row[pass_slot(e)] = src[e];
        }
      } else {
        const u64* src = a.add + (mine - digits) * a.plane + at;
#pragma unroll 4
        for (int e = threadIdx.x; e < n; e += stride)
          row[pass_slot(e)] = src[e];
      }
      __syncthreads();
      TAIL_STAMP(1);
      forward_passes<LOGN, THREADS>(row, a.logn, tw, p);
      TAIL_STAMP(2);
    }
    cluster.sync();
    // this round's rows base .. base + cnt - 1: nd digits, then (K4) c0, c1
    const int cnt = min(C, rows - base);
    const int nd = max(0, min(cnt, digits - base));
    const bool last = base + C >= rows;
    const int kstep = k * n;
    // sums stay below 2p: each term is below 2p (a lazy Shoup product, or
    // a transformed row reduced once), so term + sum < 4p < 2^64
    for (int e = lo + threadIdx.x; e < hi; e += stride) {
      u64 acc0 = 0, acc1 = 0;
      if (base) {
        acc0 = a.out[at + e];
        acc1 = a.out[a.plane + at + e];
      }
      const int se = pass_slot(e);
      const int ko = (base * k + j) * n + e;
#pragma unroll 2
      for (int q = 0; q < nd; ++q) {
        const u64 d = cluster.map_shared_rank(row, q)[se];  // lazy, < 4p
        const int o = ko + q * kstep;
        acc0 += shoup_np(d, __ldg(a.k0 + o), __ldg(a.k0s + o), np);
        acc1 += shoup_np(d, __ldg(a.k1 + o), __ldg(a.k1s + o), np);
        acc0 = acc0 >= p2 ? acc0 - p2 : acc0;
        acc1 = acc1 >= p2 ? acc1 - p2 : acc1;
      }
      if (RELIN) {
        for (int q = nd; q < cnt; ++q) {
          u64 d = cluster.map_shared_rank(row, q)[se];
          d = d >= p2 ? d - p2 : d;
          if (base + q == digits) {
            acc0 += d;
            acc0 = acc0 >= p2 ? acc0 - p2 : acc0;
          } else {
            acc1 += d;
            acc1 = acc1 >= p2 ? acc1 - p2 : acc1;
          }
        }
      } else if (MODE == TAIL_ROTATE && last) {
        acc0 += a.add[at + e];
        acc0 = acc0 >= p2 ? acc0 - p2 : acc0;
      }
      a.out[at + e] = reduce1(acc0, p);
      a.out[a.plane + at + e] = reduce1(acc1, p);
    }
    cluster.sync();
  }
  TAIL_STAMP(3);
}

// rows_k: batch rows * k output limbs; d: digit rows (limbs of c2).
inline TailArgs tail_args(const void* c2, const void* add, void* out,
                          long long rows_k, int d, int k, int n,
                          const void* k0, const void* k0s, const void* k1,
                          const void* k1s, const void* tw,
                          const void* limb_p, const void* b_lo,
                          const void* b_hi) {
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  return TailArgs{(const u64*)c2, (const u64*)add, (u64*)out, rows_k * n,
                  (const u64*)k0, (const u64*)k0s, (const u64*)k1,
                  (const u64*)k1s, (const ulonglong2*)tw,
                  (const u64*)limb_p, (const u64*)b_lo, (const u64*)b_hi,
                  k, n, logn, d};
}

// The instance that runs degree n at `threads` threads a CTA: the fixed
// one for n = 8192 or 4096 at TAIL_THREADS, else the general one.
inline TailKernel tail_instance(int n, int threads, TailKernel n8192,
                                TailKernel n4096, TailKernel any) {
  if (threads != TAIL_THREADS) return any;
  return n == 8192 ? n8192 : n == 4096 ? n4096 : any;
}

// One cluster per (batch row, limb): rows_k clusters of one n-word row a
// CTA.
inline int launch_tail(TailKernel kernel, const TailArgs& a, long long rows_k,
                       int cluster, int threads, void* stream) {
  return pass_launch(kernel, a, rows_k * cluster, cluster, threads,
                     a.n * (int)sizeof(u64), stream);
}

// CTAs of the kernel one SM holds, and clusters the card holds at once.
inline int tail_occupancy(TailKernel kernel, int n, int cluster, int threads,
                          int* blocks_per_sm, int* clusters) {
  return pass_occupancy(kernel, cluster, threads, n * (int)sizeof(u64),
                        blocks_per_sm, clusters);
}
