// The Garner-decomposition key switch of the relinearization tail (K4,
// relin_tail.cu) and the Galois tail (K5, rotate_tail.cu): per (batch row,
// limb j), in the NTT domain,
//   acc0 = sum_i NTT(d_i) ksk0_i[j],  acc1 = sum_i NTT(d_i) ksk1_i[j]
// where d_i is limb i of the power-basis row c2 reduced modulo p_j (fhe.rs
// key_switching_key.rs:214-241); K4 adds NTT(c0), NTT(c1) of limb j, K5
// adds the NTT-domain s0.
//
// What bounds it: per (row, limb) the k (K5) or k + 2 (K4) forward
// transforms and 2k Shoup products a coefficient are integer multiplies
// (about twice the memory bound at n = 8192); the design that held three
// 64 KB rows in one 1024-thread block ran one block per SM, 13 barriers a
// transform, and lost most of its time to both.
//
// Design: one thread-block cluster per (batch row, limb j). The (row, limb)
// has R rows to transform: the digits d_0 .. d_{k-1}, then for K4 c0 and c1.
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
// The transform (tail_forward) runs TAIL_STAGES = 2 butterfly stages a pass
// in registers: a thread loads a unit of four words, applies the three
// twiddles of the two stages, and stores the unit back, so a row costs
// ceil(log2(n) / 2) barriers (7 at n = 8192, where the radix-2 loop of
// ntt_device.cuh has 13) and half its shared-memory traffic. Three stages a
// pass (eight words and seven twiddle pairs) spill more at the 40
// registers a thread has with three CTAs an SM and ran no faster. The
// twiddles come from a table in pass order (pipeline.tail_twiddles,
// kernels.tail_twiddle_order): a unit's three (omega, Shoup) pairs lie
// together, three 16-byte loads at one address. A fixed instance for
// n = 8192 and 4096 (the programs' rings) knows every pass's strides at
// compile time; any other n runs the general instance. The butterflies are
// ntt_device.cuh's Harvey butterflies in the same order on every word
// (values lazy in [0, 4p)), so the outputs are the same integers. Words sit
// in shared memory at tail_slot(i), a swizzle that keeps each pass's 8-byte
// accesses free of bank conflicts.
//
// Every output is canonical, and every sum is an exact sum mod p of
// canonical terms, so the order of the adds does not change the integers.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "modarith.cuh"

// Threads of a tail CTA (at most; n / 2 below n = 1024), and the CTAs an SM
// must hold: three rows of 64 KB share its 228 KB.
#define TAIL_THREADS 512
#define TAIL_MIN_BLOCKS 3
// Butterfly stages a transform pass keeps in registers (kernels.TAIL_STAGES).
#define TAIL_STAGES 2
// Optional timestamps at the phases of a CTA (scripts/tail_profile.py).
#ifndef TAIL_STAMP
#define TAIL_STAMP(phase)
#endif

struct TailArgs {
  const u64* c2;    // (rows, k, n) power basis; limb i of a row gives d_i
  const u64* add;   // K4: (2, rows, k, n) power-basis c0, c1; K5: s0
  u64* out;         // (2, rows, k, n)
  long long plane;  // rows * k * n words
  const u64 *k0, *k0s, *k1, *k1s;  // (k, k, n): [i][j] = digit i, limb j
  const ulonglong2* tw;  // (k, n) pass-ordered (omega, Shoup) pairs
  const u64 *limb_p, *b_lo, *b_hi;  // (k,) moduli and Barrett constants
  int k, n, logn;
};

typedef void (*TailKernel)(TailArgs);

// Word i's place in shared memory. A two-stage pass's half-warp touches
// sixteen words that differ in bits 0..3 (unit stride 2^ls >= 16), or in
// {2, 3, 4, 5} (ls = 0) or {0, 1, 4, 5} (ls = 2); XORing bits 4, 5 into
// bits 0, 2 and 1, 3 maps each set one to one onto the low four bits, so
// the sixteen words fall in sixteen bank pairs.
__device__ __forceinline__ int tail_slot(int i) {
  return i ^ (((i >> 4) & 3) * 5);
}

// a b mod p in [0, 2p) for any u64 a: lazy_mul_shoup with q p subtracted
// as q (2^64 - p) added, the same word in fewer instructions.
__device__ __forceinline__ u64 shoup_np(u64 a, u64 b, u64 b_shoup, u64 np) {
  return a * b + mulhi64(a, b_shoup) * np;
}

// Stages s0 .. s0 + S - 1 of the forward transform of the row a. Unit q of
// the 2^(logn - S) is the 2^S words first + t 2^ls of stage-s0 group
// g = q / 2^ls (ls = logn - s0 - S); stage s0 + r pairs t with
// t + 2^(S-1-r) under the group's twiddle t / 2^(S-r) of that stage,
// w[2^(s0+r) + g 2^r + t / 2^(S-r)], as ntt_forward_rows pairs them. The
// pass's twiddles start at `off` in the table, 2^S - 1 a group. THREADS: the
// CTA's threads if known at compile time, else 0.
template <int S, int THREADS>
__device__ __forceinline__ void tail_pass(u64* a, int logn, int s0, int off,
                                          const ulonglong2* tw, u64 p,
                                          u64 np) {
  constexpr int U = 1 << S;
  const u64 p2 = 2 * p;
  const int ls = logn - s0 - S;
  const int units = 1 << (logn - S);
  const int stride = THREADS ? THREADS : (int)blockDim.x;
  // where the unit's bits ls .. ls + S - 1 miss bits 4 and 5, the bits
  // tail_slot reads, one tail_slot call places all its words
  const bool apart = ls + S <= 4 || ls >= 6;
#pragma unroll 1
  for (int q = threadIdx.x; q < units; q += stride) {
    const int g = q >> ls;
    const int first = (g << (ls + S)) | (q & ((1 << ls) - 1));
    const int base = tail_slot(first);
    const ulonglong2* t = tw + off + g * (U - 1);
    int at[U];
    u64 v[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      at[i] = apart ? base ^ (i << ls) : tail_slot(first | (i << ls));
      v[i] = a[at[i]];
    }
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const int half = U >> (r + 1);
#pragma unroll
      for (int j = 0; j < (1 << r); ++j) {
        const ulonglong2 w = __ldg(t + (1 << r) - 1 + j);
#pragma unroll
        for (int i = 2 * half * j; i < 2 * half * j + half; ++i) {
          u64 x = v[i];
          x = x >= p2 ? x - p2 : x;
          const u64 y = shoup_np(v[i + half], w.x, w.y, np);
          v[i] = x + y;
          v[i + half] = x + p2 - y;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) a[at[i]] = v[i];
  }
  __syncthreads();
}

// The forward transform of the row a, inputs < 4p, outputs < 4p: one pass
// of log2(n) mod TAIL_STAGES stages first, so that the last passes have
// the unit strides tail_slot serves, then TAIL_STAGES a pass. LOGN: log2(n)
// if known at compile time, else 0 (logn given).
template <int LOGN, int THREADS>
__device__ __forceinline__ void tail_forward(u64* a, int logn_rt,
                                             const ulonglong2* tw, u64 p) {
  const int logn = LOGN ? LOGN : logn_rt;
  const u64 np = 0 - p;
  const int lead = logn % TAIL_STAGES;
  int off = 0;
  if (lead) {
    tail_pass<1, THREADS>(a, logn, 0, 0, tw, p, np);
    off = 1;
  }
#pragma unroll
  for (int s0 = lead; s0 < logn; s0 += TAIL_STAGES) {
    tail_pass<TAIL_STAGES, THREADS>(a, logn, s0, off, tw, p, np);
    off += ((1 << TAIL_STAGES) - 1) << s0;
  }
}

// The body of a tail kernel; RELIN selects K4's rows and adds, else K5's.
// LOGN: log2(n) of a fixed instance (TAIL_THREADS threads), 0 for any n.
template <bool RELIN, int LOGN>
__device__ __forceinline__ void keyswitch_tail(const TailArgs& a) {
  namespace cg = cooperative_groups;
  extern __shared__ u64 row[];
  constexpr int THREADS = LOGN ? TAIL_THREADS : 0;
  TAIL_STAMP(0);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int k = a.k;
  const int n = LOGN ? 1 << LOGN : a.n;
  const int stride = THREADS ? THREADS : (int)blockDim.x;
  const long long blk = blockIdx.x / C;  // (batch row, limb j)
  const long long brow = blk / k;
  const int j = (int)(blk - brow * k);
  const Barrett br = {a.limb_p[j], a.b_lo[j], a.b_hi[j]};
  const u64 p = br.p, np = 0 - p;
  const ulonglong2* tw = a.tw + (long long)j * n;
  const u64* c2 = a.c2 + brow * k * n;
  const long long at = blk * n;  // this (row, limb) within a plane
  const int rows = RELIN ? k + 2 : k;
  // the slice this CTA finishes, in whole 32-word pieces
  const int span = ((n + C - 1) / C + 31) & ~31;
  const int lo = rank * span;
  const int hi = min(n, lo + span);
  const u64 p2 = 2 * p, p4 = 4 * p;
  for (int base = 0; base < rows; base += C) {
    const int mine = base + rank;
    if (mine < rows) {
      if (mine < k) {
        // the transform takes inputs below 4p, so a limb of c2 whose
        // modulus is at most 4 p_j (every limb when the moduli differ by
        // less than a factor 4) needs no reduction
        const u64* src = c2 + (long long)mine * n;
        if (a.limb_p[mine] > p4) {
          for (int e = threadIdx.x; e < n; e += stride) {
            const u64 x = src[e];
            row[tail_slot(e)] = x < p4 ? x : reduce_u64(x, br);
          }
        } else {
#pragma unroll 4
          for (int e = threadIdx.x; e < n; e += stride)
            row[tail_slot(e)] = src[e];
        }
      } else {
        const u64* src = a.add + (mine - k) * a.plane + at;
#pragma unroll 4
        for (int e = threadIdx.x; e < n; e += stride)
          row[tail_slot(e)] = src[e];
      }
      __syncthreads();
      TAIL_STAMP(1);
      tail_forward<LOGN, THREADS>(row, a.logn, tw, p);
      TAIL_STAMP(2);
    }
    cluster.sync();
    // this round's rows base .. base + cnt - 1: nd digits, then (K4) c0, c1
    const int cnt = min(C, rows - base);
    const int nd = max(0, min(cnt, k - base));
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
      const int se = tail_slot(e);
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
          if (base + q == k) {
            acc0 += d;
            acc0 = acc0 >= p2 ? acc0 - p2 : acc0;
          } else {
            acc1 += d;
            acc1 = acc1 >= p2 ? acc1 - p2 : acc1;
          }
        }
      } else if (last) {
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

inline TailArgs tail_args(const void* c2, const void* add, void* out,
                          long long rows_k, int k, int n, const void* k0,
                          const void* k0s, const void* k1, const void* k1s,
                          const void* tw, const void* limb_p,
                          const void* b_lo, const void* b_hi) {
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  return TailArgs{(const u64*)c2, (const u64*)add, (u64*)out, rows_k * n,
                  (const u64*)k0, (const u64*)k0s, (const u64*)k1,
                  (const u64*)k1s, (const ulonglong2*)tw,
                  (const u64*)limb_p, (const u64*)b_lo, (const u64*)b_hi,
                  k, n, logn};
}

// The instance that runs degree n at `threads` threads a CTA: the fixed
// one for n = 8192 or 4096 at TAIL_THREADS, else the general one.
inline TailKernel tail_instance(int n, int threads, TailKernel n8192,
                                TailKernel n4096, TailKernel any) {
  if (threads != TAIL_THREADS) return any;
  return n == 8192 ? n8192 : n == 4096 ? n4096 : any;
}

// The kernel's attributes, and a launch of `clusters` clusters of `cluster`
// CTAs of `threads` threads with one n-word row each.
inline cudaError_t tail_config(TailKernel kernel, long long clusters,
                               int cluster, int threads, int n,
                               cudaStream_t stream, cudaLaunchConfig_t* cfg,
                               cudaLaunchAttribute* attr) {
  const int smem = n * (int)sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(clusters * cluster));
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

// One cluster per (batch row, limb): rows_k clusters.
inline int launch_tail(TailKernel kernel, const TailArgs& a, long long rows_k,
                       int cluster, int threads, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = tail_config(kernel, rows_k, cluster, threads, a.n,
                                (cudaStream_t)stream, &cfg, &attr);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// CTAs of the kernel one SM holds, and clusters the card holds at once.
inline int tail_occupancy(TailKernel kernel, int n, int cluster, int threads,
                          int* blocks_per_sm, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      tail_config(kernel, 1, cluster, threads, n, 0, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, threads, cfg.dynamicSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  return (int)err;
}
