// K1: forward / inverse negacyclic NTT of a batch of RNS rows.
//
// Replaces tpufhe/ops/pallas/mxu_ntt_kernel.py:_mxu4_kernel (wrapper
// mxu4_pallas), which computes the same transform on the TPU as a
// four-step product of int8 digit planes so that the matrix unit can do
// the work. Hopper has 64-bit integer multiplies on every core, so this
// kernel runs Harvey butterflies directly.
//
// Data: x (rows, k_sel, n) int64 words read as u64, canonical residues;
// y the same shape, canonical, or for a lazy forward (tpufhe's `lazy`
// flag, mxu_ntt_kernel.py:319 and ntt_kernel.py:156) the last pass's
// words unreduced, below 4p (up to 2^64 for a 62-bit p). Row b belongs
// to limb limb0 + b mod k_sel, whose modulus and pass-ordered table
// (NttTables.pass_twiddles, the counterpart of limb_slice) serve it; the
// tables are shared by every row of a limb and stay in L2.
//
// Bound on this card: each word moves 16 bytes through device memory and
// needs log2(n) / 2 Shoup products (about ten int32 multiplies each), so
// at n = 8192 the memory bound (about 0.04 us a row at 3.35 TB/s) is above
// the multiply bound (about 0.03 us at 16.7 T int32 multiplies/s). What
// held the radix-2 design far above both was the barrier of every stage,
// the shared-memory round trip of every stage, and at n = 16384 a 128 KB
// row that left one CTA an SM.
//
// Design: the passes of ntt_pass_device.cuh, shared with K3, K4 and K5:
// two butterfly stages a pass in registers, words at a bank-conflict-free
// swizzled slot, (twiddle, Shoup) pairs in pass order. The first pass
// reads its units straight from device memory and the last writes them
// there (the inverse with the n^{-1} fold), so a row at n = 8192 costs six
// barriers and five shared-memory round trips (the radix-2 loop: fourteen
// and fifteen).
// - n <= 8192: one CTA per row, at most 512 threads, the row in shared
//   memory (64 KB at n = 8192, so three CTAs share an SM's 228 KB); fixed
//   instances for n = 8192 and 4096 (the programs' rings) know every pass's
//   strides at compile time, a general one serves any other n.
// - n = 16384: the row split across a cluster of two 64 KB CTAs
//   (split_forward_row / split_inverse_row), three CTAs an SM where the
//   whole 128 KB row allowed one. The forward's stages 0 and 1 run as each
//   CTA loads (it reads the whole row; L2 serves the second read), the
//   inverse's last two after a cluster.sync(), through distributed shared
//   memory. kernels.ntt_plan gives the launch plan.
#include "ntt_pass_device.cuh"

// Threads of a CTA (at most; n / 4 below n = 2048), the CTAs an SM must
// hold (three 64 KB rows share its 228 KB, 40 registers a thread), and the
// longest row one CTA holds (kernels.NTT_ROW_MAX).
#define NTT_THREADS 512
#define NTT_MIN_BLOCKS 3
#define NTT_ROW_MAX 8192

struct NttArgs {
  const u64* x;
  u64* y;
  const ulonglong2* tw;  // (k_ctx, n) pass-ordered (twiddle, Shoup) pairs
  const u64 *limb_p, *ninv, *ninv_s;  // (k_ctx,)
  int k_sel, n, logn, limb0;
};

typedef void (*NttKernel)(NttArgs);

// One CTA per row. LOGN: log2(n) of a fixed instance (NTT_THREADS
// threads), 0 for any n. LAZY: a forward whose output stays below 4p.
template <int LOGN, bool INVERSE, bool LAZY = false>
__global__ void __launch_bounds__(NTT_THREADS, NTT_MIN_BLOCKS)
    ntt_row_kernel(const NttArgs a) {
  extern __shared__ u64 row[];
  constexpr int THREADS = LOGN ? NTT_THREADS : 0;
  const int n = LOGN ? 1 << LOGN : a.n;
  const long long blk = blockIdx.x;
  const int limb = a.limb0 + (int)(blk % a.k_sel);
  const u64 p = a.limb_p[limb];
  const ulonglong2* tw = a.tw + (long long)limb * n;
  const u64* src = a.x + blk * n;
  u64* dst = a.y + blk * n;
  if (INVERSE)
    inverse_row<LOGN, THREADS>(row, src, dst, a.logn, tw, p, a.ninv[limb],
                               a.ninv_s[limb]);
  else
    forward_row<LOGN, THREADS, PASS_STAGES, LAZY>(row, src, dst, a.logn, tw,
                                                  p);
}

// One cluster of two CTAs per row, CTA r holding half r.
template <int LOGN, bool INVERSE, bool LAZY = false>
__global__ void __launch_bounds__(NTT_THREADS, NTT_MIN_BLOCKS)
    ntt_split_kernel(const NttArgs a) {
  extern __shared__ u64 row[];
  constexpr int n = 1 << LOGN;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const long long blk = blockIdx.x >> 1;
  const int limb = a.limb0 + (int)(blk % a.k_sel);
  const u64 p = a.limb_p[limb];
  const ulonglong2* tw = a.tw + (long long)limb * n;
  const u64* src = a.x + blk * n;
  u64* dst = a.y + blk * n;
  if (INVERSE)
    split_inverse_row<LOGN, NTT_THREADS>(row, src, dst, LOGN, rank, tw, p,
                                         a.ninv[limb], a.ninv_s[limb]);
  else
    split_forward_row<LOGN, NTT_THREADS, LAZY>(row, src, dst, LOGN, rank, tw,
                                               p);
}

// The instance that runs degree n at `threads` threads a CTA, or null; a
// lazy inverse does not exist.
static NttKernel ntt_instance(int n, int inverse, int lazy, int threads) {
  if (inverse && lazy) return nullptr;
  if (n > NTT_ROW_MAX) {
    if (n != 2 * NTT_ROW_MAX || threads != NTT_THREADS) return nullptr;
    return inverse ? ntt_split_kernel<14, true>
           : lazy  ? ntt_split_kernel<14, false, true>
                   : ntt_split_kernel<14, false>;
  }
  if (n < 8) return nullptr;
  if (threads == NTT_THREADS && n == 8192)
    return inverse ? ntt_row_kernel<13, true>
           : lazy  ? ntt_row_kernel<13, false, true>
                   : ntt_row_kernel<13, false>;
  if (threads == NTT_THREADS && n == 4096)
    return inverse ? ntt_row_kernel<12, true>
           : lazy  ? ntt_row_kernel<12, false, true>
                   : ntt_row_kernel<12, false>;
  return inverse ? ntt_row_kernel<0, true>
         : lazy  ? ntt_row_kernel<0, false, true>
                 : ntt_row_kernel<0, false>;
}

static int ntt_cluster(int n) { return n > NTT_ROW_MAX ? 2 : 1; }

// rows: (row, limb) rows = batch rows * k_sel. tw: the (k_ctx, n)
// pass-ordered table of the direction (NttTables.pass_twiddles); limb_p,
// ninv, ninv_s: (k_ctx,) per limb. lazy: a forward whose output words stay
// below 4p (refused with inverse). cluster, threads: kernels.ntt_plan(n).
extern "C" int tpufhe_ntt(const void* x, void* y, long long rows, int k_sel,
                          int n, const void* tw, const void* limb_p,
                          const void* ninv, const void* ninv_s, int limb0,
                          int inverse, int lazy, int cluster, int threads,
                          void* stream) {
  NttKernel kernel = ntt_instance(n, inverse, lazy, threads);
  if (!kernel || cluster != ntt_cluster(n)) return (int)cudaErrorInvalidValue;
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  const NttArgs a{(const u64*)x,      (u64*)y,
                  (const ulonglong2*)tw, (const u64*)limb_p,
                  (const u64*)ninv,   (const u64*)ninv_s,
                  k_sel,              n,
                  logn,               limb0};
  return pass_launch(kernel, a, rows * cluster, cluster, threads,
                     n / cluster * (int)sizeof(u64), stream);
}

// CTAs of the instance one SM holds, and clusters the card holds at once.
extern "C" int tpufhe_ntt_occupancy(int n, int inverse, int threads,
                                    int* blocks_per_sm, int* clusters) {
  NttKernel kernel = ntt_instance(n, inverse, 0, threads);
  if (!kernel) return (int)cudaErrorInvalidValue;
  const int cluster = ntt_cluster(n);
  return pass_occupancy(kernel, cluster, threads,
                        n / cluster * (int)sizeof(u64), blocks_per_sm,
                        clusters);
}
