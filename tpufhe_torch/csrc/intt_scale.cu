// K8: the inverse NTT of every limb of a row fused with the HPS base
// conversion and scaling: rns_scale(ntt_backward(x)) in one launch, the
// extend step of a multiplication.
//
// Replaces tpufhe/ops/pallas/intt_scale_kernel.py:_intt_scale_kernel
// (wrapper intt_scale_pallas), which inverse-transforms a batch tile of
// rows with the four-step int8 matmul NTT and feeds the byte planes of the
// result to the digit-plane scaler, with all limbs' constants resident in
// VMEM.
//
// Data: x (rows, k_in, n) NTT-domain canonical residues of the `from`
// basis; out (rows, size, n) power-basis residues of the `to` basis, rows
// start .. start + size - 1. The power-basis residues never reach device
// memory.
//
// Bound on this card: per coefficient it reads 8 k_in bytes and writes
// 8 size bytes; it runs k_in inverse transforms (3 log2(n) / 2 + 3 64-bit
// products per element) and the scaler's products, so at n = 8192 the
// integer-multiply bound is the larger. The design that held a row's k_in
// limbs in one block (192 KB for 3 limbs at n = 8192) ran one 512-thread
// block an SM, a radix-2 stage per barrier for all limbs in lockstep, and
// then the scaler on the same threads: 2.1x slower than the split K1
// inverse + K2 launches it fuses.
//
// Design: a thread-block cluster per batch row, the limbs inverse-
// transformed on the passes of ntt_pass_device.cuh (K1's inverse: the
// first pass reads device memory; the last folds n^{-1} and leaves the
// words canonical in the CTA's shared memory, at their slots), then each
// coefficient's k_in residues read from shared memory (the cluster's,
// through distributed shared memory) into registers for the scaler body of
// rns_scale_device.cuh, whose `size` outputs are written coalesced along
// the coefficient. Two forms (kernels.intt_scale_plan):
// - the fixed shape, k_in = 3 limbs of n = 8192 (the programs' fused
//   extends): a cluster of two 96 KB CTAs, CTA h holding half h of every
//   limb, so two CTAs share an SM and the card holds 132 clusters at once
//   (256 rows in two waves, 128 in one). Each CTA runs the local stages of
//   its three halves (split_inverse_row's); after cluster.sync() the pair
//   finishes each limb's last two stages, each group of words i, i + n/4
//   of both halves taken by one thread of the pair, which writes them back
//   canonical to the same slots; after a second cluster.sync() CTA h
//   scales the coefficients of its half from its own shared memory. The
//   residues sit in registers (rns_scale_fixed, as K2's fixed instances)
//   and the scaler's table in the launch's parameter space. One-limb CTAs
//   (three an SM) fit only 124 clusters of three at once, so 256 rows took
//   three waves.
// - any other shape: CTA r of C = min(k_in, K8_CLUSTER_MAX) holds the
//   limbs r, r + C, ... and scales its share of the coefficients
//   (kernels.coefficient_shares(n, C)) from the cluster's shared memory
//   with the chunked scaler body (rns_scale_chunked_get, the table in
//   device memory), and a last cluster.sync() keeps each limb alive until
//   its partners have read it.
#include <cstring>

#include "ntt_pass_device.cuh"
#include "rns_scale_device.cuh"

// One-limb CTAs: their threads (at most; n / 4 below n = 1024;
// kernels.K8_THREADS), the CTAs an SM must hold (three 64 KB limbs), the
// most CTAs of a cluster (kernels.K8_CLUSTER_MAX; the portable size). The
// fixed shape's pair: K8_SPLIT_THREADS threads (kernels.K8_SPLIT_THREADS),
// two CTAs an SM.
#define K8_THREADS 256
#define K8_MIN_BLOCKS 3
#define K8_CLUSTER_MAX 8
#define K8_SPLIT_THREADS 512
#define K8_SPLIT_MIN_BLOCKS 2
// The fixed shape: k_in and log2(n).
#define K8_FIXED_K_IN 3
#define K8_FIXED_LOGN 13
// The table words the pair takes in the parameter space.
#define K8_PARAM_WORDS 464

struct InttScaleArgs {
  const u64* x;
  u64* y;
  const ulonglong2* tz;  // (k_in, n) pass-ordered inverse (zeta, Shoup) pairs
  const u64 *limb_p, *ninv, *ninv_s;  // (k_in,)
  const u64* tab;  // the scaler's table in device memory
  int k_in, n, logn, size, shift, is_one, theta_gamma_sign;
  u64 ptab[K8_PARAM_WORDS];  // the pair: the table's words
};

typedef void (*InttScaleKernel)(InttScaleArgs);

// Any shape intt_scale_fits admits: a cluster of one-limb CTAs per batch
// row, CTA r holding the limbs r, r + C, ...
__global__ void __launch_bounds__(K8_THREADS, K8_MIN_BLOCKS)
    intt_scale_kernel(const __grid_constant__ InttScaleArgs a) {
  namespace cg = cooperative_groups;
  extern __shared__ u64 row[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int k_in = a.k_in, n = a.n;
  const long long brow = blockIdx.x / C;
  const u64* src = a.x + brow * k_in * n;
  for (int i = rank, c = 0; i < k_in; i += C, ++c)
    inverse_row<0, 0, PASS_STAGES, true>(
        row + (long long)c * n, src + (long long)i * n, nullptr, a.logn,
        a.tz + (long long)i * n, a.limb_p[i], a.ninv[i], a.ninv_s[i]);
  cluster.sync();
  // this CTA's share of the coefficients, in whole 32-word pieces
  const int span = ((n + C - 1) / C + 31) & ~31;
  const int lo = rank * span;
  const int hi = min(n, lo + span);
  u64* dst = a.y + brow * a.size * n;
  for (int e = lo + threadIdx.x; e < hi; e += blockDim.x) {
    const int s = pass_slot(e);
    // limb i lies in CTA i mod C, at its row i / C
    auto get = [&](int i) {
      return cluster.map_shared_rank(row, i % C)[(i / C) * n + s];
    };
    rns_scale_chunked_get<K2_CHUNK>(get, k_in, a.tab, a.size, a.shift,
                                    a.is_one, a.theta_gamma_sign, dst + e,
                                    (long long)n);
  }
  cluster.sync();
}

// The fixed shape's pair of half-row CTAs. PTAB: the scaler's table in the
// parameter space, else in device memory.
template <bool PTAB>
__global__ void __launch_bounds__(K8_SPLIT_THREADS, K8_SPLIT_MIN_BLOCKS)
    intt_scale_split_kernel(const __grid_constant__ InttScaleArgs a) {
  namespace cg = cooperative_groups;
  extern __shared__ u64 row[];
  constexpr int K_IN = K8_FIXED_K_IN, LOGN = K8_FIXED_LOGN;
  constexpr int n = 1 << LOGN, logh = LOGN - 1, half = n / 2;
  constexpr int quarter = n / 4, THREADS = K8_SPLIT_THREADS;
  cg::cluster_group cluster = cg::this_cluster();
  const int h = (int)cluster.block_rank();
  const long long brow = blockIdx.x >> 1;
  // the local stages of half h of each limb, limb j at row + j n / 2
#pragma unroll 1
  for (int j = 0; j < K_IN; ++j) {
    const u64 p = a.limb_p[j];
    split_inverse_half<THREADS>(
        row + j * half, a.x + (brow * K_IN + j) * n + h * half, logh,
        a.tz + (long long)j * n + 3 + h * (half - 2), p, 0 - p);
  }
  cluster.sync();
  // each limb's last two stages (n - 2 within the halves, n - 1 across
  // them) on this CTA's half of the word groups i, i + n/4, written back
  // folded and canonical to the same slots
  {
    u64* h0 = cluster.map_shared_rank(row, 0);
    u64* h1 = cluster.map_shared_rank(row, 1);
#pragma unroll 1
    for (int j = 0; j < K_IN; ++j) {
      const u64 p = a.limb_p[j], np = 0 - p, p2 = 2 * p;
      const ulonglong2* tz = a.tz + (long long)j * n;
      const ulonglong2 z0 = __ldg(tz), z1 = __ldg(tz + 1), z2 = __ldg(tz + 2);
      const u64 f = a.ninv[j], fs = a.ninv_s[j];
      u64* x = h0 + j * half;
      u64* y = h1 + j * half;
      for (int i = h * (quarter / 2) + threadIdx.x;
           i < (h + 1) * (quarter / 2); i += THREADS) {
        const int s_lo = pass_slot(i), s_hi = pass_slot(i + quarter);
        u64 x0 = x[s_lo], x1 = x[s_hi], y0 = y[s_lo], y1 = y[s_hi];
        split_inner_stage(x0, x1, y0, y1, z0, z1, p2, np);
        x[s_lo] = mul_shoup(x0 + y0, f, fs, p);
        x[s_hi] = mul_shoup(x1 + y1, f, fs, p);
        y[s_lo] = mul_shoup(shoup_np(x0 + p2 - y0, z2.x, z2.y, np), f, fs, p);
        y[s_hi] = mul_shoup(shoup_np(x1 + p2 - y1, z2.x, z2.y, np), f, fs, p);
      }
    }
  }
  cluster.sync();
  // the coefficients of half h, from this CTA's own shared memory
  const u64* tab = PTAB ? a.ptab : a.tab;
  u64* dst = a.y + brow * a.size * n + h * half;
  for (int l = threadIdx.x; l < half; l += THREADS) {
    const int s = pass_slot(l);
    u64 r[K_IN];
#pragma unroll
    for (int i = 0; i < K_IN; ++i) r[i] = row[i * half + s];
    rns_scale_fixed<K_IN>(r, tab, a.size, a.shift, a.is_one,
                          a.theta_gamma_sign, dst + l, (long long)n);
  }
}

// Whether k_in limbs of degree n run the pair (kernels.intt_scale_split).
static bool intt_scale_pair(int k_in, int n) {
  return k_in == K8_FIXED_K_IN && n == 1 << K8_FIXED_LOGN;
}

// The instance for k_in limbs of degree n at `threads` threads a CTA, with
// a table of `words` words.
static InttScaleKernel intt_scale_instance(int k_in, int n, int threads,
                                           int words) {
  if (!intt_scale_pair(k_in, n)) return intt_scale_kernel;
  if (threads != K8_SPLIT_THREADS) return nullptr;
  return words <= K8_PARAM_WORDS ? intt_scale_split_kernel<true>
                                 : intt_scale_split_kernel<false>;
}

// The cluster's CTAs and the shared bytes of a CTA (kernels.intt_scale_plan).
static void intt_scale_cluster(int k_in, int n, int* cluster, int* smem) {
  if (intt_scale_pair(k_in, n)) {
    *cluster = 2;
    *smem = k_in * (n / 2) * (int)sizeof(u64);
    return;
  }
  *cluster = k_in < K8_CLUSTER_MAX ? k_in : K8_CLUSTER_MAX;
  *smem = (k_in + *cluster - 1) / *cluster * n * (int)sizeof(u64);
}

// rows: batch rows (one cluster each). tz: the `from` context's
// pass-ordered inverse table (NttTables.pass_twiddles(True), whole rows);
// limb_p, ninv, ninv_s: its (k_in,) scalars; tab_dev and tab_host: the
// scaler's table for the outputs start .. start + size - 1 (`words` words,
// layout in rns_scale_device.cuh), on the card and on the host. cluster,
// threads: kernels.intt_scale_plan(k_in, n).
extern "C" int tpufhe_intt_scale(const void* x, void* y, long long rows,
                                 int k_in, int n, const void* tz,
                                 const void* limb_p, const void* ninv,
                                 const void* ninv_s, const void* tab_dev,
                                 const void* tab_host, int words, int size,
                                 int shift, int is_one, int theta_gamma_sign,
                                 int cluster, int threads, void* stream) {
  int want_cluster, smem;
  intt_scale_cluster(k_in, n, &want_cluster, &smem);
  if (k_in < 1 || n < 8 || words != k2_table_words(k_in, size) ||
      cluster != want_cluster)
    return (int)cudaErrorInvalidValue;
  InttScaleKernel kernel = intt_scale_instance(k_in, n, threads, words);
  if (!kernel) return (int)cudaErrorInvalidValue;
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  InttScaleArgs a{};
  a.x = (const u64*)x;
  a.y = (u64*)y;
  a.tz = (const ulonglong2*)tz;
  a.limb_p = (const u64*)limb_p;
  a.ninv = (const u64*)ninv;
  a.ninv_s = (const u64*)ninv_s;
  a.tab = (const u64*)tab_dev;
  a.k_in = k_in;
  a.n = n;
  a.logn = logn;
  a.size = size;
  a.shift = shift;
  a.is_one = is_one;
  a.theta_gamma_sign = theta_gamma_sign;
  if (words <= K8_PARAM_WORDS)
    memcpy(a.ptab, tab_host, (size_t)words * sizeof(u64));
  return pass_launch(kernel, a, rows * cluster, cluster, threads, smem,
                     stream);
}

// CTAs of the instance for k_in limbs of degree n one SM holds, and
// clusters the card holds at once.
extern "C" int tpufhe_intt_scale_occupancy(int k_in, int n, int threads,
                                           int* blocks_per_sm,
                                           int* clusters) {
  int cluster, smem;
  intt_scale_cluster(k_in, n, &cluster, &smem);
  InttScaleKernel kernel = intt_scale_instance(k_in, n, threads, 0);
  if (!kernel) return (int)cudaErrorInvalidValue;
  return pass_occupancy(kernel, cluster, threads, smem, blocks_per_sm,
                        clusters);
}
