// The ciphertext x plaintext dot product with deferred 128-bit accumulation:
//   r[part, j, b, r, c] = sum_{i < n} db[i, j, r, c] e_part[i, b, r, c]
//                         mod p_(r mod k),  canonical,
// over NTT-domain residues (fhe.rs rq/ops.rs:448-550 and
// bfv/ops/dot_product.rs:56-152): each product is a full 64 x 64 -> 128-bit
// product, the products are summed in 128 bits, and the sum is reduced once
// per window of `win` terms (Barrett, modarith.cuh reduce_u128), the residue
// carried into the next window.
//
// Replaces no Pallas kernel: tpufhe forms these sums in XLA, in
// make_ct_pt_dot (tpufhe/pipeline.py:1091-1162, the first dimension of a PIR
// response and the dot-product bench) and in rq.dot_product
// (tpufhe/ops/rq.py:1337-1368, behind dot_product_scalar), both on uint32
// (lo, hi) lanes with explicit carries.
//
// The window: a product of two canonical residues is below p^2 and the
// carried residue below p, so `win` products and the residue stay below
// 2^128 when win <= 2^(2 lz) - 2, lz the leading zeros of the largest
// modulus in its 64-bit word (14 for 62-bit moduli). The wrapper passes
// win = min_l 2^(2 lz(p_l)) - 2, tpufhe's window; the output is canonical,
// so any exact schedule gives tpufhe's integers.
//
// Layout: P parts (at most DOT_MAX_PARTS), each e_part (>= n, B, R, N)
// contiguous, of which rows 0 .. n - 1 are read; db (n, m, R, N); out
// (P, m, B, R, N). Row r of R belongs to limb r mod k (R = k for the
// ciphertext batches; R = S k when rq.dot_product folds a batch shape S into
// the rows). Words are int64 read as u64.
//
// Bound on this card: bytes. A term costs 8 bytes of db per column and 8 of
// each part against one 128-bit product (7 int32 multiplies) per part and
// column; at the dot bench's shape (n = 128, N = 8192, 4 limbs, m = B = 1,
// two parts) the bytes bound is about nine times the multiply bound, at
// PIR's first dimension (64 terms, 8 columns, 6 x 16384) about four times.
//
// Design. An item is one output word position (b, r, c) and a group of
// up to C columns. One thread serves every part of its item, so each db
// word is loaded once and used for all P parts, and each part's word once
// for all C columns: every input is read once per call when m <= C.
// Instances (dot_plan): <1, 1> (rq.dot_product), <2, 1> (the dot bench,
// dot_product_scalar of two-part ciphertexts), <2, DOT_COLS>
// (make_ct_pt_dot with m > 1, PIR's first dimension), and a general one of
// up to DOT_MAX_PARTS parts and DOT_GENERAL_COLS columns (any other shape;
// more columns take further groups, each reading the parts again). A CTA
// holds DOT_THREADS items.
//
// Bytes in flight: each thread keeps a ring of ST stages in shared memory,
// one term's P + C words a stage (ST = DOT_RING_WORDS / (P + C), at least
// 2): the copies of term i + ST - 1 are started (cp.async, one commit
// group a term) before term i is read from its stage, so ST - 1 terms are
// in flight while the thread forms term i's products, and no register
// holds a load in flight. Every copy and store is coalesced along c; each
// thread reads back only its own stages, so the ring needs no barrier.
// (Splitting the terms across a CTA's warps, and two adjacent coefficients
// a thread with 16-byte copies, gave the same times within the spread
// between runs once the ring kept the loads in flight:
// scripts/dot_designs.py, PERF.md.)
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "modarith.cuh"

#define DOT_MAX_PARTS 8
#define DOT_COLS 8
#define DOT_GENERAL_COLS 2
#define DOT_THREADS 128
#define DOT_RING_WORDS 16

struct DotArgs {
  const u64* e[DOT_MAX_PARTS];
  const u64* db;
  u64* out;
  long long plane;  // B R N words of one part and one column
  long long rn;     // R N words of one batch row
  long long items;  // column groups x plane
  int parts, n_terms, m, k, logn, win;
  const u64* limb_p;
  const u64* b_lo;
  const u64* b_hi;
};

// stages of a thread's ring for terms of `words` words
__host__ __device__ constexpr int dot_stages(int words) {
  return DOT_RING_WORDS / words < 2 ? 2 : DOT_RING_WORDS / words;
}

// P parts (GENERAL: at most P, a.parts of them) and C columns a thread
template <int P, int C, bool GENERAL>
__global__ void __launch_bounds__(DOT_THREADS)
    ct_pt_dot_kernel(const __grid_constant__ DotArgs a) {
  constexpr int W = P + C, ST = dot_stages(W);
  extern __shared__ u64 row[];
  const int parts = GENERAL ? a.parts : P;
  const long long w = (long long)blockIdx.x * DOT_THREADS + threadIdx.x;
  if (w >= a.items) return;
  const long long group = w / a.plane;
  const long long idx = w - group * a.plane;  // (b, r, c)
  const long long rc = idx % a.rn;            // (r, c)
  const int j0 = (int)group * C;
  const int cols = min(C, a.m - j0);
  const int limb = (int)((rc >> a.logn) % a.k);
  const Barrett br = {a.limb_p[limb], a.b_lo[limb], a.b_hi[limb]};

  // the thread's ring: word q of stage s at row[(s W + q) DOT_THREADS + tid]
  u64* ring = row + threadIdx.x;
  const long long dstride = (long long)a.m * a.rn;
  const u64* d = a.db + (long long)j0 * a.rn + rc;
  auto fetch = [&](int t, int s) {
    if (t < a.n_terms) {
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (p < parts)
          __pipeline_memcpy_async(ring + (s * W + p) * DOT_THREADS,
                                  a.e[p] + t * a.plane + idx, 8);
#pragma unroll
      for (int jj = 0; jj < C; ++jj)
        if (jj < cols)
          __pipeline_memcpy_async(ring + (s * W + P + jj) * DOT_THREADS,
                                  d + t * dstride + jj * a.rn, 8);
    }
    __pipeline_commit();
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) fetch(s, s);

  u64 lo[P][C], hi[P][C];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int jj = 0; jj < C; ++jj) lo[p][jj] = hi[p][jj] = 0;
  int left = a.win, s = 0;
  for (int i = 0; i < a.n_terms; ++i) {
    // term i + ST - 1 into the stage term i - 1 left, then term i's words
    fetch(i + ST - 1, s == 0 ? ST - 1 : s - 1);
    __pipeline_wait_prior(ST - 1);
    u64 x[P], y[C];
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (p < parts) x[p] = ring[(s * W + p) * DOT_THREADS];
#pragma unroll
    for (int jj = 0; jj < C; ++jj)
      if (jj < cols) y[jj] = ring[(s * W + P + jj) * DOT_THREADS];
    s = s == ST - 1 ? 0 : s + 1;
    if (left == 0) {
      // close the window: the canonical residue is the next one's start
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int jj = 0; jj < C; ++jj)
          if (p < parts && jj < cols) {
            lo[p][jj] = reduce_u128(lo[p][jj], hi[p][jj], br);
            hi[p][jj] = 0;
          }
      left = a.win;
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int jj = 0; jj < C; ++jj)
        if (p < parts && jj < cols) {
          const u64 pl = x[p] * y[jj];
          lo[p][jj] += pl;
          hi[p][jj] += mulhi64(x[p], y[jj]) + (lo[p][jj] < pl);
        }
    --left;
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int jj = 0; jj < C; ++jj)
      if (p < parts && jj < cols)
        a.out[((long long)p * a.m + j0 + jj) * a.plane + idx] =
            reduce_u128(lo[p][jj], hi[p][jj], br);
}

typedef void (*DotKernel)(DotArgs);

// The launch of one call: the instance (parts, columns a group), its
// ring's stages, the grid and the shared bytes.
struct DotPlan {
  DotKernel kernel;
  int parts, cols, stages, general, smem;
  long long items, grid;
};

template <int P, int C, bool GENERAL>
static DotPlan dot_instance() {
  DotPlan pl = {};
  pl.kernel = ct_pt_dot_kernel<P, C, GENERAL>;
  pl.parts = P;
  pl.cols = C;
  pl.stages = dot_stages(P + C);
  pl.general = GENERAL;
  pl.smem = 8 * DOT_THREADS * pl.stages * (P + C);
  // above 48 KB a CTA's shared memory needs the kernel's consent, once
  static const cudaError_t allowed = cudaFuncSetAttribute(
      pl.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  (void)allowed;
  return pl;
}

static DotPlan dot_plan(int parts, int m, long long plane) {
  DotPlan pl = parts == 1 && m == 1   ? dot_instance<1, 1, false>()
               : parts == 2 && m == 1 ? dot_instance<2, 1, false>()
               : parts == 2 ? dot_instance<2, DOT_COLS, false>()
                            : dot_instance<DOT_MAX_PARTS, DOT_GENERAL_COLS,
                                           true>();
  pl.items = (long long)((m + pl.cols - 1) / pl.cols) * plane;
  pl.grid = (pl.items + DOT_THREADS - 1) / DOT_THREADS;
  return pl;
}

// e: `parts` pointers, each (>= n_terms, B, R, n) words; db (n_terms, m, R,
// n); out (parts, m, B, R, n). plane = B R n, rn = R n; limb_p, b_lo, b_hi:
// (k,) per limb, row r of R taking limb r mod k; win: terms a window.
extern "C" int tpufhe_ct_pt_dot(const void* const* e, int parts,
                                const void* db, void* out, long long plane,
                                long long rn, int n_terms, int m, int k,
                                int n, int win, const void* limb_p,
                                const void* b_lo, const void* b_hi,
                                void* stream) {
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  if ((1 << logn) != n || parts < 1 || parts > DOT_MAX_PARTS || k < 1 ||
      m < 1 || n_terms < 1 || win < 1 || plane < 1 || rn % n || plane % rn)
    return (int)cudaErrorInvalidValue;
  const DotPlan pl = dot_plan(parts, m, plane);
  DotArgs a;
  for (int p = 0; p < DOT_MAX_PARTS; ++p)
    a.e[p] = p < parts ? (const u64*)e[p] : nullptr;
  a.db = (const u64*)db;
  a.out = (u64*)out;
  a.plane = plane;
  a.rn = rn;
  a.items = pl.items;
  a.parts = parts;
  a.n_terms = n_terms;
  a.m = m;
  a.k = k;
  a.logn = logn;
  a.win = win;
  a.limb_p = (const u64*)limb_p;
  a.b_lo = (const u64*)b_lo;
  a.b_hi = (const u64*)b_hi;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)pl.grid);
  cfg.blockDim = dim3(DOT_THREADS);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, pl.kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch plan of a call of `parts` parts and m columns over `plane`
// words a part and column: out[0..6] = parts and columns of the instance,
// its ring's stages, threads a CTA, CTAs, shared bytes a CTA, whether the
// instance is the general one.
extern "C" int tpufhe_ct_pt_dot_plan(int parts, int m, long long plane,
                                     long long* out) {
  if (parts < 1 || parts > DOT_MAX_PARTS || m < 1 || plane < 1)
    return (int)cudaErrorInvalidValue;
  const DotPlan pl = dot_plan(parts, m, plane);
  const long long v[7] = {pl.parts, pl.cols, pl.stages, DOT_THREADS,
                          pl.grid,  pl.smem, pl.general};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// CTAs of that call's instance one SM holds (the launch plan's residency).
extern "C" int tpufhe_ct_pt_dot_occupancy(int parts, int m, long long plane,
                                          int* blocks_per_sm) {
  if (parts < 1 || parts > DOT_MAX_PARTS || m < 1 || plane < 1)
    return (int)cudaErrorInvalidValue;
  const DotPlan pl = dot_plan(parts, m, plane);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, pl.kernel, DOT_THREADS, pl.smem);
}
