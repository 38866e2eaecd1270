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
// Design: one thread per output word of one part and all m columns,
// (part, b, r, c), DOT_THREADS threads a block along c, so every load of
// e and db and every store is coalesced. The thread keeps DOT_COLS (lo, hi) accumulators in registers
// and walks i once per group of DOT_COLS columns: e is read ceil(m /
// DOT_COLS) times, db once.
//
// Bound on this card: bytes. A term costs 16 bytes of input per column
// against one 128-bit product (7 int32 multiplies); at the dot bench's shape
// (n = 128, N = 8192, 4 limbs, m = B = 1) the bytes bound is about nine
// times the multiply bound.
#include <cuda_runtime.h>

#include "modarith.cuh"

#define DOT_MAX_PARTS 8
#define DOT_COLS 8
#define DOT_THREADS 128

struct DotArgs {
  const u64* e[DOT_MAX_PARTS];
  const u64* db;
  u64* out;
  long long plane;  // B R N words of one part and one column
  long long rn;     // R N words of one batch row
  int parts, n_terms, m, k, logn, win;
  const u64* limb_p;
  const u64* b_lo;
  const u64* b_hi;
};

__global__ void __launch_bounds__(DOT_THREADS)
    ct_pt_dot_kernel(const __grid_constant__ DotArgs a) {
  const long long g = (long long)blockIdx.x * DOT_THREADS + threadIdx.x;
  if (g >= a.parts * a.plane) return;
  const int part = (int)(g / a.plane);
  const long long idx = g - part * a.plane;  // (b, r, c)
  const long long rc = idx % a.rn;           // (r, c)
  const int limb = (int)((rc >> a.logn) % a.k);
  const Barrett br = {a.limb_p[limb], a.b_lo[limb], a.b_hi[limb]};
  const u64* e = a.e[part] + idx;
  u64* out = a.out + (long long)part * a.m * a.plane + idx;
  for (int j0 = 0; j0 < a.m; j0 += DOT_COLS) {
    const int cols = min(DOT_COLS, a.m - j0);
    u64 lo[DOT_COLS], hi[DOT_COLS];
#pragma unroll
    for (int jj = 0; jj < DOT_COLS; ++jj) lo[jj] = hi[jj] = 0;
    int left = a.win;
    for (int i = 0; i < a.n_terms; ++i) {
      if (left == 0) {
        // close the window: the canonical residue is the next one's start
#pragma unroll
        for (int jj = 0; jj < DOT_COLS; ++jj) {
          if (jj < cols) {
            lo[jj] = reduce_u128(lo[jj], hi[jj], br);
            hi[jj] = 0;
          }
        }
        left = a.win;
      }
      const u64 x = e[i * a.plane];
      const u64* d = a.db + ((long long)i * a.m + j0) * a.rn + rc;
#pragma unroll
      for (int jj = 0; jj < DOT_COLS; ++jj) {
        if (jj < cols) {
          const u64 y = d[jj * a.rn];
          const u64 pl = x * y;
          lo[jj] += pl;
          hi[jj] += mulhi64(x, y) + (lo[jj] < pl);
        }
      }
      --left;
    }
#pragma unroll
    for (int jj = 0; jj < DOT_COLS; ++jj)
      if (jj < cols) out[(long long)(j0 + jj) * a.plane] =
          reduce_u128(lo[jj], hi[jj], br);
  }
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
  DotArgs a;
  for (int p = 0; p < DOT_MAX_PARTS; ++p)
    a.e[p] = p < parts ? (const u64*)e[p] : nullptr;
  a.db = (const u64*)db;
  a.out = (u64*)out;
  a.plane = plane;
  a.rn = rn;
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
  cfg.gridDim =
      dim3((unsigned)((parts * plane + DOT_THREADS - 1) / DOT_THREADS));
  cfg.blockDim = dim3(DOT_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, ct_pt_dot_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// CTAs of the kernel one SM holds (the launch plan's residency).
extern "C" int tpufhe_ct_pt_dot_occupancy(int* blocks_per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ct_pt_dot_kernel, DOT_THREADS, 0);
}
