// K2: HPS RNS base conversion with rational scaling (fhe.rs
// rns/scaler.rs:249-352), one thread per (row, coefficient).
//
// Replaces tpufhe/ops/pallas/rns_kernel.py:_scale_kernel_bc (core
// _scale_core_bc; _scale_kernel under TPUFHE_BC_SCALER=0), which forms the
// three per-coefficient inner products as int8 digit-plane matmuls for the
// TPU's matrix unit. Here each thread runs the exact integer body of
// rns_scale_device.cuh (shared with the fused inverse NTT + scale, K8) on
// its coefficient's residues. The same kernel serves tpufhe's XLA narrow
// scaler (tpufhe/ops/rns.py, the `narrow` branch of scale): instantiated
// for 32-bit words it loads and stores the int32 rows of narrow (w30)
// contexts, with the same 64-bit arithmetic in registers.
//
// Data: x (rows, k_in, n), out (rows, size, n), int64 words read as u64
// (or int32 words read as u32). Loads and stores are coalesced along n.
//
// Bound on this card: integer multiplies. Per coefficient it reads 8 k_in
// bytes and writes 8 size bytes (4 each for 32-bit words) against about
// 4 k_in + size (k_in + 10) 64-bit products (twice the sums' part when the
// factor is not one), so the rate at which the multiplies, and the adds
// and compares around them, are dispatched is the limit. The design cuts
// those:
//   - k_in is a template parameter of the fixed instances, so the
//     residues sit in exactly k_in registers and every loop over them
//     unrolls without guards (fewer registers, more warps per SM);
//   - the table rides in the launch's parameter space (__grid_constant__),
//     so every thread reads the same constant through the constant cache
//     and the multiplies take it as a uniform operand, with no loads;
//   - the v sum is 192 bits and each output's sum is plain 128-bit
//     products with one reduction, fewer multiplies than one Shoup
//     product per input limb and output.
// Fixed instances exist for the k_in that the programs produce on the
// parameter sets they run (K2_WIDE_K_IN, K2_NARROW_K_IN). Any other k_in,
// or a table larger than the parameter space takes, runs the general
// instance: residues in chunks of K2_CHUNK, the table copied into shared
// memory once per block.
#include <cuda_runtime.h>

#include <cstring>

#include "rns_scale_device.cuh"

#define K2_THREADS 256
// The table words a fixed instance takes in its parameter space (the
// launch's parameters must stay below 4 KB).
#define K2_PARAM_WORDS 472

// k_in of the fixed instances on int64 rows: 3 and 7 (3 x 62-bit: the
// extend and the decryption, the down-scale), 4 and 5 (the strategy-2
// down-scales with 1 and 2 extension primes; the 4 x 62-bit decryption), 6
// and 13 (N = 16384, 6 x 62-bit), 8 (8 x 62-bit: the extend and the
// decryption; its 17-limb down-scale runs the general instance).
#define K2_WIDE_K_IN(X) X(3) X(4) X(5) X(6) X(7) X(8) X(13)
// ... and on the int32 rows of narrow contexts: 7 and 16 (7 x 30-bit), 8
// (8 x 30-bit: the extend and the decryption; its down-scale has 18 limbs).
#define K2_NARROW_K_IN(X) X(7) X(8) X(16)

struct ScaleTable {
  u64 w[K2_PARAM_WORDS];
};

template <int K_IN, typename W>
__global__ void __launch_bounds__(K2_THREADS) rns_scale_fixed_kernel(
    const W* __restrict__ x, W* __restrict__ y, long long total, int logn,
    int size, int shift, int is_one, int theta_gamma_sign,
    const __grid_constant__ ScaleTable tab) {
  const long long idx = (long long)blockIdx.x * K2_THREADS + threadIdx.x;
  if (idx >= total) return;
  const long long row = idx >> logn;
  const long long c = idx - (row << logn);
  const W* src = x + ((row * K_IN) << logn) + c;
  u64 r[K_IN];
#pragma unroll
  for (int i = 0; i < K_IN; ++i) r[i] = src[(long long)i << logn];
  rns_scale_fixed<K_IN>(r, tab.w, size, shift, is_one, theta_gamma_sign,
                        y + ((row * size) << logn) + c, 1LL << logn);
}

template <int K_IN, typename W>
static cudaError_t launch_fixed(const void* x, void* y, long long total,
                                int logn, int size, int shift, int is_one,
                                int theta_gamma_sign, const ScaleTable& tab,
                                cudaStream_t stream) {
  const long long blocks = (total + K2_THREADS - 1) / K2_THREADS;
  rns_scale_fixed_kernel<K_IN, W><<<(unsigned)blocks, K2_THREADS, 0, stream>>>((const W*)x, (W*)y, total, logn, size, shift, is_one, theta_gamma_sign, tab);
  return cudaGetLastError();
}

template <typename W>
__global__ void __launch_bounds__(K2_THREADS) rns_scale_general_kernel(
    const W* __restrict__ x, W* __restrict__ y, long long total, int logn,
    int k_in, const u64* __restrict__ tab, int words, int size, int shift,
    int is_one, int theta_gamma_sign) {
  extern __shared__ u64 stab[];
  for (int e = threadIdx.x; e < words; e += blockDim.x) stab[e] = tab[e];
  __syncthreads();
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long row = idx >> logn;
  const long long c = idx - (row << logn);
  rns_scale_chunked<K2_CHUNK>(x + ((row * k_in) << logn) + c, 1LL << logn,
                              k_in, stab, size, shift, is_one,
                              theta_gamma_sign,
                              y + ((row * size) << logn) + c, 1LL << logn);
}

template <typename W>
static cudaError_t launch_general(const void* x, void* y, long long total,
                                  int logn, int k_in, const u64* tab,
                                  int words, int size, int shift, int is_one,
                                  int theta_gamma_sign, cudaStream_t stream) {
  const size_t smem = (size_t)words * sizeof(u64);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const long long blocks = (total + K2_THREADS - 1) / K2_THREADS;
  rns_scale_general_kernel<W><<<(unsigned)blocks, K2_THREADS, smem, stream>>>((const W*)x, (W*)y, total, logn, k_in, tab, words, size, shift, is_one, theta_gamma_sign);
  return cudaGetLastError();
}

// total = rows * n coefficients, n a power of two; tab_dev and tab_host
// hold the same table (layout in rns_scale_device.cuh, `words` words for
// k_in inputs and `size` outputs), on the card and on the host;
// word_bytes = 8 for int64 rows, 4 for the int32 rows of narrow contexts.
extern "C" int tpufhe_rns_scale(const void* x, void* y, long long total,
                                int n, int k_in, const void* tab_dev,
                                const void* tab_host, int words, int size,
                                int shift, int is_one, int theta_gamma_sign,
                                int word_bytes, void* stream) {
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  if (k_in < 1 || (1 << logn) != n || words != k2_table_words(k_in, size))
    return (int)cudaErrorInvalidValue;
  if (word_bytes != 8 && word_bytes != 4) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool wide = word_bytes == 8;
  if (words <= K2_PARAM_WORDS) {
    ScaleTable tab;
    memcpy(tab.w, tab_host, (size_t)words * sizeof(u64));
#define K2_CASE(W, K)                                                      \
  case K:                                                                  \
    return (int)launch_fixed<K, W>(x, y, total, logn, size, shift, is_one, \
                                   theta_gamma_sign, tab, s);
#define K2_CASE_WIDE(K) K2_CASE(u64, K)
#define K2_CASE_NARROW(K) K2_CASE(u32, K)
    if (wide) {
      switch (k_in) {
        K2_WIDE_K_IN(K2_CASE_WIDE)
        default: break;
      }
    } else {
      switch (k_in) {
        K2_NARROW_K_IN(K2_CASE_NARROW)
        default: break;
      }
    }
#undef K2_CASE_NARROW
#undef K2_CASE_WIDE
#undef K2_CASE
  }
  if (wide)
    return (int)launch_general<u64>(x, y, total, logn, k_in,
                                    (const u64*)tab_dev, words, size, shift,
                                    is_one, theta_gamma_sign, s);
  return (int)launch_general<u32>(x, y, total, logn, k_in, (const u64*)tab_dev,
                                  words, size, shift, is_one,
                                  theta_gamma_sign, s);
}
