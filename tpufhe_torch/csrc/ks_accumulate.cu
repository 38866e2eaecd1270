// The key-switch accumulate and the adds of the unfused tail:
//   out0 = add0 + sum_i d_i ksk0_i,  out1 = add1 + sum_i d_i ksk1_i  (mod p_j)
// on NTT-domain rows (fhe.rs key_switching_key.rs:227-239), where d_i is
// the forward NTT of the i-th decomposition row: the k Garner digit rows
// (ks_accumulate_kernel), or the base-2^log_base digits of a
// single-modulus key (k == 1, key_switching_key.rs:172-211;
// ks_digits_kernel). The programs run it where the fused tails (K4, K5)
// do not fit in shared memory or cannot take the key, after one K1 forward
// NTT of the stacked rows.
//
// Replaces tpufhe's XLA accumulate of its unfused tail
// (tpufhe/pipeline.py:564-569 _ksk_accumulate and the adds, and
// _key_switch_batched at :394-408 for the rotation), which tpufhe runs
// where tail_kernel_fits is false and on every narrow context; it is not
// a Pallas kernel.
//
// Data: d (digits, rows, k, n) canonical, as K1 (or K9) returns them;
// ksk0, ksk0_shoup, ksk1, ksk1_shoup (digits, k, n) with [i][j] =
// decomposition row i, limb j; add0 and add1 (rows, k, n) or null (no add);
// out (2, rows, k, n), canonical. Words are int64 read as u64, or the int32
// words of a narrow (w30) context read as u32, with its 2^32-scaled Shoup
// constants (the same template on modarith.cuh's 32-bit overloads). One
// thread per (row, limb j, coefficient); the sums stay in registers.
//
// Bound on this card: bytes. Per output word it reads `digits` words of
// digits and one or two of addends and writes two; the key (4 digits k n
// words) is shared by every row and stays in L2. Its 2 digits Shoup
// products per word are far below the memory bound, so loads and stores
// are coalesced along n and nothing else is done.
#include <cuda_runtime.h>

#include "modarith.cuh"

// The body of both kernels: `digits` decomposition rows, `k` limbs.
template <typename W>
__device__ __forceinline__ void accumulate(
    const W* __restrict__ d, const W* __restrict__ add0,
    const W* __restrict__ add1, W* __restrict__ out, long long plane,
    int digits, int k, int logn, const W* __restrict__ k0,
    const W* __restrict__ k0s, const W* __restrict__ k1,
    const W* __restrict__ k1s, const W* __restrict__ limb_p) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  const long long rj = idx >> logn;  // row * k + j
  const int j = (int)(rj % k);
  const long long e = idx - (rj << logn);
  const W p = limb_p[j];
  W acc0 = 0, acc1 = 0;
  for (int i = 0; i < digits; ++i) {
    const W x = d[i * plane + idx];
    const long long ko = (((long long)i * k + j) << logn) + e;
    acc0 = add_mod(acc0, mul_shoup(x, k0[ko], k0s[ko], p), p);
    acc1 = add_mod(acc1, mul_shoup(x, k1[ko], k1s[ko], p), p);
  }
  if (add0) acc0 = add_mod(add0[idx], acc0, p);
  if (add1) acc1 = add_mod(add1[idx], acc1, p);
  out[idx] = acc0;
  out[plane + idx] = acc1;
}

// Garner rows: as many as limbs (the loop bound is k itself).
template <typename W>
__global__ void ks_accumulate_kernel(const W* __restrict__ d,
                                     const W* __restrict__ add0,
                                     const W* __restrict__ add1,
                                     W* __restrict__ out, long long plane,
                                     int k, int logn,
                                     const W* __restrict__ k0,
                                     const W* __restrict__ k0s,
                                     const W* __restrict__ k1,
                                     const W* __restrict__ k1s,
                                     const W* __restrict__ limb_p) {
  accumulate<W>(d, add0, add1, out, plane, k, k, logn, k0, k0s, k1, k1s,
                limb_p);
}

// Any other number of rows: a single-modulus key's digits.
template <typename W>
__global__ void ks_digits_kernel(const W* __restrict__ d,
                                 const W* __restrict__ add0,
                                 const W* __restrict__ add1,
                                 W* __restrict__ out, long long plane,
                                 int digits, int k, int logn,
                                 const W* __restrict__ k0,
                                 const W* __restrict__ k0s,
                                 const W* __restrict__ k1,
                                 const W* __restrict__ k1s,
                                 const W* __restrict__ limb_p) {
  accumulate<W>(d, add0, add1, out, plane, digits, k, logn, k0, k0s, k1,
                k1s, limb_p);
}

template <typename W>
static cudaError_t launch(const void* d, const void* add0, const void* add1,
                          void* out, long long plane, int digits, int k,
                          int logn, const void* k0, const void* k0s,
                          const void* k1, const void* k1s,
                          const void* limb_p, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((plane + threads - 1) / threads);
  if (digits == k)
    ks_accumulate_kernel<W><<<blocks, threads, 0, stream>>>(
        (const W*)d, (const W*)add0, (const W*)add1, (W*)out, plane, k, logn,
        (const W*)k0, (const W*)k0s, (const W*)k1, (const W*)k1s,
        (const W*)limb_p);
  else
    ks_digits_kernel<W><<<blocks, threads, 0, stream>>>(
        (const W*)d, (const W*)add0, (const W*)add1, (W*)out, plane, digits,
        k, logn, (const W*)k0, (const W*)k0s, (const W*)k1, (const W*)k1s,
        (const W*)limb_p);
  return cudaGetLastError();
}

// plane = rows * k * n words per output part; digits: decomposition rows
// of d and the key; add0 / add1 may be null;
// word_bytes = 8 for int64 words, 4 for the int32 words of narrow contexts.
extern "C" int tpufhe_ks_accumulate(const void* d, const void* add0,
                                    const void* add1, void* out,
                                    long long plane, int digits, int k,
                                    int n, const void* k0, const void* k0s,
                                    const void* k1, const void* k1s,
                                    const void* limb_p, int word_bytes,
                                    void* stream) {
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  if ((1 << logn) != n || k < 1 || digits < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (word_bytes == 8)
    return (int)launch<u64>(d, add0, add1, out, plane, digits, k, logn, k0,
                            k0s, k1, k1s, limb_p, s);
  if (word_bytes == 4)
    return (int)launch<u32>(d, add0, add1, out, plane, digits, k, logn, k0,
                            k0s, k1, k1s, limb_p, s);
  return (int)cudaErrorInvalidValue;
}
