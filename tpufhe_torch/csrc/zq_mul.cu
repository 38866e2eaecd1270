// The glue's 62-bit modular products, one elementwise pass over the words:
//   Barrett: out = a b mod p for canonical a, b < p (modarith.cuh mul_mod,
//            with the modulus's floor(2^128 / p));
//   Shoup:   out = a b mod p for any a < 2^63 and b < p, given
//            b_shoup = floor(b 2^64 / p) (modarith.cuh mul_shoup).
// Both outputs are canonical, so every word equals that of the 31-bit digit
// chains of ops/zq.py (mul, mul_shoup), the kernel's plain versions.
//
// Replaces no Pallas kernel: it stands for tpufhe's XLA products
// tpufhe/ops/zq.py mul_mod and mul_shoup, which the glue around the kernels
// (the expansion's switch-down and fold, the product by a plaintext,
// encryption, key generation) calls.
//
// Operands. Words are int64 read as u64. a, b, b_shoup and the moduli (p
// with its Barrett constants lo and hi, three arrays of one layout) are
// each a strided view of the output's shape, stride 0 along a dimension the
// operand is broadcast over; out is contiguous. The host side drops
// dimensions of size 1 and merges neighbours that every operand walks as one
// (tpufhe_zq_mul), so a (rows, k, N) product by a (k, 1) column runs as
// three dimensions and a product by a (k, N) row as two or three.
//
// Bound on this card: bytes. A word costs 8 bytes of each streamed operand
// and 8 of output against one 64 x 64 -> 128-bit product and its reduction;
// a broadcast operand (a column of moduli, a monomial or plaintext row of
// (k, N) words) is read again by every row and stays in L2. Each thread
// takes ZQ_MUL_VEC adjacent words of a row, so a streamed operand with unit
// stride is read and out written in 16-byte vector accesses, wherever the
// row's length is even and such an operand starts each row on a 16-byte
// boundary; elsewhere one word a thread, with scalar accesses.
#include <cuda_runtime.h>

#include "modarith.cuh"

// Dimensions the kernel walks after the merge; the raw shape may have more.
#define ZQ_MUL_MAX_DIMS 6
#define ZQ_MUL_RAW_DIMS 16
#define ZQ_MUL_THREADS 256
#define ZQ_MUL_VEC 2
// the strided operands: a, b, b_shoup and the moduli (p, lo, hi)
#define ZQ_MUL_OPERANDS 4

struct ZqMulArgs {
  const u64* a;
  const u64* b;
  const u64* b_shoup;  // null in Barrett mode
  const u64* p;
  const u64* lo;  // null in Shoup mode
  const u64* hi;
  u64* out;
  long long stride[ZQ_MUL_OPERANDS][ZQ_MUL_MAX_DIMS];  // in words
  unsigned size[ZQ_MUL_MAX_DIMS];  // the innermost dimension last
  unsigned words;                  // the output's words
  int dims;
};

// The words at element offset o of an operand whose innermost stride is s:
// one 16-byte load where s is 1 (aligned by the host's choice of VEC), one
// word for both where it is 0 (broadcast along the row).
template <int VEC>
__device__ __forceinline__ void load(const u64* __restrict__ x, long long o,
                                     long long s, u64 (&v)[VEC]) {
  if (VEC == 2 && s == 1) {
    const ulonglong2 w = *(const ulonglong2*)(x + o);
    v[0] = w.x;
    v[VEC - 1] = w.y;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = x[o + i * s];
  }
}

template <bool SHOUP, int VEC>
__global__ void __launch_bounds__(ZQ_MUL_THREADS)
    zq_mul_kernel(const __grid_constant__ ZqMulArgs g) {
  const unsigned e = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (e >= g.words) return;
  long long off[ZQ_MUL_OPERANDS] = {0, 0, 0, 0};
  unsigned rest = e;
#pragma unroll
  for (int d = ZQ_MUL_MAX_DIMS - 1; d >= 0; --d) {
    if (d < g.dims) {
      const unsigned i = d ? rest % g.size[d] : rest;
      rest = d ? rest / g.size[d] : 0;
#pragma unroll
      for (int o = 0; o < ZQ_MUL_OPERANDS; ++o)
        off[o] += (long long)i * g.stride[o][d];
    }
  }
  const int in = g.dims - 1;
  u64 a[VEC], b[VEC], bs[VEC], p[VEC], lo[VEC], hi[VEC], r[VEC];
  load<VEC>(g.a, off[0], g.stride[0][in], a);
  load<VEC>(g.b, off[1], g.stride[1][in], b);
  load<VEC>(g.p, off[3], g.stride[3][in], p);
  if (SHOUP) {
    load<VEC>(g.b_shoup, off[2], g.stride[2][in], bs);
#pragma unroll
    for (int i = 0; i < VEC; ++i) r[i] = mul_shoup(a[i], b[i], bs[i], p[i]);
  } else {
    load<VEC>(g.lo, off[3], g.stride[3][in], lo);
    load<VEC>(g.hi, off[3], g.stride[3][in], hi);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      r[i] = mul_mod(a[i], b[i], Barrett{p[i], lo[i], hi[i]});
  }
  if (VEC == 2) {
    ulonglong2 w;
    w.x = r[0];
    w.y = r[VEC - 1];
    *(ulonglong2*)(g.out + e) = w;
  } else {
    g.out[e] = r[0];
  }
}

// The merged walk of a raw shape: drops dimensions of size 1 and merges
// dimension d into d + 1 where every operand's stride along d is its
// stride along d + 1 times that dimension's size. Returns the number of
// dimensions, or -1 if more than ZQ_MUL_MAX_DIMS remain.
static int merge_dims(int raw, const long long* sizes,
                      const long long* strides, ZqMulArgs& g) {
  long long sz[ZQ_MUL_RAW_DIMS];
  long long st[ZQ_MUL_OPERANDS][ZQ_MUL_RAW_DIMS];
  int n = 0;
  for (int d = 0; d < raw; ++d) {
    if (sizes[d] == 1) continue;
    bool merge = n > 0;
    for (int o = 0; o < ZQ_MUL_OPERANDS && merge; ++o)
      merge = st[o][n - 1] == strides[o * raw + d] * sizes[d];
    if (merge) {
      sz[n - 1] *= sizes[d];
      for (int o = 0; o < ZQ_MUL_OPERANDS; ++o)
        st[o][n - 1] = strides[o * raw + d];
      continue;
    }
    sz[n] = sizes[d];
    for (int o = 0; o < ZQ_MUL_OPERANDS; ++o) st[o][n] = strides[o * raw + d];
    ++n;
  }
  if (n == 0) {  // a single word
    sz[0] = 1;
    for (int o = 0; o < ZQ_MUL_OPERANDS; ++o) st[o][0] = 0;
    n = 1;
  }
  if (n > ZQ_MUL_MAX_DIMS) return -1;
  for (int d = 0; d < n; ++d) {
    g.size[d] = (unsigned)sz[d];
    for (int o = 0; o < ZQ_MUL_OPERANDS; ++o) g.stride[o][d] = st[o][d];
  }
  for (int d = n; d < ZQ_MUL_MAX_DIMS; ++d) {
    g.size[d] = 1;
    for (int o = 0; o < ZQ_MUL_OPERANDS; ++o) g.stride[o][d] = 0;
  }
  return n;
}

// Whether a streamed operand with unit inner stride starts every row on a
// 16-byte boundary: its base aligned and each outer stride even.
static bool row_aligned(const void* x, const long long* stride, int dims) {
  if (x == nullptr || stride[dims - 1] != 1) return true;
  if ((unsigned long long)x % 16) return false;
  for (int d = 0; d < dims - 1; ++d)
    if (stride[d] % 2) return false;
  return true;
}

// Words a thread takes: ZQ_MUL_VEC where the rows have even length and
// every operand with unit inner stride (and out) starts each row on a
// 16-byte boundary, else 1.
static unsigned vector_width(const ZqMulArgs& g) {
  bool vec = g.size[g.dims - 1] % ZQ_MUL_VEC == 0 &&
             (unsigned long long)g.out % 16 == 0;
  const void* src[6] = {g.a, g.b, g.b_shoup, g.p, g.lo, g.hi};
  const int of[6] = {0, 1, 2, 3, 3, 3};
  for (int i = 0; i < 6 && vec; ++i)
    vec = row_aligned(src[i], g.stride[of[i]], g.dims);
  return vec ? ZQ_MUL_VEC : 1;
}

template <bool SHOUP>
static cudaError_t launch(const ZqMulArgs& g, cudaStream_t stream) {
  const unsigned vw = vector_width(g);
  const unsigned items = (g.words + vw - 1) / vw;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((items + ZQ_MUL_THREADS - 1) / ZQ_MUL_THREADS);
  cfg.blockDim = dim3(ZQ_MUL_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  return vw == ZQ_MUL_VEC
             ? cudaLaunchKernelEx(&cfg, zq_mul_kernel<SHOUP, ZQ_MUL_VEC>, g)
             : cudaLaunchKernelEx(&cfg, zq_mul_kernel<SHOUP, 1>, g);
}

// The operands' checks and the merged walk of tpufhe_zq_mul; 0 or an error.
static int prepare(int shoup, int dims, const long long* sizes,
                   const long long* strides, const void* a, const void* b,
                   const void* b_shoup, const void* p, const void* lo,
                   const void* hi, void* out, ZqMulArgs& g) {
  if (dims < 0 || dims > ZQ_MUL_RAW_DIMS || !a || !b || !p || !out ||
      (shoup ? !b_shoup : (!lo || !hi)))
    return (int)cudaErrorInvalidValue;
  long long words = 1;
  for (int d = 0; d < dims; ++d) {
    if (sizes[d] < 0) return (int)cudaErrorInvalidValue;
    words *= sizes[d];
  }
  if (words >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  g.a = (const u64*)a;
  g.b = (const u64*)b;
  g.b_shoup = shoup ? (const u64*)b_shoup : nullptr;
  g.p = (const u64*)p;
  g.lo = shoup ? nullptr : (const u64*)lo;
  g.hi = shoup ? nullptr : (const u64*)hi;
  g.out = (u64*)out;
  g.words = (unsigned)words;
  g.dims = merge_dims(dims, sizes, strides, g);
  return g.dims < 0 ? (int)cudaErrorInvalidValue : 0;
}

// out = a b mod p over the output shape sizes[0 .. dims - 1]; strides holds
// the element strides of a, b, b_shoup and the moduli, dims each, in that
// order. shoup != 0: Shoup's method with b_shoup (lo, hi unused); else
// Barrett's with lo, hi (b_shoup unused). The output's words must be fewer
// than 2^31.
extern "C" int tpufhe_zq_mul(int shoup, int dims, const long long* sizes,
                             const long long* strides, const void* a,
                             const void* b, const void* b_shoup,
                             const void* p, const void* lo, const void* hi,
                             void* out, void* stream) {
  ZqMulArgs g;
  const int err = prepare(shoup, dims, sizes, strides, a, b, b_shoup, p, lo,
                          hi, out, g);
  if (err || g.words == 0) return err;
  cudaError_t e = shoup ? launch<true>(g, (cudaStream_t)stream)
                        : launch<false>(g, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch plan of that call, without launching: plan[0] the merged
// dimensions, plan[1] the words a thread takes.
extern "C" int tpufhe_zq_mul_plan(int shoup, int dims, const long long* sizes,
                                  const long long* strides, const void* a,
                                  const void* b, const void* b_shoup,
                                  const void* p, const void* lo,
                                  const void* hi, void* out,
                                  long long* plan) {
  ZqMulArgs g;
  const int err = prepare(shoup, dims, sizes, strides, a, b, b_shoup, p, lo,
                          hi, out, g);
  if (err) return err;
  plan[0] = g.dims;
  plan[1] = vector_width(g);
  return 0;
}
