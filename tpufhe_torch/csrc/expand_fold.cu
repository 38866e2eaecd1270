// The fold of one doubling of the oblivious expansion (pipeline.py
// make_expand), one elementwise pass over both ciphertext parts. For each
// word of limb i of the 2^l live ciphertexts:
//   sub0 = s0 + ks0 mod p_i (the rotation's add; without an addend sub0 = s0)
//   sub1 = ks1
//   out_j[:2^l]  = cur_j + sub_j mod p_i
//   out_j[2^l:]  = (cur_j - sub_j) mono mod p_i, by Shoup with mono_shoup,
// mono = x^{-2^l} in the NTT domain, one (k, N) row broadcast over the
// ciphertexts and the batch. Every input is canonical and so is every
// output, word for word what the plain version (pipeline.py
// expand_fold_plain: zq add, sub, mul_shoup and torch.cat) makes.
//
// Replaces no Pallas kernel: it stands for tpufhe's XLA fold,
// tpufhe/pipeline.py:843 build_expand_step (the add after the leveled key
// switch, the subtractions, the products by the monomial and the
// concatenation), which the port ran as nine torch launches and two zq_mul
// launches a doubling.
//
// Bound on this card: bytes. A word of a part reads cur, ks and (part 0)
// s0, and writes two words, against one 64 x 64 -> 128-bit product: 9
// streamed words of 8 bytes for a word of both parts with the addend, 8
// without. The monomial and its Shoup constants, (k, N) words read again by
// every ciphertext, stay in L2. One thread serves both parts of
// EXPAND_FOLD_VEC adjacent words of a row, so the monomial's words are read
// once for both and each streamed operand is read, and each output written,
// in 16-byte vector accesses wherever every pointer is 16-byte aligned and
// the rows have even length; elsewhere one word a thread, scalar accesses.
// Operands are contiguous (..., k, N) rows of one shape; out0 and out1 hold
// twice their words, the sums first.
#include <cuda_runtime.h>

#include "modarith.cuh"

#define EXPAND_FOLD_THREADS 256
#define EXPAND_FOLD_VEC 2

struct ExpandFoldArgs {
  const u64* cur0;
  const u64* cur1;
  const u64* s0;
  const u64* ks0;  // null: no addend (sub0 = s0)
  const u64* ks1;
  const u64* mono;  // (k, N)
  const u64* mono_shoup;
  const u64* p;  // (k)
  u64* out0;  // 2 x words: cur0 + sub0, then (cur0 - sub0) mono
  u64* out1;
  unsigned words;  // words of one part's input
  unsigned n;      // N
  unsigned kn;     // k N: the monomial's words
};

template <int VEC>
__device__ __forceinline__ void load(const u64* __restrict__ x, unsigned e,
                                     u64 (&v)[VEC]) {
  if (VEC == 2) {
    const ulonglong2 w = *(const ulonglong2*)(x + e);
    v[0] = w.x;
    v[VEC - 1] = w.y;
  } else {
    v[0] = x[e];
  }
}

template <int VEC>
__device__ __forceinline__ void store(u64* x, size_t e, const u64 (&v)[VEC]) {
  if (VEC == 2) {
    ulonglong2 w;
    w.x = v[0];
    w.y = v[VEC - 1];
    *(ulonglong2*)(x + e) = w;
  } else {
    x[e] = v[0];
  }
}

// One part's sums and products of VEC words at e, given sub = s (+ a).
template <int VEC>
__device__ __forceinline__ void fold_part(const ExpandFoldArgs& g,
                                          const u64* cur, const u64 (&sub)[VEC],
                                          const u64 (&m)[VEC],
                                          const u64 (&ms)[VEC], u64 p,
                                          unsigned e, u64* out) {
  u64 c[VEC], lo[VEC], hi[VEC];
  load<VEC>(cur, e, c);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    lo[i] = add_mod(c[i], sub[i], p);
    hi[i] = mul_shoup(sub_mod(c[i], sub[i], p), m[i], ms[i], p);
  }
  store<VEC>(out, e, lo);
  store<VEC>(out, (size_t)g.words + e, hi);
}

template <bool ADD, int VEC>
__global__ void __launch_bounds__(EXPAND_FOLD_THREADS)
    expand_fold_kernel(const __grid_constant__ ExpandFoldArgs g) {
  const unsigned e = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (e >= g.words) return;
  // VEC words of a row share its limb (the row's length is a multiple of VEC)
  const unsigned col = e % g.kn;
  const u64 p = g.p[col / g.n];
  u64 m[VEC], ms[VEC], s0[VEC], s1[VEC];
  load<VEC>(g.mono, col, m);
  load<VEC>(g.mono_shoup, col, ms);
  load<VEC>(g.s0, e, s0);
  if (ADD) {
    u64 a[VEC];
    load<VEC>(g.ks0, e, a);
#pragma unroll
    for (int i = 0; i < VEC; ++i) s0[i] = add_mod(s0[i], a[i], p);
  }
  load<VEC>(g.ks1, e, s1);
  fold_part<VEC>(g, g.cur0, s0, m, ms, p, e, g.out0);
  fold_part<VEC>(g, g.cur1, s1, m, ms, p, e, g.out1);
}

// Words a thread takes: EXPAND_FOLD_VEC where the rows have even length
// and every operand starts on a 16-byte boundary, else 1.
static unsigned vector_width(const ExpandFoldArgs& g) {
  const void* ptrs[9] = {g.cur0, g.cur1, g.s0,   g.ks0, g.ks1,
                         g.mono, g.mono_shoup, g.out0, g.out1};
  if (g.n % EXPAND_FOLD_VEC) return 1;
  for (const void* x : ptrs)  // ks0 may be null, which is aligned
    if ((unsigned long long)x % 16) return 1;
  return EXPAND_FOLD_VEC;
}

template <bool ADD>
static cudaError_t launch(const ExpandFoldArgs& g, cudaStream_t stream) {
  const unsigned vw = vector_width(g);
  const unsigned items = (g.words + vw - 1) / vw;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((items + EXPAND_FOLD_THREADS - 1) / EXPAND_FOLD_THREADS);
  cfg.blockDim = dim3(EXPAND_FOLD_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  return vw == EXPAND_FOLD_VEC
             ? cudaLaunchKernelEx(&cfg, expand_fold_kernel<ADD, EXPAND_FOLD_VEC>,
                                  g)
             : cudaLaunchKernelEx(&cfg, expand_fold_kernel<ADD, 1>, g);
}

// The operands' checks and the arguments of tpufhe_expand_fold; 0 or an
// error.
static int prepare(long long words, int k, int n, const void* cur0,
                   const void* cur1, const void* s0, const void* ks0,
                   const void* ks1, const void* mono, const void* mono_shoup,
                   const void* p, void* out0, void* out1, ExpandFoldArgs& g) {
  if (words < 0 || words >= (1LL << 31) || k <= 0 || n <= 0 ||
      words % ((long long)k * n) || !cur0 || !cur1 || !s0 || !ks1 || !mono ||
      !mono_shoup || !p || !out0 || !out1)
    return (int)cudaErrorInvalidValue;
  g.cur0 = (const u64*)cur0;
  g.cur1 = (const u64*)cur1;
  g.s0 = (const u64*)s0;
  g.ks0 = (const u64*)ks0;
  g.ks1 = (const u64*)ks1;
  g.mono = (const u64*)mono;
  g.mono_shoup = (const u64*)mono_shoup;
  g.p = (const u64*)p;
  g.out0 = (u64*)out0;
  g.out1 = (u64*)out1;
  g.words = (unsigned)words;
  g.n = (unsigned)n;
  g.kn = (unsigned)(k * n);
  return 0;
}

// The fold of `words` words a part (a multiple of k n, below 2^31) of k
// limbs of degree n: out_j = (cur_j + sub_j, (cur_j - sub_j) mono) mod p,
// sub0 = s0 + ks0 (s0 alone where ks0 is null), sub1 = ks1. out0 and out1
// hold 2 x words words each, the sums first.
extern "C" int tpufhe_expand_fold(long long words, int k, int n,
                                  const void* cur0, const void* cur1,
                                  const void* s0, const void* ks0,
                                  const void* ks1, const void* mono,
                                  const void* mono_shoup, const void* p,
                                  void* out0, void* out1, void* stream) {
  ExpandFoldArgs g;
  const int err = prepare(words, k, n, cur0, cur1, s0, ks0, ks1, mono,
                          mono_shoup, p, out0, out1, g);
  if (err || g.words == 0) return err;
  cudaError_t e = ks0 ? launch<true>(g, (cudaStream_t)stream)
                      : launch<false>(g, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The words a thread takes in that call, without launching (plan[0]).
extern "C" int tpufhe_expand_fold_plan(long long words, int k, int n,
                                       const void* cur0, const void* cur1,
                                       const void* s0, const void* ks0,
                                       const void* ks1, const void* mono,
                                       const void* mono_shoup, const void* p,
                                       void* out0, void* out1,
                                       long long* plan) {
  ExpandFoldArgs g;
  const int err = prepare(words, k, n, cur0, cur1, s0, ks0, ks1, mono,
                          mono_shoup, p, out0, out1, g);
  if (err) return err;
  plan[0] = vector_width(g);
  return 0;
}
