// K9: forward / inverse negacyclic NTT of a batch of narrow (w30) RNS rows:
// one residue per 32-bit word, p < 2^30, Shoup constants scaled by 2^32.
//
// Replaces tpufhe/ops/pallas/ntt32_kernel.py:_ntt32_kernel (wrapper
// ntt32_pallas), tpufhe's narrow transform at 256 <= N < 1024, which runs
// the Harvey butterflies stage by stage on lane-folded (S, 128) tiles with
// rolls and per-stage lane tables. It also stands for tpufhe's narrow route
// at N >= 1024, the four-step int8 digit-plane product of
// ntt_mxu.forward_mxu32 / backward_mxu32 for the TPU's matrix unit: the
// same function, the same twiddles and the same bit-reversed output order
// (tpufhe/ops/ntt.py forward32 / backward32). Hopper multiplies 32-bit
// words natively, so this kernel runs the butterflies directly, with
// __umulhi for the Shoup quotient.
//
// Data: x (rows, k_sel, n) int32 words read as u32, canonical residues;
// y the same shape, canonical, or for a lazy forward (tpufhe's `lazy`
// flag, ntt32_kernel.py:108) the last pass's words unreduced, below 4p
// (up to 2^32). Row b belongs to limb limb0 + b mod k_sel, whose modulus
// and pass-ordered table (NttTables.pass_twiddles of the narrow tables,
// the counterpart of limb_slice) serve it.
//
// Bound on this card: each word moves 8 bytes through device memory (read
// once, written once) and takes part in log2(n) / 2 butterflies of three
// 32-bit multiplies, about 20 multiplies at n = 8192. The card multiplies
// about 5 int32 words in the time it moves one byte (16.7 T/s against
// 3.35 TB/s), so the transform is bytes-bound, by about 2:1. The radix-2
// design that kept the row in shared memory through log2(n) stages ran
// 4.4x that bound: thirteen barriers and fourteen shared-memory round
// trips a row at n = 8192, and the twiddle and its Shoup constant in two
// tables.
//
// Design: K1's passes (ntt_pass_device.cuh) on 32-bit words. A thread
// takes a unit of 2^NTT32_STAGES words through NTT32_STAGES butterfly
// stages in registers; the first pass reads its units from device memory
// and the last writes them there (canonical, the inverse with the n^{-1}
// fold); between passes the row sits in shared memory at pass_slot32, a
// swizzle that keeps every warp access free of bank conflicts; each
// (twiddle, Shoup) pair is one 8-byte load from the pass-ordered table.
// One CTA a row: 4 n bytes (32 KB at n = 8192), so six CTAs share an SM's
// 228 KB. A fixed instance for n = 8192 (the programs' ring) knows every
// pass's strides at compile time; a general one serves any other n up to
// what one CTA's shared memory holds. kernels.ntt32_plan gives the plan.
#include "ntt_pass_device.cuh"

// Stages a pass (kernels.NARROW_PASS_STAGES), threads of a CTA (at most;
// kernels.NTT32_THREADS), and the CTAs an SM must hold: six rows of 32 KB
// share its 228 KB, which leaves a 256-thread CTA 40 registers a thread.
#define NTT32_STAGES 3
#define NTT32_THREADS 256
#define NTT32_MIN_BLOCKS 6

struct Ntt32Args {
  const u32* x;
  u32* y;
  const uint2* tw;  // (k_ctx, n) pass-ordered (twiddle, Shoup) pairs
  const u32 *limb_p, *ninv, *ninv_s;  // (k_ctx,)
  int k_sel, n, logn, limb0;
};

typedef void (*Ntt32Kernel)(Ntt32Args);

// One CTA per row. LOGN: log2(n) of a fixed instance (NTT32_THREADS
// threads), 0 for any n. LAZY: a forward whose output stays below 4p.
template <int LOGN, bool INVERSE, bool LAZY = false>
__global__ void __launch_bounds__(NTT32_THREADS, NTT32_MIN_BLOCKS)
    ntt32_kernel(const Ntt32Args a) {
  extern __shared__ u32 row[];
  constexpr int THREADS = LOGN ? NTT32_THREADS : 0;
  const int n = LOGN ? 1 << LOGN : a.n;
  const long long blk = blockIdx.x;
  const int limb = a.limb0 + (int)(blk % a.k_sel);
  const u32 p = a.limb_p[limb];
  const uint2* tw = a.tw + (long long)limb * n;
  const u32* src = a.x + blk * n;
  u32* dst = a.y + blk * n;
  if (INVERSE)
    inverse_row<LOGN, THREADS, NTT32_STAGES>(row, src, dst, a.logn, tw, p,
                                             a.ninv[limb], a.ninv_s[limb]);
  else
    forward_row<LOGN, THREADS, NTT32_STAGES, LAZY>(row, src, dst, a.logn, tw,
                                                   p);
}

// The instance that runs degree n at `threads` threads a CTA, or null; a
// lazy inverse does not exist.
static Ntt32Kernel ntt32_instance(int n, int inverse, int lazy, int threads) {
  if (n < 8 || (inverse && lazy)) return nullptr;
  if (threads == NTT32_THREADS && n == 8192)
    return inverse ? ntt32_kernel<13, true>
           : lazy  ? ntt32_kernel<13, false, true>
                   : ntt32_kernel<13, false>;
  return inverse ? ntt32_kernel<0, true>
         : lazy  ? ntt32_kernel<0, false, true>
                 : ntt32_kernel<0, false>;
}

// rows: (row, limb) rows = batch rows * k_sel. tw: the (k_ctx, n)
// pass-ordered table of the direction (NttTables.pass_twiddles of the
// narrow tables); limb_p, ninv, ninv_s: (k_ctx,) per limb. lazy: a forward
// whose output words stay below 4p (refused with inverse). threads:
// kernels.ntt32_plan(n).
extern "C" int tpufhe_ntt32(const void* x, void* y, long long rows, int k_sel,
                            int n, const void* tw, const void* limb_p,
                            const void* ninv, const void* ninv_s, int limb0,
                            int inverse, int lazy, int threads,
                            void* stream) {
  Ntt32Kernel kernel = ntt32_instance(n, inverse, lazy, threads);
  if (!kernel) return (int)cudaErrorInvalidValue;
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  const Ntt32Args a{(const u32*)x,      (u32*)y,
                    (const uint2*)tw,   (const u32*)limb_p,
                    (const u32*)ninv,   (const u32*)ninv_s,
                    k_sel,              n,
                    logn,               limb0};
  return pass_launch(kernel, a, rows, 1, threads, n * (int)sizeof(u32),
                     stream);
}

// CTAs of the instance one SM holds (clusters: the same, of one CTA).
extern "C" int tpufhe_ntt32_occupancy(int n, int inverse, int threads,
                                      int* blocks_per_sm, int* clusters) {
  Ntt32Kernel kernel = ntt32_instance(n, inverse, 0, threads);
  if (!kernel) return (int)cudaErrorInvalidValue;
  return pass_occupancy(kernel, 1, threads, n * (int)sizeof(u32),
                        blocks_per_sm, clusters);
}
