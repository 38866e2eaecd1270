// K4: the relinearization tail, and beside it ks_tail, the key switch alone.
//
// K4: from the down-scaled power-basis rows (c0, c1, c2) it computes, in
// the NTT domain,
//   out0 = NTT(c0) + sum_i NTT(d_i) ksk0_i,  out1 = NTT(c1) + sum_i NTT(d_i) ksk1_i
// where d_i is c2's limb i reduced modulo the limb p_j (the Garner
// decomposition of fhe.rs key_switching_key.rs:214-241).
//
// Replaces tpufhe/ops/pallas/mxu_ntt_kernel.py:_relin_tail_kernel in mode
// "relin" (wrapper relin_tail_pallas). That kernel reads the k x k
// broadcast rows of pipeline._ksk_digits; this one reads c2's limb i
// directly and reduces it mod p_j itself, so the broadcast never exists.
//
// Data: dsc (3, rows, k, n) canonical; ksk0, ksk0_shoup, ksk1, ksk1_shoup
// (k, k, n) with [i][j] = decomposition row i, limb j; out (2, rows, k, n).
// One cluster of k + 2 CTAs per (row, limb j), each CTA one transformed row
// (d_0 .. d_{k-1}, c0, c1) of n words and a slice of both outputs: the body
// is keyswitch_device.cuh, shared with K5. The launch plan (cluster size,
// threads) comes from the wrapper (kernels.tail_plan), the pass-ordered
// twiddles tw (k, n, 2) from NttTables.pass_twiddles.
//
// Bound on this card: per (row, limb) coefficient it reads 24 bytes of
// ciphertext and 32 k bytes of key (the key is shared by all rows and stays
// in L2) and writes 16; it runs k + 2 forward transforms, so at n = 8192 the
// integer-multiply bound is about twice the memory bound. The design that
// held three 64 KB rows in one 1024-thread block ran one block per SM, in
// 1.45 waves at the main shape (rows 64, k = 3), and 13 barriers a
// transform; this one runs 960 CTAs of 64 KB, three to an SM
// (TAIL_MIN_BLOCKS), seven barriers a transform.
#include "keyswitch_device.cuh"

template <int LOGN>
__global__ void __launch_bounds__(TAIL_THREADS, TAIL_MIN_BLOCKS)
    relin_tail_kernel(const TailArgs a) {
  keyswitch_tail<TAIL_RELIN, LOGN>(a);
}

static TailKernel relin_instance(int n, int threads) {
  return tail_instance(n, threads, relin_tail_kernel<13>,
                       relin_tail_kernel<12>, relin_tail_kernel<0>);
}

// rows_k = rows * k clusters of `cluster` CTAs.
extern "C" int tpufhe_relin_tail(const void* dsc, void* out, long long rows_k,
                                 int k, int n, int cluster, int threads,
                                 const void* k0, const void* k0s,
                                 const void* k1, const void* k1s,
                                 const void* tw, const void* limb_p,
                                 const void* b_lo, const void* b_hi,
                                 void* stream) {
  const u64* c2 = (const u64*)dsc + 2 * rows_k * n;
  return launch_tail(relin_instance(n, threads),
                     tail_args(c2, dsc, out, rows_k, k, k, n, k0, k0s, k1,
                               k1s, tw, limb_p, b_lo, b_hi),
                     rows_k, cluster, threads, stream);
}

extern "C" int tpufhe_relin_tail_occupancy(int n, int cluster, int threads,
                                           int* blocks_per_sm,
                                           int* clusters) {
  return tail_occupancy(relin_instance(n, threads), n, cluster, threads,
                        blocks_per_sm, clusters);
}

// ks_tail: the key switch alone (tpufhe's mode "ks_only" of the same kernel,
// mxu_ntt_kernel.py:464, selected at :499-500 and :620; fhe.rs
// key_switching_key.rs:214-241): from power-basis c2 (rows, d, n) it
// computes, in the NTT domain of the key's k >= d limbs,
//   out0 = sum_i NTT(d_i) ksk0_i,  out1 = sum_i NTT(d_i) ksk1_i
// with no adds, d_i c2's limb i reduced modulo p_j. It serves
// KeySwitchingKey.key_switch, key_switch_down (MulPIR's leveled expansion:
// d = 2 digit rows over k = 3 limbs) and the RGSW external product, where
// the unfused route runs K1 on the stacked digit rows and then
// ks_accumulate: the lifted rows never reach device memory here.
//
// Data: c2 (rows, d, n) canonical, limb i modulo key limb i (the key's
// first d moduli are the ciphertext's); ksk0, ksk0_shoup, ksk1, ksk1_shoup
// (d, k, n); out (2, rows, k, n), canonical. One cluster of
// min(d, TAIL_CLUSTER_MAX) CTAs per (row, limb j), each CTA one transformed
// digit row: keyswitch_device.cuh, the body of K4 and K5.
//
// Bound on this card: per (row, limb) coefficient it reads 8 d bytes of c2
// (each limb of c2 once per limb j: L2 serves the k - 1 rereads) and 32 d
// bytes of key (shared by all rows, so it stays in L2) and writes 16; its d
// forward transforms make it integer-multiply bound at n = 8192, as K5.
template <int LOGN>
__global__ void __launch_bounds__(TAIL_THREADS, TAIL_MIN_BLOCKS)
    ks_tail_kernel(const TailArgs a) {
  keyswitch_tail<TAIL_KS, LOGN>(a);
}

static TailKernel ks_instance(int n, int threads) {
  return tail_instance(n, threads, ks_tail_kernel<13>, ks_tail_kernel<12>,
                       ks_tail_kernel<0>);
}

// rows_k = rows * k clusters of `cluster` CTAs; d digit rows.
extern "C" int tpufhe_ks_tail(const void* c2, void* out, long long rows_k,
                              int d, int k, int n, int cluster, int threads,
                              const void* k0, const void* k0s,
                              const void* k1, const void* k1s,
                              const void* tw, const void* limb_p,
                              const void* b_lo, const void* b_hi,
                              void* stream) {
  if (d < 1 || d > k) return (int)cudaErrorInvalidValue;
  return launch_tail(ks_instance(n, threads),
                     tail_args(c2, nullptr, out, rows_k, d, k, n, k0, k0s, k1,
                               k1s, tw, limb_p, b_lo, b_hi),
                     rows_k, cluster, threads, stream);
}

extern "C" int tpufhe_ks_tail_occupancy(int n, int cluster, int threads,
                                        int* blocks_per_sm, int* clusters) {
  return tail_occupancy(ks_instance(n, threads), n, cluster, threads,
                        blocks_per_sm, clusters);
}
