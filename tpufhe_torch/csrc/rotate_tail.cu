// K5: the Galois key-switch tail. From the substituted c0 (s0, NTT domain)
// and the inverse NTT of the substituted c1 (c2, power basis) it computes,
// in the NTT domain,
//   out0 = s0 + sum_i NTT(d_i) ksk0_i,  out1 = sum_i NTT(d_i) ksk1_i
// where d_i is c2's limb i reduced modulo the limb p_j (fhe.rs
// galois_key.rs:62-87 with key_switching_key.rs:214-241).
//
// Replaces tpufhe/ops/pallas/mxu_ntt_kernel.py:_relin_tail_kernel in mode
// "rotate" (wrapper rotate_tail_pallas). As there, s0 rides along
// untransformed and is added to the first sum; as in K4, c2's limb i is
// read directly and reduced mod p_j, so the k x k digit broadcast never
// exists.
//
// Data: s0, c2 (rows, k, n) canonical; ksk0, ksk0_shoup, ksk1, ksk1_shoup
// (k, k, n) with [i][j] = decomposition row i, limb j; out (2, rows, k, n).
// One cluster of k CTAs per (row, limb j), each CTA one transformed digit
// row of n words and a slice of both outputs: keyswitch_device.cuh, which
// K4 shares.
//
// Bound on this card: per (row, limb) coefficient it reads 16 bytes of
// ciphertext and 32 k bytes of key (shared by all rows, so it stays in L2)
// and writes 16; it runs k forward transforms, so at n = 8192 the
// integer-multiply bound is about twice the memory bound. The three-row
// design ran its 128 blocks (rows 32, k = 4) one to an SM; this one runs
// 512 CTAs of 64 KB, three to an SM, seven barriers a transform.
#include "keyswitch_device.cuh"

template <int LOGN>
__global__ void __launch_bounds__(TAIL_THREADS, TAIL_MIN_BLOCKS)
    rotate_tail_kernel(const TailArgs a) {
  keyswitch_tail<TAIL_ROTATE, LOGN>(a);
}

static TailKernel rotate_instance(int n, int threads) {
  return tail_instance(n, threads, rotate_tail_kernel<13>,
                       rotate_tail_kernel<12>, rotate_tail_kernel<0>);
}

// rows_k = rows * k clusters of `cluster` CTAs.
extern "C" int tpufhe_rotate_tail(const void* s0, const void* c2, void* out,
                                  long long rows_k, int k, int n, int cluster,
                                  int threads, const void* k0,
                                  const void* k0s, const void* k1,
                                  const void* k1s, const void* tw,
                                  const void* limb_p, const void* b_lo,
                                  const void* b_hi, void* stream) {
  return launch_tail(rotate_instance(n, threads),
                     tail_args(c2, s0, out, rows_k, k, k, n, k0, k0s, k1,
                               k1s, tw, limb_p, b_lo, b_hi),
                     rows_k, cluster, threads, stream);
}

extern "C" int tpufhe_rotate_tail_occupancy(int n, int cluster, int threads,
                                            int* blocks_per_sm,
                                            int* clusters) {
  return tail_occupancy(rotate_instance(n, threads), n, cluster, threads,
                        blocks_per_sm, clusters);
}
