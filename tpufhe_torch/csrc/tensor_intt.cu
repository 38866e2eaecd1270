// K3: degree-2 tensor product in the NTT domain fused with the inverse NTT
// of its three parts, over the multiplication basis.
//
// Replaces tpufhe/ops/pallas/mxu_ntt_kernel.py:_tensor_intt_kernel
// (wrapper tensor_intt_pallas), which forms the tensor rows in VMEM and
// inverse-transforms them with the four-step int8 matmul NTT.
//
// Data: ext (4, rows, k, n) holding a0, a1, b0, b1 in NTT form; out
// (3, rows, k, n) holding c0 = a0 b0, c1 = a0 b1 + a1 b0, c2 = a1 b1 mod p
// in power basis. The tensor never reaches device memory.
//
// Bound on this card: 56 bytes of traffic per coefficient (4 reads, 3
// writes) against about 8 + 3 (log2(n) / 2 + 1) 64-bit products; at
// n = 8192 the multiply bound is the larger. The design that held the three
// rows in one 1024-thread block (192 KB at n = 8192) ran one block an SM
// and 13 barriers for the three transforms in lockstep.
//
// Design: one cluster of three CTAs per (row, limb), CTA r holding output
// part r alone (n words: 64 KB at n = 8192, so three 512-thread CTAs share
// an SM). CTA r reads its third of the coefficients of the four operands
// once (kernels.tensor_intt_thirds), forms the three products and writes
// each into its part's CTA through distributed shared memory. After
// cluster.sync() each CTA inverse-transforms its row with the passes of
// ntt_pass_device.cuh (K1's inverse: two stages a pass in registers, six
// barriers at n = 8192, the last pass writing the output with the n^{-1}
// fold), so each word is still read and written once. A first
// cluster.sync() makes sure every CTA of the cluster runs before its shared
// memory is written. kernels.tensor_intt_plan gives the launch plan; fixed
// instances for n = 8192 and 4096, a general one for any other n.
#include "ntt_pass_device.cuh"

// Threads of a CTA (at most; n / 4 below n = 2048), the CTAs an SM must
// hold, and the CTAs of a cluster: one per output part.
#define K3_THREADS 512
#define K3_MIN_BLOCKS 3
#define K3_PARTS 3

struct TensorInttArgs {
  const u64* ext;
  u64* out;
  long long plane;       // rows * k * n words per operand
  const ulonglong2* tz;  // (k, n) pass-ordered inverse (zeta, Shoup) pairs
  const u64 *limb_p, *b_lo, *b_hi, *ninv, *ninv_s;  // (k,)
  int k, n, logn;
};

typedef void (*TensorInttKernel)(TensorInttArgs);

// LOGN: log2(n) of a fixed instance (K3_THREADS threads), 0 for any n.
template <int LOGN>
__global__ void __launch_bounds__(K3_THREADS, K3_MIN_BLOCKS)
    tensor_intt_kernel(const TensorInttArgs a) {
  namespace cg = cooperative_groups;
  extern __shared__ u64 row[];
  constexpr int THREADS = LOGN ? K3_THREADS : 0;
  const int n = LOGN ? 1 << LOGN : a.n;
  const int stride = THREADS ? THREADS : (int)blockDim.x;
  cg::cluster_group cluster = cg::this_cluster();
  const int part = (int)cluster.block_rank();
  const long long blk = blockIdx.x / K3_PARTS;  // (row, limb)
  const int j = (int)(blk % a.k);
  const Barrett br = {a.limb_p[j], a.b_lo[j], a.b_hi[j]};
  const u64* a0 = a.ext + blk * n;
  const u64* a1 = a0 + a.plane;
  const u64* b0 = a1 + a.plane;
  const u64* b1 = b0 + a.plane;
  // this CTA's third of the coefficients, in whole 32-word pieces
  const int span = ((n + K3_PARTS - 1) / K3_PARTS + 31) & ~31;
  const int lo = part * span;
  const int hi = min(n, lo + span);
  u64* c0 = cluster.map_shared_rank(row, 0);
  u64* c1 = cluster.map_shared_rank(row, 1);
  u64* c2 = cluster.map_shared_rank(row, 2);
  cluster.sync();
  for (int e = lo + threadIdx.x; e < hi; e += stride) {
    const u64 x0 = a0[e], x1 = a1[e], y0 = b0[e], y1 = b1[e];
    const int s = pass_slot(e);
    c0[s] = mul_mod(x0, y0, br);
    c1[s] = mul_add_mod(x0, y1, x1, y0, br);
    c2[s] = mul_mod(x1, y1, br);
  }
  cluster.sync();
  inverse_row<LOGN, THREADS>(row, nullptr, a.out + part * a.plane + blk * n,
                             a.logn, a.tz + (long long)j * n, br.p,
                             a.ninv[j], a.ninv_s[j]);
}

// The instance that runs degree n at `threads` threads a CTA.
static TensorInttKernel tensor_intt_instance(int n, int threads) {
  if (threads == K3_THREADS && n == 8192) return tensor_intt_kernel<13>;
  if (threads == K3_THREADS && n == 4096) return tensor_intt_kernel<12>;
  return tensor_intt_kernel<0>;
}

// rows_k = rows * k clusters of `cluster` (= K3_PARTS) CTAs of `threads`
// threads (kernels.tensor_intt_plan); tz: NttTables.pass_twiddles of the
// inverse.
extern "C" int tpufhe_tensor_intt(const void* ext, void* out, long long rows_k,
                                  int k, int n, const void* tz,
                                  const void* limb_p, const void* b_lo,
                                  const void* b_hi, const void* ninv,
                                  const void* ninv_s, int cluster,
                                  int threads, void* stream) {
  if (cluster != K3_PARTS || n < 8) return (int)cudaErrorInvalidValue;
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  const TensorInttArgs a{(const u64*)ext,    (u64*)out,
                         rows_k * n,         (const ulonglong2*)tz,
                         (const u64*)limb_p, (const u64*)b_lo,
                         (const u64*)b_hi,   (const u64*)ninv,
                         (const u64*)ninv_s, k,
                         n,                  logn};
  return pass_launch(tensor_intt_instance(n, threads), a, rows_k * cluster,
                     cluster, threads, n * (int)sizeof(u64), stream);
}

// CTAs of the instance one SM holds, and clusters the card holds at once.
extern "C" int tpufhe_tensor_intt_occupancy(int n, int cluster, int threads,
                                            int* blocks_per_sm,
                                            int* clusters) {
  return pass_occupancy(tensor_intt_instance(n, threads), cluster, threads,
                        n * (int)sizeof(u64), blocks_per_sm, clusters);
}
