"""Drive tpufhe_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the last line:

1. card: the card's name and power limit (nvidia-smi);
2. build: compile the ten CUDA kernels (one nvcc per source, in
   parallel) and the native ChaCha8 / CBD sampler (g++); fails if either
   does not build;
3. kernels: each kernel against its plain torch version, compared with
   torch.equal, and both timed with CUDA events: ntt, rns_scale and
   tensor_intt at the shapes of the N = 8192, L = 3 x 62-bit, batch-64
   mul+relin; relin_tail at that mul+relin's (3, 64, 3, 8192), at phase
   13's 8 x 62-bit (3, 16, 8, 8192) and at BASELINE config 2's ring
   (3, 8, 2, 4096), rotate_tail at the N = 8192, 4 x 62-bit batch-32
   rotation (32, 4, 8192) and at (8, 2, 4096), each tail beside its
   unfused composition on the same inputs (unfused_ms) with its cluster
   and CTAs per SM; tensor at the square's shapes, intt_scale at the
   fused extend's (default and strategy 2), rns_scale and tensor_intt at
   strategy 2's; the rotation's inverse ntt at the batch-32 rotation;
   ntt at BASELINE config 2's ring (8, 2, 4096) and at N = 16 and 512
   (the small degrees tpufhe's other NTT kernel serves), each ntt and
   tensor_intt record with its launch plan (cluster, threads, CTAs per SM
   and clusters at once from the kernel's occupancy entry point), and so
   each intt_scale record, beside the time of the split K1 inverse + K2
   launches it fuses (split_ms); intt_scale also at one shape of its
   general instance (k_in = 12, N = 1024); ntt32 (with its plan)
   at the four transforms of the narrow N = 8192, 7 x 30-bit, batch-64
   mul+relin, at the narrow rotation's two and at N = 512, and rns_scale
   on its int32 rows (extend 7 -> 9 new limbs, down-scale 16 -> 7); at
   N = 16384, 6 x 62-bit, batch 16 (phase 12's shapes) ntt at the
   mul+relin's four transforms and the rotation's two, rns_scale at the
   extend (6 -> 7) and the down-scale (13 -> 6), tensor over the 13-limb
   basis and ks_accumulate (two addends, and the rotation's one); rns_scale at
   phase 13's extends and down-scales from 17 limbs (int64) and 18
   (int32), its general instance; ks_accumulate on the int32 rows of the
   narrow mul+relin (two addends) and rotation (one); ct_pt_dot at the dot
   bench's (128 terms, 4 x 62-bit at N = 8192), PIR's first dimension (64
   terms, 8 columns, 6 x 62-bit at N = 16384) and across its 14-term
   window (15 and 29 terms, 3 x 62-bit); and at the shapes of phases 16,
   17 and 18 every kernel those phases launch: SIMD encoding's and
   decoding's ntt modulo t, public-key encryption's ntt, ct_mul's (ntt, rns_scale, tensor), the relinearization's (ntt and
   rotate_tail; for phase 17's single-modulus key ntt of the two digit
   rows and ks_accumulate), the decryption's (ntt, rns_scale),
   Multiplicator.strategy2(rk, 1)'s over the 4-limb basis (phase 16),
   make_mul_relin's at N = 2048 (phase 17, tensor_intt among them) and on
   phase 18's moduli of 43 and 44 bits (relin_tail among them);
4. main path: keygen, SIMD encode + encrypt 64 pairs, one batched
   mul+relin (the launch counters must read ntt 2, rns_scale 2,
   tensor_intt 1, relin_tail 1), decrypt all 64 and check every slot
   against (va * vb) mod t, print the noise;
5. rate: chained batch-64 mul+relin steps timed with CUDA events;
6. rotation path (N = 8192, 4 x 62-bit, BASELINE config 4): secret key
   and an evaluation key for the inner sum and expansion level 4, encrypt
   32 SIMD and 4 poly ciphertexts; a column rotation by 1 of all 32, the
   inner sum of the first 16 and the expansion of the 4 into 16 each, each
   run with the launch counters set to 0 just before it (exact counts of
   ntt and rotate_tail); every slot of every output is checked after
   decryption, and the noise printed;
7. rates: chained batch-32 rotations and batch-16 inner sums, timed with
   CUDA events;
8. variants on phase 4's keys and ciphertexts: strategy 2 with kP = 1 and
   2 extension primes, split and with the fused extend, the default
   strategy with the fused extend, and the square; each run with the
   counters set to 0 just before it and held to its exact launch counts,
   every slot of all 64 outputs checked, the noise printed, each fused
   output torch.equal to its split one, and two chained kP = 2 products
   decrypted as va * vb * vb;
9. variant rates: chained batch-64 steps of each variant;
10. narrow (w30) path (seed 2028): N = 8192, moduli 7 x 30-bit, t = 65537,
    int32 rows; keygen (sk, rk, the inner sum's 13 Galois keys), 128 SIMD
    encryptions, the encryption core (ntt32 1) and the decryption core on
    64 ciphertexts (ntt32 1, rns_scale 1), then mul+relin and the square
    at batch 64 (ntt32 4, rns_scale 2, ks_accumulate 1 each), a column
    rotation by 1 at batch 32 (ntt32 2, ks_accumulate 1) and the inner sum
    at batch 16 (ntt32 26, ks_accumulate 13), each run with the counters
    set to 0 just before it and held to exactly those counts (no wide
    kernel), every slot of every output checked;
11. narrow rates: chained steps of the four narrow programs, with the
    kernels' and the glue's share of a mul+relin and a rotation;
12. N = 16384 (seed 2029): BASELINE config 5's ring, 6 x 62-bit,
    t = 65537, where three rows do not fit one block (kernels.tail_fits),
    so the programs take the unfused route for K3, K4 and K5; keygen (sk, rk,
    a column-rotation key), 2 x 16 SIMD encryptions, then mul+relin and
    the square (ntt 4, rns_scale 2, tensor 1, ks_accumulate 1 each) and a
    column rotation by 1 (ntt 2, ks_accumulate 1) at batch 16, each held
    to exactly those counts, every slot checked, the noise held to leave
    at least the N = 8192 product's margin of q; chained steps timed,
    with the kernels' and the glue's share;
13. wider bases at N = 8192: mul+relin at batch 16 on 8 x 62-bit
    (multiplication basis 17 limbs) and 8 x 30-bit narrow (18 limbs),
    whose down-scales run K2's general instance, held to the launch
    counts of phases 4 and 10, every slot checked, chained steps timed;
14. BASELINE config 2 (seed 2031): N = 4096, 2 x 62-bit, batch 64,
    make_add then ct_mul_pt by a SIMD plaintext (no kernel), every slot
    checked, chained steps timed (add+pt_mul/s); ct_add_pt, ct_sub_pt and
    ct_neg through the object API, every slot checked;
15. dot products (seed 2032): N = 8192, 4 x 62-bit, 128 SIMD encryptions
    and plaintexts; make_ct_pt_dot and dot_product_scalar over 16 (one
    ct_pt_dot launch each), decrypted against sum v_i w_i mod t, then
    chained dot products timed (dot_products/s);
16. the object API on phase 4's keys and pairs: PublicKey encryption
    (seed 2033; ntt 2), ct_mul to three parts (ntt 6, rns_scale 3,
    tensor 1) and their decryption (ntt 1, rns_scale 1), ct_square (ntt
    4, rns_scale 2, tensor 1), relinearizes (ntt 1, rotate_tail 1),
    Multiplicator.default and strategy2(rk, 1) (ntt 7, rns_scale 3,
    tensor 1, rotate_tail 1), each torch.equal to make_mul_relin's output,
    every slot checked, the noise printed beside phase 4's;
17. the single-modulus key switch (seed 2034): N = 2048, 1 x 62-bit,
    batch 16, a relinearization key with log_base 31 and two digit rows;
    ct_mul, relinearizes (ntt 2, ks_accumulate 1) and make_mul_relin (ntt
    3, rns_scale 2, tensor_intt 1, ks_accumulate 1), equal, every slot
    checked;
18. default_parameters_128(20)'s N = 8192 set (seed 2035; 5 moduli of 43
    and 44 bits): public-key encryptions (ntt 2 each), make_mul_relin
    (phase 4's counts) and Multiplicator.default at batch 16, equal, every
    slot checked, chained steps timed.

The second-to-last line is {"kernels": [...]} (ten entries; relin_tail
and rotate_tail also carry unfused_ms, cluster, blocks_per_sm and
clusters, ntt, tensor_intt, intt_scale and ntt32 their plan, intt_scale
its split_ms), the last one {"ok": true,
"device": {...}}. Exits nonzero without a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

DEGREE = 8192
MODULI_SIZES = [62, 62, 62]
PLAINTEXT = 65537
BATCH = 64
SEED = 2026
RATE_STEPS = 20
# rotation path: BASELINE config 4 as bench.py runs it
ROT_MODULI_SIZES = [62, 62, 62, 62]
ROT_BATCH = 32
SUM_BATCH = 16
EXPAND_LEVEL = 4
EXPAND_BATCH = 4
ROT_RATE_STEPS = 64
SUM_RATE_STEPS = 4
# phase 8: (name, make_mul_relin options, launches per step)
MUL_VARIANTS = [
    ("strategy 2 kP=1 split", {"strategy2_primes": 1},
     {"ntt": 3, "rns_scale": 3, "tensor_intt": 1, "relin_tail": 1}),
    ("strategy 2 kP=1 fused", {"strategy2_primes": 1, "ext_fuse": True},
     {"intt_scale": 2, "ntt": 2, "tensor_intt": 1, "rns_scale": 1,
      "relin_tail": 1}),
    ("strategy 2 kP=2 split", {"strategy2_primes": 2},
     {"ntt": 3, "rns_scale": 3, "tensor_intt": 1, "relin_tail": 1}),
    ("strategy 2 kP=2 fused", {"strategy2_primes": 2, "ext_fuse": True},
     {"intt_scale": 2, "ntt": 2, "tensor_intt": 1, "rns_scale": 1,
      "relin_tail": 1}),
    ("default fused", {"ext_fuse": True},
     {"intt_scale": 1, "ntt": 1, "tensor_intt": 1, "rns_scale": 1,
      "relin_tail": 1}),
]
MUL_LAUNCHES = {"ntt": 2, "rns_scale": 2, "tensor_intt": 1, "relin_tail": 1}
SQUARE_LAUNCHES = {"ntt": 3, "rns_scale": 2, "tensor": 1, "relin_tail": 1}
# narrow (w30) path: every modulus below 2^30, int32 rows; K9, K2 and
# ks_accumulate only
NARROW_MODULI_SIZES = [30] * 7
NARROW_SEED = SEED + 2
NARROW_MUL_LAUNCHES = {"ntt32": 4, "rns_scale": 2, "ks_accumulate": 1}
NARROW_ROT_LAUNCHES = {"ntt32": 2, "ks_accumulate": 1}
# phase 12: BASELINE config 5's ring (bench.py:702-705), where K3, K4 and
# K5 do not fit one block: the unfused route (K7 + K1 inverse, K1 forward
# + ks_accumulate)
N16K = 16384
N16K_MODULI_SIZES = [62] * 6
N16K_SEED = SEED + 3
N16K_BATCH = 16
N16K_MUL_LAUNCHES = {"ntt": 4, "rns_scale": 2, "tensor": 1, "ks_accumulate": 1}
N16K_ROT_LAUNCHES = {"ntt": 2, "ks_accumulate": 1}
# phase 13: multiplication bases above 16 limbs (K2's general instance)
WIDER_SETS = [("8 x 62-bit", [62] * 8, MUL_LAUNCHES),
              ("8 x 30-bit narrow", [30] * 8, NARROW_MUL_LAUNCHES)]
WIDER_SEED = SEED + 4
WIDER_BATCH = 16
# phase 3's third K4 and K5 shape: BASELINE config 2's ring (bench.py:235-236)
TAIL_N4096 = 4096
TAIL_N4096_MODULI_SIZES = [62, 62]
# phase 14: BASELINE config 2, SIMD add + plaintext multiply (bench.py:229-266)
ADDPT_MODULI_SIZES = TAIL_N4096_MODULI_SIZES
ADDPT_BATCH = 64
ADDPT_SEED = SEED + 5
ADDPT_RATE_STEPS = 64
# phase 15: the dot-product bench, 128 pairs at N = 8192, 4 x 62-bit
# (bench.py:361-418), and dot_product_scalar over 16
DOT_MODULI_SIZES = ROT_MODULI_SIZES
DOT_PAIRS = 128
DOT_SCALAR = 16
DOT_SEED = SEED + 6
DOT_RATE_STEPS = 32
# phase 3's other ct_pt_dot shapes: PIR's first dimension (n = 64 terms,
# m = 8 columns) at phase 12's ring, and sums across the 62-bit window of
# 14 terms at 3 x 62-bit
DOT_PIR = (64, 8)
DOT_WINDOW_TERMS = (15, 29)
# phase 16: the object API at BASELINE config 3 on phase 4's keys
API_SEED = SEED + 7
API_PRODUCT_LAUNCHES = {"ntt": 6, "rns_scale": 3, "tensor": 1}
API_SQUARE_LAUNCHES = {"ntt": 4, "rns_scale": 2, "tensor": 1}
API_MULTIPLY_LAUNCHES = {"ntt": 7, "rns_scale": 3, "tensor": 1,
                         "rotate_tail": 1}
PK_ENCRYPT_LAUNCHES = {"ntt": 2}  # Delta m, and the three samples at once
# phase 17: one 62-bit modulus at N = 2048 (BASELINE config 1's ring): the
# single-modulus key switch (log_base 31, two digit rows)
K1_DEGREE = 2048
K1_MODULI_SIZES = [62]
K1_BATCH = 16
K1_SEED = SEED + 8
# phase 18: default_parameters_128(20)'s N = 8192 set (5 moduli of 43-44 bits)
D128_BITS = 20
D128_BATCH = 16
D128_SEED = SEED + 9
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
INT32_MULS_PER_CLOCK_PER_SM = 64  # CUDA C++ Programming Guide, cc 9.0

# int32 multiplies charged per 64-bit operation in the operation bounds:
# a 64 x 64 -> 64 low product is three 32-bit partial products, a high
# product four (csrc/modarith.cuh)
LO, HI = 3, 4
SHOUP = HI + 2 * LO  # lazy_mul_shoup
RED128 = 3 * HI + 4 * LO  # reduce_u128
MULMOD = LO + HI + RED128


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms, by CUDA events after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ntt_ops(n: int, inverse: bool, shoup: int = SHOUP) -> int:
    """int32 multiplies of one length-n transform (ops/ntt.py's radix-2
    stages): one Shoup product per butterfly, and per word for the n^{-1}
    fold."""
    ops = (n // 2) * int(math.log2(n)) * shoup
    return ops + n * shoup if inverse else ops


# a narrow (w30) Shoup product: one high and two low 32-bit products
SHOUP32 = 3


def scale_ops(sc, k_in: int, size: int, coeffs: int) -> int:
    """int32 multiplies of the HPS scaler body on `coeffs` coefficients
    (csrc/rns_scale_device.cuh, its fixed form; the chunked form adds one
    reduction per output and chunk after the first)."""
    # mul_64x128: two low and two high products per input limb; each
    # output sums plain 64 x 64 -> 128-bit products
    per = 2 * k_in * (LO + HI)
    per_out = 2 * RED128 + SHOUP + k_in * (LO + HI)
    if not sc.factor.is_one:
        # the theta_omega sum, and v * theta_gamma (128 x 128 bits)
        per += 2 * k_in * (LO + HI) + 4 * (LO + HI)
        per_out += RED128
    return coeffs * (per + size * per_out)


# int32 multiplies of one K3 / K7 tensor coefficient: two mul_mod and one
# mul_add_mod
TENSOR_OPS = 2 * MULMOD + 2 * (LO + HI) + RED128


class Bound:
    """Least time for a kernel's work: max(bytes / memory rate, int32
    multiplies / the card's int32 multiply rate)."""

    def __init__(self, int32_rate: float):
        self.int32_rate = int32_rate
        self.bytes = 0
        self.ops = 0

    def add(self, nbytes: int, ops: int) -> None:
        self.bytes += nbytes
        self.ops += ops

    def result(self) -> tuple[float, str]:
        t_bytes = self.bytes / MEM_BYTES_PER_S * 1e3
        t_ops = self.ops / self.int32_rate * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rand_residues(shape, moduli: torch.Tensor, gen) -> torch.Tensor:
    """Canonical residues for (..., k, n) of the moduli's word type (int64,
    or int32 for a narrow context): row j below moduli[j]; every first row
    along the leading axes is all (p - 1)."""
    x = torch.randint(0, 2 ** 62, shape, dtype=torch.int64,
                      device=moduli.device, generator=gen)
    x = torch.remainder(x, moduli[:, None].long()).to(moduli.dtype)
    x.view(-1, *shape[-2:])[0] = moduli[:, None] - 1
    return x


def random_key(ctx, gen, digits: int | None = None) -> SimpleNamespace:
    """A random (digits, k, N) key-switching key with its Shoup constants:
    k Garner rows (log_base 0), or `digits` rows of a single-modulus key
    (log_base = ceil(log2 q0) // 2)."""
    from tpufhe_torch.bfv.keys.key_switching_key import (
        next_pow2_ilog2,
        shoup_of,
    )

    k, n = ctx.k, ctx.degree
    key = SimpleNamespace(log_base=0 if digits is None else
                          next_pow2_ilog2(ctx.moduli[0]) // 2)
    digits = k if digits is None else digits
    key.c0 = rand_residues((digits, k, n), ctx.tables.p, gen)
    key.c1 = rand_residues((digits, k, n), ctx.tables.p, gen)
    key.c0_shoup = shoup_of(key.c0, ctx.moduli)
    key.c1_shoup = shoup_of(key.c1, ctx.moduli)
    return key


def run_case(name, label, kfn, pfn, int32_rate, nbytes, ops) -> dict:
    """One kernel call against its plain version: torch.equal, then both
    timed. Raises SystemExit if they disagree."""

    def as_tensor(out):
        return torch.stack(out) if isinstance(out, tuple) else out

    got = as_tensor(kfn())
    want = as_tensor(pfn())
    torch.cuda.synchronize()
    equal = torch.equal(got, want)
    err = int((got - want).abs().max().item())
    log(f"  {name} {label}: equal={equal} max_abs_err={err}")
    if not equal:
        raise SystemExit(f"kernel {name} disagrees with its plain version "
                         f"at {label}")
    del got, want
    bound = Bound(int32_rate)
    bound.add(nbytes, ops)
    bound_ms, bound_by = bound.result()
    return {"label": label, "ms": time_ms(kfn, 20), "plain_ms": time_ms(pfn, 1),
            "max_abs_err": err, "bytes": nbytes, "int32_muls": ops,
            "bound_ms": bound_ms, "bound_by": bound_by}


def k1_case(label, x, tables, sl, inverse):
    """A run_cases item for K1 on (..., k_sel, n) rows of `tables` (limbs
    `sl`): each row read and written once, plus its twiddle tables."""
    from tpufhe_torch.ops import ntt as ntt_mod

    k_sel, n = x.shape[-2:]
    mod = tables.mod[sl]
    if inverse:
        pfn = (lambda: ntt_mod.backward_plain(x, tables.zetas_inv[sl],
                                              tables.ninv[sl], mod))
    else:
        pfn = lambda: ntt_mod.forward_plain(x, tables.omegas[sl], mod)  # noqa: E731
    direction = "inverse" if inverse else "forward"
    return (f"{direction} {label} {tuple(x.shape)}",
            lambda: ntt_mod.ntt_cuda(x, tables, sl, inverse), pfn,
            2 * x.numel() * 8 + 2 * k_sel * n * 8,
            x.numel() // n * ntt_ops(n, inverse))


def k2_case(label, scaler, x, start, size):
    """A run_cases item for K2 on x (..., k_in, n) into `size` rows."""
    k_in, n = x.shape[-2:]
    coeffs = x.numel() // k_in
    return (f"{label} {tuple(x.shape)} -> {size} limbs",
            lambda: scaler.scale_cuda(x, start, size),
            lambda: scaler.scale_plain(x, start, size),
            (x.numel() + coeffs * size) * x.element_size(),
            scale_ops(scaler, k_in, size, coeffs))


def ks_case(label, ctx, d, key, add0, add1):
    """A run_cases item for ks_accumulate on int64 or int32 (narrow) words:
    the digits and addends read once, the two outputs written once, the key
    read once (it stays in L2)."""
    from tpufhe_torch import pipeline

    k, n, digits = ctx.k, ctx.degree, d.shape[0]
    plane = d[0].numel()
    addends = sum(t is not None for t in (add0, add1))
    shoup = SHOUP32 if ctx.narrow else SHOUP
    return (f"{label} d {tuple(d.shape)} + {addends} addends -> "
            f"(2, {', '.join(map(str, d.shape[1:]))})",
            lambda: pipeline.ks_accumulate_cuda(ctx, d, key, add0, add1),
            lambda: pipeline.ks_accumulate_plain(ctx, d, key, add0, add1),
            (plane * (digits + addends + 2) + 4 * digits * k * n)
            * d.element_size(),
            plane * digits * 2 * shoup)


def k3_case(label, ctx_mul, ext):
    """A run_cases item for K3 on the (4, ..., k_mul, N) extended parts."""
    from tpufhe_torch import pipeline

    k_mul, n = ext.shape[-2:]
    rows = ext[0].numel() // (k_mul * n)
    return (f"{label} {tuple(ext.shape)} -> (3, {', '.join(map(str, ext.shape[1:]))})",
            lambda: pipeline.tensor_intt_cuda(ctx_mul, ext),
            lambda: pipeline.tensor_intt_plain(ctx_mul, ext),
            (7 * rows * k_mul * n + 2 * k_mul * n) * 8,
            rows * k_mul * (n * TENSOR_OPS + 3 * ntt_ops(n, True)))


def k7_case(label, ctx_mul, a0, a1, b0, b1):
    """A run_cases item for K7 on (..., k_mul, N) parts (b = a for the
    square, read once)."""
    from tpufhe_torch import pipeline

    words = a0.numel()
    reads = 2 if (b0 is a0 and b1 is a1) else 4
    return (f"{label} {tuple(a0.shape)} -> (3, {', '.join(map(str, a0.shape))})",
            lambda: pipeline.tensor_cuda(ctx_mul, a0, a1, b0, b1),
            lambda: pipeline.tensor_plain(ctx_mul, a0, a1, b0, b1),
            ((reads + 3) * words + 3 * ctx_mul.k) * 8, words * TENSOR_OPS)


def k4_case(label, ctx, dsc, key):
    """A run_cases item for K4 on (3, B, k, N) with a random Garner key."""
    from tpufhe_torch import pipeline

    b, k, n = dsc.shape[1:]
    return (f"{label} {tuple(dsc.shape)} + ksk 4 x {(k, k, n)} -> (2, {b}, {k}, {n})",
            lambda: pipeline.relin_tail_cuda(ctx, dsc, key),
            lambda: pipeline.relin_tail_plain(ctx, dsc, key),
            (5 * b * k * n + 4 * k * k * n + 2 * k * n) * 8,
            b * k * (k * ks_digit_ops(ctx) + 2 * ntt_ops(n, False)))


def k5_case(label, ctx, s0, c2, key):
    """A run_cases item for K5 on (B, k, N) s0 and c2 with a random Garner
    key."""
    from tpufhe_torch import pipeline

    b, k, n = s0.shape
    return (f"{label} s0, c2 {tuple(s0.shape)} + ksk 4 x {(k, k, n)} -> "
            f"(2, {b}, {k}, {n})",
            lambda: pipeline.rotate_tail_cuda(ctx, s0, c2, key),
            lambda: pipeline.rotate_tail_plain(ctx, s0, c2, key),
            (4 * b * k * n + 4 * k * k * n + 2 * k * n) * 8,
            b * k * k * ks_digit_ops(ctx))


# a tail's occupancy entry point: n, cluster, threads -> CTAs per SM, clusters
OCC_ARGS = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


def occupancy(fn, rows: int, n: int) -> dict:
    """A tail's launch plan at `rows` rows a cluster and degree n, with the
    CTAs one SM holds and the clusters the card holds at once, from the
    kernel's occupancy entry point `fn` (cudaOccupancyMax*)."""
    from tpufhe_torch import kernels

    cluster, threads, smem = kernels.tail_plan(rows, n)
    fn.argtypes, fn.restype = OCC_ARGS, ctypes.c_int
    blocks, clusters = ctypes.c_int(), ctypes.c_int()
    kernels.check(fn(n, cluster, threads, ctypes.byref(blocks),
                     ctypes.byref(clusters)), "occupancy")
    return {"cluster": cluster, "threads": threads, "smem_bytes": smem,
            "blocks_per_sm": blocks.value, "clusters": clusters.value}


def plan_record(kernel: str, n: int, inverse: bool = False,
                k_in: int = 0) -> dict:
    """K1's or K9's (per direction), K3's or K8's (k_in limbs) launch plan
    at degree n with the CTAs one SM holds and the clusters the card holds
    at once, from the kernel's occupancy entry point; logged."""
    from tpufhe_torch import kernels

    if kernel in ("ntt", "ntt32"):
        plan = kernels.ntt_plan if kernel == "ntt" else kernels.ntt32_plan
        cluster, threads, smem = plan(n)
        fn = kernels.function(kernel, f"tpufhe_{kernel}_occupancy", OCC_ARGS)
        first = int(inverse)
        label = f"{kernel} n={n} {'inverse' if inverse else 'forward'}"
    elif kernel == "intt_scale":
        cluster, threads, smem = kernels.intt_scale_plan(k_in, n)
        fn = kernels.function(kernel, "tpufhe_intt_scale_occupancy",
                              OCC_ARGS)
        first = k_in
        label = f"intt_scale k_in={k_in} n={n}"
    else:
        cluster, threads, smem = kernels.tensor_intt_plan(n)
        fn = kernels.function("tensor_intt", "tpufhe_tensor_intt_occupancy",
                              OCC_ARGS)
        first = cluster
        label = f"tensor_intt n={n}"
    fn.argtypes, fn.restype = OCC_ARGS, ctypes.c_int
    blocks, clusters = ctypes.c_int(), ctypes.c_int()
    args = (first, n) if kernel == "intt_scale" else (n, first)
    kernels.check(fn(*args, threads, ctypes.byref(blocks),
                     ctypes.byref(clusters)), "occupancy")
    rec = {"cluster": cluster, "threads": threads, "smem_bytes": smem,
           "blocks_per_sm": blocks.value, "clusters": clusters.value}
    log(f"  plan {label}: cluster {cluster} x {threads} threads, {smem} "
        f"shared bytes, {blocks.value} CTAs per SM, {clusters.value} "
        f"clusters at once")
    return rec


def ntt_plans(n: int) -> dict:
    """K1's plan at degree n in both directions."""
    return {d: plan_record("ntt", n, d == "inverse")
            for d in ("forward", "inverse")}


def ks_digit_ops(ctx) -> int:
    """int32 multiplies of one digit row of a tail: its forward transform and
    two Shoup products per coefficient, and its reduce_u64 (two low and two
    high products a word) where a limb of c2 can reach 4 p_j (the kernel
    transforms words below 4 p_j unreduced; with moduli within a factor 4
    of each other none can)."""
    n = ctx.degree
    reduce = any(p_i >= 4 * p_j for p_i in ctx.moduli for p_j in ctx.moduli)
    return n * (2 * (LO + HI) * reduce + 2 * SHOUP) + ntt_ops(n, False)


def check_tails(ctxs, gen, int32_rate: float) -> dict:
    """Phase 3, K4 and K5 against their plain versions with random keys:
    K4 at the N = 8192, 3 x 62-bit batch-64 mul+relin (3, 64, 3, 8192),
    phase 13's 8 x 62-bit (3, 16, 8, 8192) and BASELINE config 2's ring
    (3, 8, 2, 4096); K5 at the batch-32 rotation (32, 4, 8192) and at
    (8, 2, 4096). Each record carries the unfused composition's time on
    the same inputs (relin_tail_unfused / rotate_tail_unfused: K1 forward
    of the stacked rows, ks_accumulate and the glue) and the kernel's
    occupancy. Returns {label: record}; "relin_tail" and "rotate_tail" are
    the main shapes."""
    from tpufhe_torch import kernels, pipeline

    out = {}
    for label, ctx, batch in (("relin_tail", ctxs["main"], BATCH),
                              ("relin_tail_8x62", ctxs["8x62"], WIDER_BATCH),
                              ("relin_tail_n4096", ctxs["n4096"], 8)):
        k, n = ctx.k, ctx.degree
        dsc = rand_residues((3, batch, k, n), ctx.tables.p, gen)
        key = random_key(ctx, gen)
        rec = run_cases("relin_tail", [
            (f"{tuple(dsc.shape)} + ksk 4 x {(k, k, n)} -> (2, {batch}, {k}, {n})",
             lambda ctx=ctx, dsc=dsc, key=key: pipeline.relin_tail_cuda(ctx, dsc, key),
             lambda ctx=ctx, dsc=dsc, key=key: pipeline.relin_tail_plain(ctx, dsc, key),
             (5 * batch * k * n + 4 * k * k * n + 2 * k * n) * 8,
             batch * k * (k * ks_digit_ops(ctx) + 2 * ntt_ops(n, False)))],
            int32_rate, "per call")
        rec["unfused_ms"] = time_ms(
            lambda: pipeline.relin_tail_unfused(ctx, dsc, key), 20)
        out[label] = rec | occupancy(kernels.function(
            "relin_tail", "tpufhe_relin_tail_occupancy", OCC_ARGS), k + 2, n)
    for label, ctx, batch in (("rotate_tail", ctxs["rot"], ROT_BATCH),
                              ("rotate_tail_n4096", ctxs["n4096"], 8)):
        k, n = ctx.k, ctx.degree
        s0 = rand_residues((batch, k, n), ctx.tables.p, gen)
        c2 = rand_residues((batch, k, n), ctx.tables.p, gen)
        key = random_key(ctx, gen)
        rec = run_cases("rotate_tail", [
            (f"s0, c2 {tuple(s0.shape)} + ksk 4 x {(k, k, n)} -> "
             f"(2, {batch}, {k}, {n})",
             lambda ctx=ctx, s0=s0, c2=c2, key=key:
                 pipeline.rotate_tail_cuda(ctx, s0, c2, key),
             lambda ctx=ctx, s0=s0, c2=c2, key=key:
                 pipeline.rotate_tail_plain(ctx, s0, c2, key),
             (4 * batch * k * n + 4 * k * k * n + 2 * k * n) * 8,
             batch * k * k * ks_digit_ops(ctx))], int32_rate, "per call")
        rec["unfused_ms"] = time_ms(
            lambda: pipeline.rotate_tail_unfused(ctx, s0, c2, key), 20)
        out[label] = rec | occupancy(kernels.function(
            "rotate_tail", "tpufhe_rotate_tail_occupancy", OCC_ARGS), k, n)
    for label, r in out.items():
        log(f"  {label}: unfused {r['unfused_ms']:.4f} ms; cluster "
            f"{r['cluster']} x {r['threads']} threads, {r['smem_bytes']} "
            f"shared bytes, {r['blocks_per_sm']} CTAs per SM, "
            f"{r['clusters']} clusters at once")
    return out


def check_side_kernels(par_rot, par_4096, gen, int32_rate: float) -> dict:
    """Phase 3, the rotation's inverse NTT at the batch-32 rotation shapes,
    K1 at BASELINE config 2's ring (8, 2, 4096) and at N = 16 and 512
    (k = 3, 4 rows), forward and inverse. Returns {label: case record}."""
    from tpufhe_torch.bfv import BfvParametersBuilder
    from tpufhe_torch.ops import ntt as ntt_mod
    from tpufhe_torch.ops.rq import Context

    out = {}
    ctx = par_rot.context_at_level(0)
    k, n = ctx.k, ctx.degree
    tb = ctx.tables
    s0 = rand_residues((ROT_BATCH, k, n), tb.p, gen)
    out["ntt_rotation"] = run_case(
        "ntt", f"inverse {tuple(s0.shape)} (rotation)",
        lambda: ntt_mod.ntt_cuda(s0, tb, slice(None), True),
        lambda: ntt_mod.backward_plain(s0, tb.zetas_inv, tb.ninv, tb.mod),
        int32_rate, 2 * s0.numel() * 8 + 2 * k * n * 8,
        ROT_BATCH * k * ntt_ops(n, True))
    t4096 = par_4096.context_at_level(0).tables
    x4096 = rand_residues((8, 2, TAIL_N4096), t4096.p, gen)
    plans = ntt_plans(TAIL_N4096)
    for inverse in (False, True):
        label, kfn, pfn, nbytes, ops = k1_case("N = 4096", x4096, t4096,
                                               slice(None), inverse)
        out[f"ntt_4096_{'inverse' if inverse else 'forward'}"] = run_case(
            "ntt", label, kfn, pfn, int32_rate, nbytes, ops) | {"plan": plans}
    for small in (16, 512):
        moduli = BfvParametersBuilder.generate_moduli([62] * 3, small)
        t_small = Context(moduli, small).tables
        x = rand_residues((4, 3, small), t_small.p, gen)
        plans = ntt_plans(small)
        for inverse in (False, True):
            direction = "inverse" if inverse else "forward"
            if inverse:
                pfn = (lambda x=x, t=t_small: ntt_mod.backward_plain(
                    x, t.zetas_inv, t.ninv, t.mod))
            else:
                pfn = (lambda x=x, t=t_small: ntt_mod.forward_plain(
                    x, t.omegas, t.mod))
            out[f"ntt_{small}_{direction}"] = run_case(
                "ntt", f"{direction} {tuple(x.shape)}",
                lambda x=x, t=t_small, inv=inverse: ntt_mod.ntt_cuda(
                    x, t, slice(None), inv),
                pfn, int32_rate, 2 * x.numel() * 8 + 2 * 3 * small * 8,
                4 * 3 * ntt_ops(small, inverse)) | {"plan": plans}
    for label, r in out.items():
        log(f"  {label}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    return out


def check_kernels(par, gen, int32_rate: float) -> dict:
    """Phase 3: every mul+relin kernel against its plain version at
    main-path shapes. Returns {name: record} with per-mul+relin times and
    bounds."""
    from tpufhe_torch import pipeline
    from tpufhe_torch.ops import ntt as ntt_mod

    ctx = par.context_at_level(0)
    mp = par.context_level_at(0).mul_params()
    ctx_mul = mp.to_ctx
    k, k_mul, n = ctx.k, ctx_mul.k, ctx.degree
    cases = {}  # name -> list of (label, kernel_fn, plain_fn, bytes, ops)

    # K1: extend iNTT over the 4 x B input parts; forward NTT of new limbs
    t_ctx, t_mul = ctx.tables, ctx_mul.tables
    x_inv = rand_residues((4 * BATCH, k, n), t_ctx.p, gen)
    x_fwd = rand_residues((4 * BATCH, k_mul - k, n), t_mul.p[k:], gen)
    sl = slice(k, k_mul)
    cases["ntt"] = [
        (f"inverse {tuple(x_inv.shape)}",
         lambda: ntt_mod.ntt_cuda(x_inv, t_ctx, slice(None), True),
         lambda: ntt_mod.backward_plain(x_inv, t_ctx.zetas_inv, t_ctx.ninv,
                                        t_ctx.mod),
         2 * x_inv.numel() * 8 + 2 * k * n * 8,
         4 * BATCH * k * ntt_ops(n, True)),
        (f"forward limbs {k}..{k_mul} {tuple(x_fwd.shape)}",
         lambda: ntt_mod.ntt_cuda(x_fwd, t_mul, sl, False),
         lambda: ntt_mod.forward_plain(x_fwd, t_mul.omegas[sl], t_mul.mod[sl]),
         2 * x_fwd.numel() * 8 + 2 * (k_mul - k) * n * 8,
         4 * BATCH * (k_mul - k) * ntt_ops(n, False)),
    ]

    # K2: extend (factor 1) and the t/q down-scale
    ext_rns = mp.extender.rns_scaler
    down_rns = mp.down_scaler.rns_scaler
    s_ext = rand_residues((4, BATCH, k, n), t_ctx.p, gen)
    s_down = rand_residues((3, BATCH, k_mul, n), t_mul.p, gen)

    cases["rns_scale"] = [k2_case("extend", ext_rns, s_ext, k, k_mul - k),
                          k2_case("down", down_rns, s_down, 0, k)]

    # K3: tensor + iNTT over the multiplication basis
    ext = rand_residues((4, BATCH, k_mul, n), t_mul.p, gen)
    cases["tensor_intt"] = [
        (f"{tuple(ext.shape)} -> (3, {BATCH}, {k_mul}, {n})",
         lambda: pipeline.tensor_intt_cuda(ctx_mul, ext),
         lambda: pipeline.tensor_intt_plain(ctx_mul, ext),
         (7 * BATCH * k_mul * n + 2 * k_mul * n) * 8,
         BATCH * k_mul * (n * TENSOR_OPS + 3 * ntt_ops(n, True))),
    ]

    out = {name: run_cases(name, items, int32_rate, "per mul+relin")
           for name, items in cases.items()}
    out["ntt"]["plan"] = ntt_plans(n)
    out["tensor_intt"]["plan"] = plan_record("tensor_intt", n)
    return out


def run_cases(name, items, int32_rate, per: str) -> dict:
    """run_case over (label, kernel_fn, plain_fn, bytes, ops) items whose
    launches make up one step; returns the step's record (times and bound
    summed over the items)."""
    runs = [run_case(name, label, kfn, pfn, int32_rate, nbytes, ops)
            for label, kfn, pfn, nbytes, ops in items]
    bound = Bound(int32_rate)
    for r in runs:
        bound.add(r["bytes"], r["int32_muls"])
    bound_ms, bound_by = bound.result()
    rec = {"ms": sum(r["ms"] for r in runs),
           "item_ms": [r["ms"] for r in runs],
           "plain_ms": sum(r["plain_ms"] for r in runs),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "max_abs_err": max(r["max_abs_err"] for r in runs),
           "shapes": [r["label"] for r in runs],
           "bytes": bound.bytes, "int32_muls": bound.ops}
    log(f"  {name}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}) {per}")
    return rec


def check_variant_kernels(par, gen, int32_rate: float) -> dict:
    """Phase 3, the kernels of strategy 2, the fused extend and the square
    at their program shapes (N = 8192, L = 3, batch 64): tensor (K7) on the
    square's (a0, a1, a0, a1), intt_scale (K8) at the default fused extend
    and at the kP = 2 fused extend (lhs and rhs), rns_scale at the kP = 2
    split step's three scalings and tensor_intt at kP = 1 and 2. Returns
    {label: record of one step's launches}."""
    from tpufhe_torch import pipeline
    from tpufhe_torch.ops import ntt as ntt_mod
    from tpufhe_torch.ops.intt_scale import intt_scale_cuda, intt_scale_plain

    ctx = par.context_at_level(0)
    k, n = ctx.k, ctx.degree
    t_ctx = ctx.tables
    mb = pipeline.mul_basis(par)
    s2 = {kp: pipeline.mul_basis(par, strategy2_primes=kp) for kp in (1, 2)}
    out = {}

    # K7: the square's tensor over the 7-limb basis
    t_mul = mb.ctx_mul.tables
    k_mul = mb.ctx_mul.k
    a0 = rand_residues((BATCH, k_mul, n), t_mul.p, gen)
    a1 = rand_residues((BATCH, k_mul, n), t_mul.p, gen)
    out["tensor"] = run_cases("tensor", [
        (f"square (a0, a1, a0, a1) {tuple(a0.shape)} -> (3, {BATCH}, {k_mul}, {n})",
         lambda: pipeline.tensor_cuda(mb.ctx_mul, a0, a1, a0, a1),
         lambda: pipeline.tensor_plain(mb.ctx_mul, a0, a1, a0, a1),
         (5 * BATCH * k_mul * n + 3 * k_mul) * 8,
         BATCH * k_mul * n * TENSOR_OPS)], int32_rate, "per square")

    # K8: the fused extends; each row reads k limbs and the k inverse
    # twiddle tables, and writes `size` limbs
    def k8(label, scaler, x, start, size):
        rows = x.numel() // (k * n)
        return (f"{label} {tuple(x.shape)} -> {size} limbs",
                lambda: intt_scale_cuda(ctx, scaler, x, start, size),
                lambda: intt_scale_plain(ctx, scaler, x, start, size),
                (x.numel() + rows * size * n + 2 * k * n) * 8,
                rows * k * ntt_ops(n, True) + scale_ops(scaler, k, size, rows * n))

    def split_ms(pairs) -> float:
        """Time of the K1 inverse + K2 launches that K8 replaces."""
        def run():
            for scaler, x, start, size in pairs:
                scaler.scale_cuda(ntt_mod.ntt_cuda(x, t_ctx, slice(None), True),
                                  start, size)
        return time_ms(run, 20)

    x4 = rand_residues((4, BATCH, k, n), t_ctx.p, gen)
    out["intt_scale"] = run_cases("intt_scale", [
        k8("default extend", mb.ext, x4, k, k_mul - k)], int32_rate,
        "per default fused mul+relin")
    out["intt_scale"]["split_ms"] = split_ms([(mb.ext, x4, k, k_mul - k)])
    k2 = s2[2].ctx_mul.k
    out["intt_scale_s2"] = run_cases("intt_scale", [
        k8("kP=2 lhs extend", s2[2].ext, x4[:2], k, k2 - k),
        k8("kP=2 rhs P/q", s2[2].rhs, x4[2:], 0, k2)], int32_rate,
        "per kP=2 fused mul+relin")
    out["intt_scale_s2"]["split_ms"] = split_ms(
        [(s2[2].ext, x4[:2], k, k2 - k), (s2[2].rhs, x4[2:], 0, k2)])
    for key in ("intt_scale", "intt_scale_s2"):
        log(f"  {key}: the split K1 inverse + K2 launches it replaces "
            f"{out[key]['split_ms']:.4f} ms")
        out[key]["plan"] = plan_record("intt_scale", n, k_in=k)
    # K8's general instance (k_in past the fixed 3, more limbs than CTAs):
    # 12 x 62-bit at N = 1024 extended by one limb
    from tpufhe_torch.bfv import BfvParametersBuilder
    from tpufhe_torch.ops.rns import ScalingFactor
    from tpufhe_torch.ops.rq import Context, Scaler

    g_basis = BfvParametersBuilder.generate_moduli([62] * 13, 1024)
    g_ctx, g_mul = Context(g_basis[:12], 1024), Context(g_basis, 1024)
    g_scaler = Scaler(g_ctx, g_mul, ScalingFactor.one()).rns_scaler
    g_x = rand_residues((BATCH, 12, 1024), g_ctx.tables.p, gen)
    out["intt_scale_general"] = run_case(
        "intt_scale", f"general k_in=12 {tuple(g_x.shape)} -> 1 limb",
        lambda: intt_scale_cuda(g_ctx, g_scaler, g_x, 12, 1),
        lambda: intt_scale_plain(g_ctx, g_scaler, g_x, 12, 1), int32_rate,
        (g_x.numel() + BATCH * 1024 + 2 * 12 * 1024) * 8,
        BATCH * 12 * ntt_ops(1024, True) + scale_ops(g_scaler, 12, 1,
                                                     BATCH * 1024))
    out["intt_scale_general"]["plan"] = plan_record("intt_scale", 1024,
                                                    k_in=12)

    # K2 at the kP = 2 split step: lhs extend, rhs P/q, t/P down-scale
    t2 = s2[2].ctx_mul.tables
    x_pb = rand_residues((4, BATCH, k, n), t_ctx.p, gen)
    down = rand_residues((3, BATCH, k2, n), t2.p, gen)
    lhs, rhs = x_pb[:2], x_pb[2:]
    out["rns_scale_s2"] = run_cases("rns_scale", [
        k2_case("kP=2 lhs extend", s2[2].ext, lhs, k, k2 - k),
        k2_case("kP=2 rhs P/q", s2[2].rhs, rhs, 0, k2),
        k2_case("kP=2 down t/P", s2[2].down, down, 0, k),
    ], int32_rate, "per kP=2 split mul+relin")

    # K3 over the strategy-2 bases
    for kp in (1, 2):
        cm = s2[kp].ctx_mul
        ext = rand_residues((4, BATCH, cm.k, n), cm.tables.p, gen)
        out[f"tensor_intt_s2_kp{kp}"] = run_cases("tensor_intt", [
            (f"kP={kp} {tuple(ext.shape)} -> (3, {BATCH}, {cm.k}, {n})",
             lambda cm=cm, ext=ext: pipeline.tensor_intt_cuda(cm, ext),
             lambda cm=cm, ext=ext: pipeline.tensor_intt_plain(cm, ext),
             (7 * BATCH * cm.k * n + 2 * cm.k * n) * 8,
             BATCH * cm.k * (n * TENSOR_OPS + 3 * ntt_ops(n, True)))],
            int32_rate, f"per kP={kp} mul+relin")
    return out


def check_narrow_kernels(par, gen, int32_rate: float) -> dict:
    """Phase 3, the narrow (w30) path's kernels at its shapes (N = 8192,
    7 x 30-bit, batch 64, int32 rows): K9 at the four transforms of a
    mul+relin step (the extend's inverse over the 4 parts, the forward of
    the 9 new limbs with limb_slice 7..16, the inverse of the 3 tensor
    parts over the 16-limb basis, the tail's forward of 2 + 7 stacked
    parts), at a rotation's two (batch 32) and at N = 512, where tpufhe
    runs its K9; K2 on int32 rows at the extend (7 -> 9 new limbs) and the
    down-scale (16 -> 7); ks_accumulate on int32 rows with the relin tail's
    two addends (batch 64) and the rotation's one (batch 32). Returns
    {label: record}."""
    from tpufhe_torch.bfv import BfvParametersBuilder
    from tpufhe_torch.ops import ntt as ntt_mod
    from tpufhe_torch.ops.rq import Context

    ctx = par.context_at_level(0)
    mp = par.context_level_at(0).mul_params()
    ctx_mul = mp.to_ctx
    k, k_mul, n = ctx.k, ctx_mul.k, ctx.degree
    t_ctx, t_mul = ctx.tables, ctx_mul.tables

    def k9(label, x, tables, sl, inverse):
        k_sel, nn = x.shape[-2:]
        if inverse:
            pfn = (lambda: ntt_mod.backward32_plain(
                x, tables.zetas_inv[sl], tables.ninv[sl], tables.p[sl]))
        else:
            pfn = (lambda: ntt_mod.forward32_plain(
                x, tables.omegas[sl], tables.p[sl]))
        direction = "inverse" if inverse else "forward"
        return (f"{direction} {label} {tuple(x.shape)}",
                lambda: ntt_mod.ntt32_cuda(x, tables, sl, inverse), pfn,
                2 * x.numel() * 4 + 2 * k_sel * nn * 4,
                x.numel() // nn * ntt_ops(nn, inverse, SHOUP32))

    full, new = slice(None), slice(k, k_mul)
    out = {}
    out["ntt32"] = run_cases("ntt32", [
        k9("extend", rand_residues((4, BATCH, k, n), t_ctx.p, gen), t_ctx,
           full, True),
        k9(f"new limbs {k}..{k_mul}",
           rand_residues((4, BATCH, k_mul - k, n), t_mul.p[new], gen), t_mul,
           new, False),
        k9("tensor parts", rand_residues((3, BATCH, k_mul, n), t_mul.p, gen),
           t_mul, full, True),
        k9("tail", rand_residues((2 + k, BATCH, k, n), t_ctx.p, gen), t_ctx,
           full, False),
    ], int32_rate, "per narrow mul+relin")
    out["ntt32"]["plan"] = {d: plan_record("ntt32", n, d == "inverse")
                            for d in ("forward", "inverse")}
    out["ntt32_rotation"] = run_cases("ntt32", [
        k9("rotation c1", rand_residues((ROT_BATCH, k, n), t_ctx.p, gen),
           t_ctx, full, True),
        k9("rotation digits", rand_residues((k, ROT_BATCH, k, n), t_ctx.p, gen),
           t_ctx, full, False),
    ], int32_rate, "per narrow rotation")
    moduli = BfvParametersBuilder.generate_moduli([30] * 3, 512)
    t512 = Context(moduli, 512, narrow=True).tables
    for inverse in (False, True):
        x = rand_residues((4, 3, 512), t512.p, gen)
        label, kfn, pfn, nbytes, ops = k9("N = 512", x, t512, full, inverse)
        out[f"ntt32_512_{'inverse' if inverse else 'forward'}"] = run_case(
            "ntt32", label, kfn, pfn, int32_rate, nbytes, ops)

    ext, down = mp.extender.rns_scaler, mp.down_scaler.rns_scaler
    s_ext = rand_residues((4, BATCH, k, n), t_ctx.p, gen)
    s_down = rand_residues((3, BATCH, k_mul, n), t_mul.p, gen)
    out["rns_scale_int32"] = run_cases("rns_scale", [
        k2_case("int32 extend", ext, s_ext, k, k_mul - k),
        k2_case("int32 down", down, s_down, 0, k),
    ], int32_rate, "per narrow mul+relin")
    key = random_key(ctx, gen)
    for name, batch, addends in (("", BATCH, 2), ("_rotation", ROT_BATCH, 1)):
        d = rand_residues((k, batch, k, n), t_ctx.p, gen)
        adds = [rand_residues((batch, k, n), t_ctx.p, gen)
                for _ in range(addends)] + [None] * (2 - addends)
        out[f"ks_accumulate_int32{name}"] = run_cases("ks_accumulate", [
            ks_case(f"int32{name.replace('_', ' ')}", ctx, d, key, *adds)],
            int32_rate, f"per narrow {'rotation' if name else 'mul+relin'}")
    for label in ("ntt32_512_forward", "ntt32_512_inverse"):
        r = out[label]
        log(f"  {label}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    return out


def check_n16k_kernels(par, gen, int32_rate: float) -> dict:
    """Phase 3, the kernels of the N = 16384, 6 x 62-bit programs at batch
    16, on the unfused route (no K3, K4, K5): K1 at a mul+relin's four
    transforms (the extend's inverse, the forward of the 7 new limbs, the
    inverse of the 3 tensor parts over the 13-limb basis, the tail's
    forward of 2 + 6 stacked parts) and at a rotation's two, K2 at the
    extend (6 -> 7 new limbs) and the down-scale (13 -> 6), K7 over the
    13-limb basis, ks_accumulate with the relin tail's two addends and with
    the rotation's one. Returns {label: record of one step's launches}."""
    from tpufhe_torch import pipeline

    ctx = par.context_at_level(0)
    mp = par.context_level_at(0).mul_params()
    ctx_mul = mp.to_ctx
    k, k_mul, n, b = ctx.k, ctx_mul.k, ctx.degree, N16K_BATCH
    t_ctx, t_mul = ctx.tables, ctx_mul.tables
    full, new = slice(None), slice(k, k_mul)
    out = {}
    out["ntt"] = run_cases("ntt", [
        k1_case("extend", rand_residues((4, b, k, n), t_ctx.p, gen), t_ctx,
                full, True),
        k1_case(f"new limbs {k}..{k_mul}",
                rand_residues((4, b, k_mul - k, n), t_mul.p[new], gen), t_mul,
                new, False),
        k1_case("tensor parts", rand_residues((3, b, k_mul, n), t_mul.p, gen),
                t_mul, full, True),
        k1_case("tail", rand_residues((2 + k, b, k, n), t_ctx.p, gen), t_ctx,
                full, False),
    ], int32_rate, "per N = 16384 mul+relin")
    out["ntt_rotation"] = run_cases("ntt", [
        k1_case("rotation c1", rand_residues((b, k, n), t_ctx.p, gen), t_ctx,
                full, True),
        k1_case("rotation digits", rand_residues((k, b, k, n), t_ctx.p, gen),
                t_ctx, full, False),
    ], int32_rate, "per N = 16384 rotation")
    out["ntt"]["plan"] = out["ntt_rotation"]["plan"] = ntt_plans(n)
    out["rns_scale"] = run_cases("rns_scale", [
        k2_case("N = 16384 extend", mp.extender.rns_scaler,
                rand_residues((4, b, k, n), t_ctx.p, gen), k, k_mul - k),
        k2_case("N = 16384 down", mp.down_scaler.rns_scaler,
                rand_residues((3, b, k_mul, n), t_mul.p, gen), 0, k),
    ], int32_rate, "per N = 16384 mul+relin")
    ops = [rand_residues((b, k_mul, n), t_mul.p, gen) for _ in range(4)]
    out["tensor"] = run_cases("tensor", [
        (f"{tuple(ops[0].shape)} x 4 -> (3, {b}, {k_mul}, {n})",
         lambda: pipeline.tensor_cuda(ctx_mul, *ops),
         lambda: pipeline.tensor_plain(ctx_mul, *ops),
         (7 * b * k_mul * n + 3 * k_mul) * 8, b * k_mul * n * TENSOR_OPS)],
        int32_rate, "per N = 16384 mul+relin")
    key = random_key(ctx, gen)
    d = rand_residues((k, b, k, n), t_ctx.p, gen)
    a0 = rand_residues((b, k, n), t_ctx.p, gen)
    a1 = rand_residues((b, k, n), t_ctx.p, gen)
    out["ks_accumulate"] = run_cases("ks_accumulate", [
        ks_case("relin", ctx, d, key, a0, a1)], int32_rate,
        "per N = 16384 mul+relin")
    out["ks_accumulate_rotation"] = run_cases("ks_accumulate", [
        ks_case("rotation", ctx, d, key, a0, None)], int32_rate,
        "per N = 16384 rotation")
    return out


def check_wider_kernels(pars, gen, int32_rate: float) -> dict:
    """Phase 3, K2 on the multiplication bases above 16 limbs at N = 8192,
    batch 16 (phase 13's sets): the extend (fixed instances) and the
    down-scale from 17 limbs (8 x 62-bit, int64 rows) and from 18 (8 x 30
    narrow, int32 rows), the general instance. Returns {label: record}."""
    out = {}
    for (label, _, _), par in zip(WIDER_SETS, pars):
        ctx = par.context_at_level(0)
        mp = par.context_level_at(0).mul_params()
        k, k_mul, n = ctx.k, mp.to_ctx.k, ctx.degree
        out[label] = run_cases("rns_scale", [
            k2_case(f"{label} extend", mp.extender.rns_scaler,
                    rand_residues((4, WIDER_BATCH, k, n), ctx.tables.p, gen),
                    k, k_mul - k),
            k2_case(f"{label} down", mp.down_scaler.rns_scaler,
                    rand_residues((3, WIDER_BATCH, k_mul, n),
                                  mp.to_ctx.tables.p, gen), 0, k),
        ], int32_rate, f"per {label} mul+relin")
    return out


def main_path(par) -> SimpleNamespace:
    """Phase 4. Returns the keys, values, inputs, the step, its launch
    counts and output."""
    from tpufhe_torch.bfv import (
        Ciphertext,
        Encoding,
        Plaintext,
        RelinearizationKey,
        SecretKey,
    )
    from tpufhe_torch.pipeline import make_mul_relin
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

    t = par.plaintext.value
    rng = ChaCha8Rng(seed_from_u64(SEED))
    t0 = time.perf_counter()
    sk = SecretKey.random(par, rng)
    rk = RelinearizationKey.new(sk, rng)
    torch.cuda.synchronize()
    log(f"  keygen (sk + rk) {time.perf_counter() - t0:.2f} s")

    vals = np.random.default_rng(SEED)
    va = vals.integers(0, t, (BATCH, par.degree()), dtype=np.uint64)
    vb = vals.integers(0, t, (BATCH, par.degree()), dtype=np.uint64)
    t0 = time.perf_counter()
    cas = [sk.try_encrypt(Plaintext.try_encode(v, Encoding.simd(), par), rng)
           for v in va]
    cbs = [sk.try_encrypt(Plaintext.try_encode(v, Encoding.simd(), par), rng)
           for v in vb]
    torch.cuda.synchronize()
    log(f"  SIMD encode + encrypt {2 * BATCH} ciphertexts "
        f"{time.perf_counter() - t0:.2f} s")
    a0, a1, b0, b1 = (torch.stack([c[i] for c in cs])
                      for cs in (cas, cbs) for i in (0, 1))

    step = make_mul_relin(par, rk)
    (c0, c1), launches = run_program(f"mul+relin of {BATCH} pairs", step,
                                     (a0, a1, b0, b1), MUL_LAUNCHES)

    ctx = par.context_at_level(0)
    if tuple(c0.shape) != (BATCH, ctx.k, par.degree()):
        raise SystemExit(f"unexpected output shape {tuple(c0.shape)}")
    p = ctx.tables.p[:, None]
    if not bool(((c0 >= 0) & (c0 < p) & (c1 >= 0) & (c1 < p)).all()):
        raise SystemExit("output residues are not canonical")

    t0 = time.perf_counter()
    bad = 0
    for i in range(BATCH):
        ct = Ciphertext(par, [c0[i], c1[i]], 0)
        got = sk.try_decrypt(ct).try_decode(Encoding.simd())
        want = (va[i].astype(object) * vb[i].astype(object)) % t
        bad += int((got != want.astype(np.uint64)).sum())
    log(f"  decrypt + decode {BATCH} products {time.perf_counter() - t0:.2f} s, "
        f"wrong slots {bad}")
    if bad:
        raise SystemExit(f"{bad} slots decrypted wrong")
    fresh = sk.measure_noise(cas[0])
    prod = sk.measure_noise(Ciphertext(par, [c0[0], c1[0]], 0))
    log(f"  noise: fresh {fresh} bits, product {prod} bits")
    if prod >= sum(MODULI_SIZES) - 18:
        raise SystemExit("product noise leaves no budget")
    return SimpleNamespace(sk=sk, rk=rk, va=va, vb=vb,
                           inputs=(a0, a1, b0, b1), step=step,
                           launches=launches, product=(c0, c1),
                           margin=sum(MODULI_SIZES) - prod)


def run_program(name: str, fn, args, expected: dict):
    """Run one program with the launch counters set to 0 just before it;
    fails unless the counts equal `expected` (kernel -> launches; the
    others 0). Returns (outputs, launches)."""
    from tpufhe_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    log(f"  {name} (first call) {secs:.3f} s, launches {launches}")
    if launches != expected:
        raise SystemExit(f"{name}: launches {launches}, expected {expected}")
    return out, launches


def check_outputs(name, par, sk, c0, c1, want, encoding) -> None:
    """Every output canonical, every slot of every decryption equal to
    `want` (same leading shape as c0 without the (k, N) tail)."""
    from tpufhe_torch.bfv import Ciphertext

    p = par.context_at_level(0).tables.p[:, None]
    if not bool(((c0 >= 0) & (c0 < p) & (c1 >= 0) & (c1 < p)).all()):
        raise SystemExit(f"{name}: output residues are not canonical")
    flat0 = c0.reshape(-1, *c0.shape[-2:])
    flat1 = c1.reshape(-1, *c1.shape[-2:])
    want = want.reshape(flat0.shape[0], -1)
    bad = 0
    for i in range(flat0.shape[0]):
        ct = Ciphertext(par, [flat0[i], flat1[i]], 0)
        bad += int((sk.try_decrypt(ct).try_decode(encoding) != want[i]).sum())
    log(f"  {name}: {flat0.shape[0]} ciphertexts decrypted, wrong slots {bad}, "
        f"noise {sk.measure_noise(Ciphertext(par, [flat0[0], flat1[0]], 0))} bits")
    if bad:
        raise SystemExit(f"{name}: {bad} slots decrypted wrong")


def rotation_path(par) -> dict:
    """Phase 6. Returns {program: (launches, step, inputs)}."""
    from tpufhe_torch.bfv import (
        Encoding,
        EvaluationKeyBuilder,
        Plaintext,
        SecretKey,
    )
    from tpufhe_torch.pipeline import make_expand, make_inner_sum, make_rotate
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

    t, n = par.plaintext.value, par.degree()
    rng = ChaCha8Rng(seed_from_u64(SEED + 1))
    t0 = time.perf_counter()
    sk = SecretKey.random(par, rng)
    ek = (EvaluationKeyBuilder(sk).enable_inner_sum()
          .enable_expansion(EXPAND_LEVEL).build(rng))
    torch.cuda.synchronize()
    log(f"  keygen (sk + {len(ek.gk)} Galois keys) "
        f"{time.perf_counter() - t0:.2f} s")

    vals = np.random.default_rng(SEED + 1)
    simd = vals.integers(0, t, (ROT_BATCH, n), dtype=np.uint64)
    poly = np.zeros((EXPAND_BATCH, n), dtype=np.uint64)
    size = 1 << EXPAND_LEVEL
    poly[:, :size] = vals.integers(0, t, (EXPAND_BATCH, size), dtype=np.uint64)
    t0 = time.perf_counter()
    cs = [sk.try_encrypt(Plaintext.try_encode(v, Encoding.simd(), par), rng)
          for v in simd]
    cp = [sk.try_encrypt(Plaintext.try_encode(v, Encoding.poly(), par), rng)
          for v in poly]
    torch.cuda.synchronize()
    log(f"  encode + encrypt {ROT_BATCH} SIMD and {EXPAND_BATCH} poly "
        f"ciphertexts {time.perf_counter() - t0:.2f} s")
    log(f"  noise: fresh {sk.measure_noise(cs[0])} bits")
    s0, s1 = (torch.stack([c[i] for c in cs]) for i in (0, 1))
    p0, p1 = (torch.stack([c[i] for c in cp]) for i in (0, 1))

    out = {}
    rot = make_rotate(par, ek.gk[ek.rot_to_gk_exponent[1]])
    (c0, c1), launches = run_program(
        f"rotate columns by 1, batch {ROT_BATCH}", rot, (s0, s1),
        {"ntt": 1, "rotate_tail": 1})
    h = n // 2
    want = np.concatenate([np.roll(simd[:, :h], -1, axis=1),
                           np.roll(simd[:, h:], -1, axis=1)], axis=1)
    check_outputs("rotation", par, sk, c0, c1, want, Encoding.simd())
    out["rotate"] = (launches, rot, (s0, s1))

    inner = make_inner_sum(par, ek)
    a0, a1 = s0[:SUM_BATCH].contiguous(), s1[:SUM_BATCH].contiguous()
    rots = n.bit_length() - 1  # log2(N / 2) column rotations + the row one
    (c0, c1), launches = run_program(
        f"inner sum, batch {SUM_BATCH}", inner, (a0, a1),
        {"ntt": rots, "rotate_tail": rots})
    sums = simd[:SUM_BATCH].astype(object).sum(axis=1) % t
    want = np.repeat(sums.astype(np.uint64)[:, None], n, axis=1)
    check_outputs("inner sum", par, sk, c0, c1, want, Encoding.simd())
    out["inner_sum"] = (launches, inner, (a0, a1))

    expand = make_expand(par, ek, EXPAND_LEVEL)
    (c0, c1), launches = run_program(
        f"expand to {size}, batch {EXPAND_BATCH}", expand, (p0, p1),
        {"ntt": EXPAND_LEVEL, "rotate_tail": EXPAND_LEVEL})
    if tuple(c0.shape) != (size, EXPAND_BATCH, par.context_at_level(0).k, n):
        raise SystemExit(f"expansion: unexpected shape {tuple(c0.shape)}")
    want = np.zeros((size, EXPAND_BATCH, n), dtype=np.uint64)
    want[:, :, 0] = ((poly[:, :size].T.astype(object) << EXPAND_LEVEL) % t
                     ).astype(np.uint64)
    check_outputs("expansion", par, sk, c0, c1, want, Encoding.poly())
    out["expand"] = (launches, expand, (p0, p1))
    return out


def variants_path(par, mp: SimpleNamespace) -> dict:
    """Phase 8 on phase 4's keys and ciphertexts. Returns {variant: (step,
    launches)}; a mul+relin step takes (a0, a1, b0, b1), the square's
    (a0, a1)."""
    from tpufhe_torch.bfv import Encoding
    from tpufhe_torch.pipeline import make_mul_relin, make_square_relin

    t = par.plaintext.value
    a0, a1, b0, b1 = mp.inputs
    va, vb = mp.va.astype(object), mp.vb.astype(object)
    want_mul = (va * vb % t).astype(np.uint64)
    out, products = {}, {}
    for name, options, expected in MUL_VARIANTS:
        step = make_mul_relin(par, mp.rk, **options)
        (c0, c1), launches = run_program(name, step, mp.inputs, expected)
        check_outputs(name, par, mp.sk, c0, c1, want_mul, Encoding.simd())
        out[name] = (step, launches)
        products[name] = (c0, c1)
    products["default split"] = mp.product
    for fused, split in (("strategy 2 kP=1 fused", "strategy 2 kP=1 split"),
                         ("strategy 2 kP=2 fused", "strategy 2 kP=2 split"),
                         ("default fused", "default split")):
        equal = all(torch.equal(x, y)
                    for x, y in zip(products[fused], products[split]))
        log(f"  {fused} equal to {split}: {equal}")
        if not equal:
            raise SystemExit(f"{fused} differs from {split}")

    square = make_square_relin(par, mp.rk)
    (c0, c1), launches = run_program("square", square, (a0, a1),
                                     SQUARE_LAUNCHES)
    check_outputs("square", par, mp.sk, c0, c1,
                  (va * va % t).astype(np.uint64), Encoding.simd())
    out["square"] = (square, launches)

    step = out["strategy 2 kP=2 split"][0]
    c0, c1 = step(*products["strategy 2 kP=2 split"], b0, b1)
    check_outputs("strategy 2 kP=2, two chained products", par, mp.sk, c0, c1,
                  (va * vb * vb % t).astype(np.uint64), Encoding.simd())
    return out


def narrow_path(par) -> dict:
    """Phase 10, the narrow (w30) path: keygen (sk, rk and the inner sum's
    Galois keys), 128 SIMD encryptions, the encryption and decryption
    programs, then mul+relin and the square at batch 64, a column rotation
    by 1 at batch 32 and the inner sum at batch 16. Each program runs with
    the launch counters set to 0 just before it and must read its exact
    counts (ntt32, rns_scale and ks_accumulate only, no wide kernel);
    every slot of every output is checked after decryption. Returns
    {program: (step, inputs, launches)}."""
    from tpufhe_torch.bfv import (
        Encoding,
        EvaluationKeyBuilder,
        Plaintext,
        RelinearizationKey,
        SecretKey,
    )
    from tpufhe_torch.ops.rq import from_i64_coeffs, random_from_seed
    from tpufhe_torch.pipeline import (
        make_decrypt_phase,
        make_encrypt_with_seed_expansion,
        make_inner_sum,
        make_mul_relin,
        make_rotate,
        make_square_relin,
    )
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64
    from tpufhe_torch.utils.sampling import sample_vec_cbd

    t, n = par.plaintext.value, par.degree()
    ctx = par.context_at_level(0)
    mp = par.context_level_at(0).mul_params()
    log(f"  moduli {list(ctx.moduli)}, multiplication basis {mp.to_ctx.k} "
        f"limbs, plaintext context "
        f"{par.context_level_at(0).cipher_plain_context.plaintext_context.k} "
        f"limbs, rows {ctx.dtype}")
    rng = ChaCha8Rng(seed_from_u64(NARROW_SEED))
    t0 = time.perf_counter()
    sk = SecretKey.random(par, rng)
    rk = RelinearizationKey.new(sk, rng)
    ek = EvaluationKeyBuilder(sk).enable_inner_sum().build(rng)
    torch.cuda.synchronize()
    log(f"  keygen (sk + rk + {len(ek.gk)} Galois keys) "
        f"{time.perf_counter() - t0:.2f} s")

    vals = np.random.default_rng(NARROW_SEED)
    va = vals.integers(0, t, (BATCH, n), dtype=np.uint64)
    vb = vals.integers(0, t, (BATCH, n), dtype=np.uint64)
    t0 = time.perf_counter()
    cas = [sk.try_encrypt(Plaintext.try_encode(v, Encoding.simd(), par), rng)
           for v in va]
    cbs = [sk.try_encrypt(Plaintext.try_encode(v, Encoding.simd(), par), rng)
           for v in vb]
    torch.cuda.synchronize()
    log(f"  SIMD encode + encrypt {2 * BATCH} ciphertexts "
        f"{time.perf_counter() - t0:.2f} s, noise fresh "
        f"{sk.measure_noise(cas[0])} bits")
    a0, a1, b0, b1 = (torch.stack([c[i] for c in cs])
                      for cs in (cas, cbs) for i in (0, 1))
    if a0.dtype != torch.int32:
        raise SystemExit(f"narrow ciphertexts hold {a0.dtype}, not int32")

    # the encryption core on fresh inputs, as SecretKey.encrypt_poly draws them
    m = Plaintext.try_encode(va[0], Encoding.simd(), par).to_poly()
    a = random_from_seed(ctx, rng.fill_bytes(32))
    e = from_i64_coeffs(sample_vec_cbd(n, par.variance, rng), ctx)
    b, _ = run_program("narrow encrypt", make_encrypt_with_seed_expansion(
        par, sk), (a, e, m), {"ntt32": 1})
    check_outputs("narrow encrypt", par, sk, b[None], a[None], va[:1],
                  Encoding.simd())
    # the decryption core on all 64 fresh ciphertexts at once
    d, _ = run_program(f"narrow decrypt phase, batch {BATCH}",
                       make_decrypt_phase(par, sk), (a0, a1),
                       {"ntt32": 1, "rns_scale": 1})
    q0 = par.moduli[0]
    rows = ((d[:, 0].cpu().numpy().astype(np.uint64) + np.uint64(t))
            % np.uint64(q0)) % np.uint64(t)
    bad = sum(int((Plaintext(par, row, None, 0).try_decode(Encoding.simd())
                   != want).sum()) for row, want in zip(rows, va))
    log(f"  narrow decrypt phase: {BATCH} ciphertexts, wrong slots {bad}")
    if bad:
        raise SystemExit(f"narrow decrypt phase: {bad} slots wrong")

    va_o, vb_o = va.astype(object), vb.astype(object)
    h = n // 2
    rot_in = (a0[:ROT_BATCH].contiguous(), a1[:ROT_BATCH].contiguous())
    sum_in = (a0[:SUM_BATCH].contiguous(), a1[:SUM_BATCH].contiguous())
    sums = (va_o[:SUM_BATCH].sum(axis=1) % t).astype(np.uint64)
    rots = n.bit_length() - 1  # log2(N / 2) column rotations + the row one
    cases = [
        ("mul_relin", f"narrow mul+relin of {BATCH} pairs",
         make_mul_relin(par, rk), (a0, a1, b0, b1), NARROW_MUL_LAUNCHES,
         (va_o * vb_o % t).astype(np.uint64)),
        ("square", f"narrow square of {BATCH}", make_square_relin(par, rk),
         (a0, a1), NARROW_MUL_LAUNCHES, (va_o * va_o % t).astype(np.uint64)),
        ("rotate", f"narrow rotate columns by 1, batch {ROT_BATCH}",
         make_rotate(par, ek.gk[ek.rot_to_gk_exponent[1]]), rot_in,
         NARROW_ROT_LAUNCHES,
         np.concatenate([np.roll(va[:ROT_BATCH, :h], -1, axis=1),
                         np.roll(va[:ROT_BATCH, h:], -1, axis=1)], axis=1)),
        ("inner_sum", f"narrow inner sum, batch {SUM_BATCH}",
         make_inner_sum(par, ek), sum_in,
         {"ntt32": 2 * rots, "ks_accumulate": rots},
         np.repeat(sums[:, None], n, axis=1)),
    ]
    out = {}
    for key, name, step, inputs, expected, want in cases:
        (c0, c1), launches = run_program(name, step, inputs, expected)
        if (tuple(c0.shape) != (len(inputs[0]), ctx.k, n)
                or c0.dtype != torch.int32):
            raise SystemExit(f"{name}: output {tuple(c0.shape)} {c0.dtype}")
        check_outputs(name, par, sk, c0, c1, want, Encoding.simd())
        out[key] = (step, inputs, launches)
    return out


def narrow_rates(programs: dict, records: dict, card: str) -> dict:
    """Phase 11: chained steps of each narrow program timed with CUDA events,
    with the kernels' share of a mul+relin and a rotation step (their
    phase-3 times) and the glue's (the rest). Returns {program: ms}."""
    steps = {"mul_relin": RATE_STEPS, "square": RATE_STEPS,
             "rotate": ROT_RATE_STEPS, "inner_sum": SUM_RATE_STEPS}
    kernel_ms = {
        "mul_relin": records["ntt32"]["ms"] + records["rns_scale_int32"]["ms"]
        + records["ks_accumulate_int32"]["ms"],
        "rotate": records["ntt32_rotation"]["ms"]
        + records["ks_accumulate_int32_rotation"]["ms"]}
    out = {}
    for name, (step, inputs, _) in programs.items():
        def chained(step=step, inputs=inputs, reps=steps[name]):
            c0, c1 = inputs[:2]
            for _ in range(reps):
                c0, c1 = step(c0, c1, *inputs[2:])
            return c0

        ms = time_ms(chained, 1) / steps[name]
        out[name] = ms
        split = ""
        if name in kernel_ms:
            split = (f", kernels {kernel_ms[name]:.3f} ms, glue "
                     f"{ms - kernel_ms[name]:.3f} ms")
        log(f"  {steps[name]} chained narrow {name} steps at batch "
            f"{len(inputs[0])}: {ms:.3f} ms/step, "
            f"{len(inputs[0]) / ms * 1e3:.1f} ops/s{split} on {card}")
    return out


def chained_ms(step, inputs, reps: int) -> float:
    """Device ms per step of `reps` chained steps (outputs fed back as the
    first two inputs), by CUDA events after a warm-up."""
    def run():
        c0, c1 = inputs[:2]
        for _ in range(reps):
            c0, c1 = step(c0, c1, *inputs[2:])
        return c0

    return time_ms(run, 1) / reps


def n16k_path(par, margin: int) -> dict:
    """Phase 12, BASELINE config 5's ring at full width (N = 16384, 6 x
    62-bit, t = 65537, seed 2029): secret, relinearization and column
    rotation keys, 2 x 16 SIMD encryptions, then mul+relin, the square and
    a column rotation by 1 at batch 16 on the unfused route, each run with
    the counters set to 0 just before it and held to its exact counts;
    every slot of every output checked, the noise printed and held to
    leave at least `margin` bits of q (the N = 8192 product's). Returns
    {program: (step, inputs, launches)}."""
    from tpufhe_torch import kernels, pipeline
    from tpufhe_torch.bfv import (
        Ciphertext,
        Encoding,
        EvaluationKeyBuilder,
        Plaintext,
        RelinearizationKey,
        SecretKey,
    )
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

    t, n, b = par.plaintext.value, par.degree(), N16K_BATCH
    ctx = par.context_at_level(0)
    if kernels.tail_fits(n):
        raise SystemExit(f"tail_fits({n}) is unexpectedly true")
    log(f"  multiplication basis {par.context_level_at(0).mul_params().to_ctx.k}"
        f" limbs; route unfused (kernels.tail_fits({n}) is false)")
    rng = ChaCha8Rng(seed_from_u64(N16K_SEED))
    t0 = time.perf_counter()
    sk = SecretKey.random(par, rng)
    rk = RelinearizationKey.new(sk, rng)
    ek = EvaluationKeyBuilder(sk).enable_column_rotation(1).build(rng)
    torch.cuda.synchronize()
    log(f"  keygen (sk + rk + {len(ek.gk)} Galois key) "
        f"{time.perf_counter() - t0:.2f} s")
    vals = np.random.default_rng(N16K_SEED)
    va = vals.integers(0, t, (b, n), dtype=np.uint64)
    vb = vals.integers(0, t, (b, n), dtype=np.uint64)
    t0 = time.perf_counter()
    cas, cbs = ([sk.try_encrypt(Plaintext.try_encode(v, Encoding.simd(), par),
                                rng) for v in vs] for vs in (va, vb))
    torch.cuda.synchronize()
    log(f"  SIMD encode + encrypt {2 * b} ciphertexts "
        f"{time.perf_counter() - t0:.2f} s, noise fresh "
        f"{sk.measure_noise(cas[0])} bits")
    a0, a1, b0, b1 = (torch.stack([c[i] for c in cs])
                      for cs in (cas, cbs) for i in (0, 1))
    va_o, vb_o = va.astype(object), vb.astype(object)
    h = n // 2
    cases = [
        ("mul_relin", f"N = {n} mul+relin of {b} pairs",
         pipeline.make_mul_relin(par, rk), (a0, a1, b0, b1), N16K_MUL_LAUNCHES,
         (va_o * vb_o % t).astype(np.uint64)),
        ("square", f"N = {n} square of {b}", pipeline.make_square_relin(par, rk),
         (a0, a1), N16K_MUL_LAUNCHES, (va_o * va_o % t).astype(np.uint64)),
        ("rotate", f"N = {n} rotate columns by 1, batch {b}",
         pipeline.make_rotate(par, ek.gk[ek.rot_to_gk_exponent[1]]), (a0, a1),
         N16K_ROT_LAUNCHES,
         np.concatenate([np.roll(va[:, :h], -1, axis=1),
                         np.roll(va[:, h:], -1, axis=1)], axis=1)),
    ]
    out = {}
    q_bits = sum(N16K_MODULI_SIZES)
    for key, name, step, inputs, expected, want in cases:
        (c0, c1), launches = run_program(name, step, inputs, expected)
        if tuple(c0.shape) != (b, ctx.k, n):
            raise SystemExit(f"{name}: output shape {tuple(c0.shape)}")
        check_outputs(name, par, sk, c0, c1, want, Encoding.simd())
        noise = sk.measure_noise(Ciphertext(par, [c0[0], c1[0]], 0))
        if q_bits - noise < margin:
            raise SystemExit(f"{name}: noise {noise} bits leaves "
                             f"{q_bits - noise} of q, below {margin}")
        out[key] = (step, inputs, launches)
    return out


def n16k_rates(programs: dict, records: dict, card: str) -> dict:
    """Phase 12's rates: chained batch-16 steps of each program, with the
    kernels' share (their phase-3 times; the square extends 2 parts where
    the mul+relin extends 4, so its extend's K1 pair and K2 take half the
    mul+relin's) and the glue's (the rest). Returns {program: ms}."""
    mul_kernels = sum(records[key]["ms"] for key in
                      ("ntt", "rns_scale", "tensor", "ks_accumulate"))
    ntt_ms, scale_ms = records["ntt"]["item_ms"], records["rns_scale"]["item_ms"]
    square_kernels = mul_kernels - (ntt_ms[0] + ntt_ms[1] + scale_ms[0]) / 2
    kernel_ms = {"mul_relin": mul_kernels, "square": square_kernels,
                 "rotate": records["ntt_rotation"]["ms"]
                 + records["ks_accumulate_rotation"]["ms"]}
    reps = {"mul_relin": RATE_STEPS, "square": RATE_STEPS,
            "rotate": ROT_RATE_STEPS}
    out = {}
    for name, (step, inputs, _) in programs.items():
        ms = out[name] = chained_ms(step, inputs, reps[name])
        log(f"  {reps[name]} chained N = {N16K} {name} steps at batch "
            f"{N16K_BATCH}: {ms:.3f} ms/step, {N16K_BATCH / ms * 1e3:.1f} "
            f"ops/s, kernels {kernel_ms[name]:.3f} ms, glue "
            f"{ms - kernel_ms[name]:.3f} ms on {card}")
    return out


def wider_path(pars, card: str) -> dict:
    """Phase 13: mul+relin at batch 16 on the N = 8192 sets whose
    multiplication basis has more than 16 limbs (8 x 62-bit: 17, int64
    rows; 8 x 30-bit narrow: 18, int32 rows), where the down-scale runs
    K2's general instance: keygen, 2 x 16 SIMD encryptions, one step held
    to its exact launch counts, every slot checked, then chained steps
    timed. Returns {label: launches}."""
    from tpufhe_torch.bfv import Encoding, Plaintext, RelinearizationKey, SecretKey
    from tpufhe_torch.pipeline import make_mul_relin
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

    out = {}
    for (label, _, expected), par in zip(WIDER_SETS, pars):
        t, n, b = par.plaintext.value, par.degree(), WIDER_BATCH
        ctx = par.context_at_level(0)
        k_mul = par.context_level_at(0).mul_params().to_ctx.k
        log(f"  {label}: moduli {list(ctx.moduli)}, multiplication basis "
            f"{k_mul} limbs, rows {ctx.dtype}")
        rng = ChaCha8Rng(seed_from_u64(WIDER_SEED))
        sk = SecretKey.random(par, rng)
        rk = RelinearizationKey.new(sk, rng)
        vals = np.random.default_rng(WIDER_SEED)
        va = vals.integers(0, t, (b, n), dtype=np.uint64)
        vb = vals.integers(0, t, (b, n), dtype=np.uint64)
        cas, cbs = ([sk.try_encrypt(Plaintext.try_encode(v, Encoding.simd(),
                                                         par), rng)
                     for v in vs] for vs in (va, vb))
        inputs = tuple(torch.stack([c[i] for c in cs])
                       for cs in (cas, cbs) for i in (0, 1))
        step = make_mul_relin(par, rk)
        (c0, c1), launches = run_program(f"{label} mul+relin of {b} pairs",
                                         step, inputs, expected)
        check_outputs(f"{label} mul+relin", par, sk, c0, c1,
                      (va.astype(object) * vb.astype(object) % t
                       ).astype(np.uint64), Encoding.simd())
        ms = chained_ms(step, inputs, RATE_STEPS)
        log(f"  {RATE_STEPS} chained {label} mul+relin steps at batch {b}: "
            f"{ms:.3f} ms/step, {b / ms * 1e3:.1f} mul+relin/s on {card}")
        out[label] = launches
    return out


def source_define(source: str, name: str) -> int:
    """The value of `#define name N` in tpufhe_torch/csrc/`source`."""
    from tpufhe_torch import kernels

    with open(os.path.join(kernels.CSRC, source)) as f:
        found = re.findall(rf"^#define {name} (\d+)$", f.read(), re.MULTILINE)
    if len(found) != 1:
        raise SystemExit(f"{source}: no single #define {name}")
    return int(found[0])


def dot_case(label, ctx, parts, db):
    """A run_cases item for ct_pt_dot: every part and db read once, the
    output written once; per output word n 128-bit products and one
    reduction a window."""
    from tpufhe_torch.ops import dot

    n, m, r = db.shape[:3]
    b, n_deg = parts[0].shape[1], ctx.degree
    outs = len(parts) * m * b * r * n_deg
    windows = -(-n // min(dot.dot_window(ctx), n))
    return (f"{label} {len(parts)} x {tuple(parts[0].shape)} . "
            f"db {tuple(db.shape)}",
            lambda: dot.ct_pt_dot_cuda(ctx, parts, db),
            lambda: dot.ct_pt_dot_plain(ctx, parts, db),
            (len(parts) * n * b * r * n_deg + n * m * r * n_deg + outs) * 8,
            outs * (n * (LO + HI) + windows * RED128))


def check_dot_kernels(pars, gen, int32_rate: float) -> dict:
    """Phase 3, ct_pt_dot against its plain version: at the dot bench's
    shape (128 terms, m = B = 1, 4 x 62-bit at N = 8192; phase 15), at
    PIR's first dimension (64 terms, 8 columns, 6 x 62-bit at N = 16384)
    and at 15 and 29 terms over 3 x 62-bit at N = 8192, across one and two
    reductions of the 14-term window. Returns {label: record}."""
    shapes = [("dot bench", pars["dot"], DOT_PAIRS, 1),
              ("PIR first dimension", pars["n16k"], *DOT_PIR)]
    shapes += [(f"{t} terms", pars["main"], t, 1) for t in DOT_WINDOW_TERMS]
    from tpufhe_torch import kernels

    fn = kernels.function("ct_pt_dot", "tpufhe_ct_pt_dot_occupancy",
                          [ctypes.c_void_p])
    blocks_per_sm = ctypes.c_int()
    kernels.check(fn(ctypes.byref(blocks_per_sm)), "occupancy")
    # the launch plan as the kernel's source fixes it: a thread per output
    # word and part, DOT_COLS columns' sums a pass
    threads, cols = (source_define("ct_pt_dot.cu", d)
                     for d in ("DOT_THREADS", "DOT_COLS"))
    out = {}
    for label, par, n, m in shapes:
        ctx = par.context_at_level(0)
        parts = [rand_residues((n, 1, ctx.k, ctx.degree), ctx.tables.p, gen)
                 for _ in range(2)]
        db = rand_residues((n, m, ctx.k, ctx.degree), ctx.tables.p, gen)
        out[label] = run_cases("ct_pt_dot", [dot_case(label, ctx, parts, db)],
                               int32_rate, "per call")
        blocks = -(-2 * ctx.k * ctx.degree // threads)
        out[label]["plan"] = {"threads": threads, "blocks": blocks,
                              "columns_a_pass": min(m, cols),
                              "blocks_per_sm": blocks_per_sm.value}
        log(f"  plan ct_pt_dot {label}: {blocks} blocks x {threads} threads, "
            f"{min(m, cols)} columns a pass, "
            f"{blocks_per_sm.value} blocks per SM")
    return out


def object_api_cases(par, b: int, gen) -> dict:
    """run_cases items for the kernels the object API runs at level 0 of
    `par` on batch b: SIMD encoding and decoding (K1 modulo t), public-key
    encryption (K1 forward of Delta m and of the three samples), ct_mul to three parts (each operand's extend: K1
    inverse, K2, K1 forward of the new limbs; K7; the down-scale: K1
    inverse over the basis, K2, K1 forward), the relinearization's K1
    inverse of c2 and, for a Garner key where the tails fit, K5, and the
    decryption's K1 inverse and K2 (the level's t/q scaler). Returns
    {kernel: items}."""
    from tpufhe_torch import kernels

    ctx = par.context_at_level(0)
    lvl = par.context_level_at(0)
    mp = lvl.mul_params()
    ctx_mul = mp.to_ctx
    k, k_mul, n = ctx.k, ctx_mul.k, ctx.degree
    t_ctx, t_mul = ctx.tables, ctx_mul.tables
    full, new = slice(None), slice(k, k_mul)
    cases = {"ntt": [
        k1_case("pk encryption Delta m", rand_residues((k, n), t_ctx.p, gen),
                t_ctx, full, False),
        k1_case("pk encryption samples",
                rand_residues((3, k, n), t_ctx.p, gen), t_ctx, full, False),
        k1_case("ct_mul extend", rand_residues((2, b, k, n), t_ctx.p, gen),
                t_ctx, full, True),
        k1_case(f"ct_mul new limbs {k}..{k_mul}",
                rand_residues((2, b, k_mul - k, n), t_mul.p[new], gen), t_mul,
                new, False),
        k1_case("ct_mul down", rand_residues((3, b, k_mul, n), t_mul.p, gen),
                t_mul, full, True),
        k1_case("ct_mul product", rand_residues((3, b, k, n), t_ctx.p, gen),
                t_ctx, full, False),
        k1_case("relinearizes c2", rand_residues((b, k, n), t_ctx.p, gen),
                t_ctx, full, True),
        k1_case("decryption", rand_residues((k, n), t_ctx.p, gen), t_ctx,
                full, True)]}
    t_pt = par.ntt_operator.tables  # the SIMD slots' transform modulo t
    cases["ntt"] += [
        k1_case("SIMD encode", rand_residues((1, n), t_pt.p, gen), t_pt, full,
                True),
        k1_case("SIMD decode", rand_residues((1, n), t_pt.p, gen), t_pt, full,
                False)]
    dec = lvl.cipher_plain_context.scaler.rns_scaler
    cases["rns_scale"] = [
        k2_case("ct_mul extend", mp.extender.rns_scaler,
                rand_residues((2, b, k, n), t_ctx.p, gen), k, k_mul - k),
        k2_case("ct_mul down", mp.down_scaler.rns_scaler,
                rand_residues((3, b, k_mul, n), t_mul.p, gen), 0, k),
        k2_case("decryption", dec, rand_residues((k, n), t_ctx.p, gen), 0,
                len(dec.to_ctx.moduli))]
    a0, a1, b0, b1 = (rand_residues((b, k_mul, n), t_mul.p, gen)
                      for _ in range(4))
    cases["tensor"] = [k7_case("ct_mul", ctx_mul, a0, a1, b0, b1)]
    if k > 1 and kernels.tail_fits(n):
        cases["rotate_tail"] = [k5_case(
            "relinearizes", ctx, rand_residues((b, k, n), t_ctx.p, gen),
            rand_residues((b, k, n), t_ctx.p, gen), random_key(ctx, gen))]
    return cases


def check_api_kernels(par, gen, int32_rate: float) -> dict:
    """Phase 3 at phase 16's shapes (N = 8192, 3 x 62-bit, batch 64): the
    object API's kernels (object_api_cases) and Multiplicator.strategy2(rk,
    1)'s over the 4-limb basis: K2 at the lhs extend (3 -> 1 new limb), the
    rhs P/q (3 -> 4) and the t/P down-scale (4 -> 3), K1 forward of the new
    limb and of the rhs, K1 inverse of the three parts, K7. Returns {name:
    record}."""
    from tpufhe_torch import pipeline

    ctx = par.context_at_level(0)
    k, n, b = ctx.k, ctx.degree, BATCH
    cases = object_api_cases(par, b, gen)
    s1 = pipeline.mul_basis(par, strategy2_primes=1)
    t_ctx, t1 = ctx.tables, s1.ctx_mul.tables
    k1 = s1.ctx_mul.k
    cases["ntt"] += [
        k1_case(f"kP=1 new limb {k}..{k1}",
                rand_residues((2, b, k1 - k, n), t1.p[k:], gen), t1,
                slice(k, k1), False),
        k1_case("kP=1 rhs", rand_residues((2, b, k1, n), t1.p, gen), t1,
                slice(None), False),
        k1_case("kP=1 down", rand_residues((3, b, k1, n), t1.p, gen), t1,
                slice(None), True)]
    cases["rns_scale"] += [
        k2_case("kP=1 lhs extend", s1.ext,
                rand_residues((2, b, k, n), t_ctx.p, gen), k, k1 - k),
        k2_case("kP=1 rhs P/q", s1.rhs,
                rand_residues((2, b, k, n), t_ctx.p, gen), 0, k1),
        k2_case("kP=1 down t/P", s1.down,
                rand_residues((3, b, k1, n), t1.p, gen), 0, k)]
    a0, a1, b0, b1 = (rand_residues((b, k1, n), t1.p, gen) for _ in range(4))
    cases["tensor"] += [k7_case("kP=1", s1.ctx_mul, a0, a1, b0, b1)]
    return {name: run_cases(name, items, int32_rate, "per phase-16 run")
            for name, items in cases.items()}


def check_single_modulus_kernels(par, gen, int32_rate: float) -> dict:
    """Phase 3 at phase 17's shapes (N = 2048, 1 x 62-bit, batch 16): the
    object API's kernels (object_api_cases), the relinearization's K1
    forward of the two digit rows, and make_mul_relin's: K1 inverse of the
    four parts, forward of the new limbs and of the tail's c0, c1 and two
    digit rows, K2 at the extend and the down-scale, K3 over the basis and
    ks_accumulate on the two digit rows with both addends. Returns {name:
    record}."""
    ctx = par.context_at_level(0)
    mp = par.context_level_at(0).mul_params()
    ctx_mul = mp.to_ctx
    k, k_mul, n, b = ctx.k, ctx_mul.k, ctx.degree, K1_BATCH
    t_ctx, t_mul = ctx.tables, ctx_mul.tables
    full, new = slice(None), slice(k, k_mul)
    cases = object_api_cases(par, b, gen)
    cases["ntt"] += [
        k1_case("digits", rand_residues((2, b, k, n), t_ctx.p, gen), t_ctx,
                full, False),
        k1_case("mul+relin extend", rand_residues((4, b, k, n), t_ctx.p, gen),
                t_ctx, full, True),
        k1_case(f"mul+relin new limbs {k}..{k_mul}",
                rand_residues((4, b, k_mul - k, n), t_mul.p[new], gen), t_mul,
                new, False),
        k1_case("mul+relin tail", rand_residues((4, b, k, n), t_ctx.p, gen),
                t_ctx, full, False)]
    cases["rns_scale"] += [
        k2_case("mul+relin extend", mp.extender.rns_scaler,
                rand_residues((4, b, k, n), t_ctx.p, gen), k, k_mul - k)]
    cases["tensor_intt"] = [k3_case(
        "mul+relin", ctx_mul, rand_residues((4, b, k_mul, n), t_mul.p, gen))]
    key = random_key(ctx, gen, digits=2)
    d = rand_residues((2, b, k, n), t_ctx.p, gen)
    a0, a1 = (rand_residues((b, k, n), t_ctx.p, gen) for _ in range(2))
    cases["ks_accumulate"] = [ks_case("two digits", ctx, d, key, a0, a1)]
    return {name: run_cases(name, items, int32_rate,
                            f"per phase-17 run (N = {n})")
            for name, items in cases.items()}


def check_default128_kernels(par, gen, int32_rate: float) -> dict:
    """Phase 3 at phase 18's shapes (default_parameters_128(20)'s N = 8192
    set, moduli of 43 and 44 bits, batch 16): make_mul_relin's K1 at the
    extend's inverse and forward of the new limbs, K2 at the extend (5 -> 5
    new limbs, a fixed instance) and the down-scale (10 -> 5, the general
    one), K3 over the 10-limb basis and K4 with a random key, and
    Multiplicator.default's, public-key encryption's and decryption's
    kernels (object_api_cases: K5 among them). Returns {name: record}."""
    ctx = par.context_at_level(0)
    mp = par.context_level_at(0).mul_params()
    ctx_mul = mp.to_ctx
    k, k_mul, n, b = ctx.k, ctx_mul.k, ctx.degree, D128_BATCH
    t_ctx, t_mul = ctx.tables, ctx_mul.tables
    log(f"  default_parameters_128({D128_BITS}), N = {n}: moduli "
        f"{[p.bit_length() for p in ctx.moduli]} bits, multiplication basis "
        f"{k_mul} limbs")
    cases = object_api_cases(par, b, gen)
    cases["ntt"] += [
        k1_case("mul+relin extend", rand_residues((4, b, k, n), t_ctx.p, gen),
                t_ctx, slice(None), True),
        k1_case(f"mul+relin new limbs {k}..{k_mul}",
                rand_residues((4, b, k_mul - k, n), t_mul.p[k:], gen), t_mul,
                slice(k, k_mul), False)]
    cases["rns_scale"] += [
        k2_case("mul+relin extend", mp.extender.rns_scaler,
                rand_residues((4, b, k, n), t_ctx.p, gen), k, k_mul - k)]
    cases["tensor_intt"] = [k3_case(
        "mul+relin", ctx_mul, rand_residues((4, b, k_mul, n), t_mul.p, gen))]
    cases["relin_tail"] = [k4_case(
        "mul+relin", ctx, rand_residues((3, b, k, n), t_ctx.p, gen),
        random_key(ctx, gen))]
    return {name: run_cases(name, items, int32_rate, "per phase-18 run")
            for name, items in cases.items()}


def keys_and_batch(par, seed: int, batch: int, relin: bool = True):
    """Secret key (and relinearization key) from ChaCha8 seed `seed`, and
    2 x batch SIMD encryptions of values from numpy's seed `seed`:
    (sk, rk or None, va, vb, (a0, a1, b0, b1), the ChaCha8 generator)."""
    from tpufhe_torch.bfv import (
        Encoding,
        Plaintext,
        RelinearizationKey,
        SecretKey,
    )
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

    t, n = par.plaintext.value, par.degree()
    rng = ChaCha8Rng(seed_from_u64(seed))
    t0 = time.perf_counter()
    sk = SecretKey.random(par, rng)
    rk = RelinearizationKey.new(sk, rng) if relin else None
    vals = np.random.default_rng(seed)
    va = vals.integers(0, t, (batch, n), dtype=np.uint64)
    vb = vals.integers(0, t, (batch, n), dtype=np.uint64)
    cas, cbs = ([sk.try_encrypt(Plaintext.try_encode(v, Encoding.simd(), par),
                                rng) for v in vs] for vs in (va, vb))
    torch.cuda.synchronize()
    log(f"  keygen and {2 * batch} SIMD encryptions "
        f"{time.perf_counter() - t0:.2f} s")
    inputs = tuple(torch.stack([c[i] for c in cs])
                   for cs in (cas, cbs) for i in (0, 1))
    return sk, rk, va, vb, inputs, rng


def check_parts(name, par, sk, ct, want) -> None:
    """Every part of the batched ciphertext ct canonical, every slot of
    every row's decryption (any number of parts) equal to `want`."""
    from tpufhe_torch.bfv import Ciphertext, Encoding

    p = par.context_at_level(ct.level).tables.p[:, None]
    if not all(bool(((x >= 0) & (x < p)).all()) for x in ct.c):
        raise SystemExit(f"{name}: output residues are not canonical")
    bad = 0
    for i in range(ct[0].shape[0]):
        row = Ciphertext(par, [x[i] for x in ct.c], ct.level)
        bad += int((sk.try_decrypt(row).try_decode(Encoding.simd())
                    != want[i]).sum())
    row0 = Ciphertext(par, [x[0] for x in ct.c], ct.level)
    log(f"  {name}: {ct[0].shape[0]} ciphertexts of {len(ct)} parts "
        f"decrypted, wrong slots {bad}, noise {sk.measure_noise(row0)} bits")
    if bad:
        raise SystemExit(f"{name}: {bad} slots decrypted wrong")


def addpt_path(par, card: str) -> float:
    """Phase 14, BASELINE config 2 (N = 4096, 2 x 62-bit, t = 65537, batch
    64; bench.py:229-266): make_add then ct_mul_pt by a SIMD plaintext's
    poly_ntt (no kernel: elementwise glue), every slot checked, then
    chained steps timed; ct_add_pt, ct_sub_pt and ct_neg through the object
    API, every slot checked. Returns ms per step."""
    from tpufhe_torch.bfv import Ciphertext, Encoding, Plaintext, ct_mul_pt
    from tpufhe_torch.pipeline import make_add

    t, b = par.plaintext.value, ADDPT_BATCH
    sk, _, va, vb, inputs, _ = keys_and_batch(par, ADDPT_SEED, b, relin=False)
    vw = np.random.default_rng(ADDPT_SEED + 100).integers(
        0, t, par.degree(), dtype=np.uint64)
    pt = Plaintext.try_encode(vw, Encoding.simd(), par)
    add = make_add(par)
    # the plaintext's poly_ntt is formed (one K1 launch) and kept before
    # the program runs, as bench.py holds its plaintext as a device array
    pt.poly_ntt  # noqa: B018

    def step(a0, a1, b0, b1):
        return tuple(ct_mul_pt(Ciphertext(par, list(add(a0, a1, b0, b1)), 0),
                               pt).c)

    (c0, c1), _ = run_program(f"add + pt_mul of {b} pairs", step, inputs, {})
    va_o, vb_o = va.astype(object), vb.astype(object)
    check_parts("add + pt_mul", par, sk, Ciphertext(par, [c0, c1], 0),
                ((va_o + vb_o) * vw % t).astype(np.uint64))
    ms = chained_ms(step, inputs, ADDPT_RATE_STEPS)
    log(f"  {ADDPT_RATE_STEPS} chained add + pt_mul steps at batch {b}: "
        f"{ms:.4f} ms/step, {b / ms * 1e3:.1f} add+pt_mul/s on {card}")
    ca = Ciphertext(par, list(inputs[:2]), 0)
    pb = Plaintext.try_encode(vb[0], Encoding.simd(), par)
    for name, ct, want in (("ct_add_pt", ca + pb, va_o + vb_o[0]),
                           ("ct_sub_pt", ca - pb, va_o - vb_o[0]),
                           ("ct_neg", -ca, -va_o)):
        check_parts(name, par, sk, ct, (want % t).astype(np.uint64))
    return ms


def dot_path(par, card: str) -> tuple:
    """Phase 15, the dot-product bench (bench.py:361-418; N = 8192, 4 x
    62-bit, 128 pairs): 128 SIMD encryptions and plaintexts, then
    make_ct_pt_dot (one ct_pt_dot launch) and dot_product_scalar over the
    first 16 (one), each decrypted slot for slot against sum v_i w_i mod t;
    then dot products chained as the bench chains them (the result added
    into every input row) timed. Returns (launches, ms per dot product)."""
    from tpufhe_torch.bfv import (
        Ciphertext,
        Encoding,
        Plaintext,
        SecretKey,
        dot_product_scalar,
    )
    from tpufhe_torch.pipeline import make_ct_pt_dot
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

    t, n, pairs = par.plaintext.value, par.degree(), DOT_PAIRS
    ctx = par.context_at_level(0)
    rng = ChaCha8Rng(seed_from_u64(DOT_SEED))
    t0 = time.perf_counter()
    sk = SecretKey.random(par, rng)
    vals = np.random.default_rng(DOT_SEED)
    v = vals.integers(0, t, (pairs, n), dtype=np.uint64)
    w = vals.integers(0, t, (pairs, n), dtype=np.uint64)
    cts = [sk.try_encrypt(Plaintext.try_encode(x, Encoding.simd(), par), rng)
           for x in v]
    pts = [Plaintext.try_encode(x, Encoding.simd(), par) for x in w]
    db = torch.stack([pt.poly_ntt for pt in pts])[:, None]  # (n, 1, k, N)
    torch.cuda.synchronize()
    log(f"  {pairs} SIMD encryptions and plaintexts "
        f"{time.perf_counter() - t0:.2f} s")
    e0, e1 = (torch.stack([c[i] for c in cts])[:, None] for i in (0, 1))
    dot = make_ct_pt_dot(par, pairs, 1)
    (r0, r1), launches = run_program(f"ct x pt dot of {pairs} pairs", dot,
                                     (e0, e1, db), {"ct_pt_dot": 1})
    if tuple(r0.shape) != (1, 1, ctx.k, n):
        raise SystemExit(f"dot: output shape {tuple(r0.shape)}")
    vo, wo = v.astype(object), w.astype(object)
    check_parts("ct x pt dot", par, sk, Ciphertext(par, [r0[0], r1[0]], 0),
                ((vo * wo).sum(axis=0) % t).astype(np.uint64)[None])
    ct, _ = run_program(f"dot_product_scalar of {DOT_SCALAR}",
                        dot_product_scalar,
                        (cts[:DOT_SCALAR], pts[:DOT_SCALAR]), {"ct_pt_dot": 1})
    check_parts("dot_product_scalar", par, sk,
                Ciphertext(par, [x[None] for x in ct.c], 0),
                ((vo[:DOT_SCALAR] * wo[:DOT_SCALAR]).sum(axis=0) % t
                 ).astype(np.uint64)[None])

    def step(e0, e1, db):
        r0, r1 = dot(e0, e1, db)
        return ctx.add(e0, r0[0]), ctx.add(e1, r1[0])

    ms = chained_ms(step, (e0, e1, db), DOT_RATE_STEPS)
    log(f"  {DOT_RATE_STEPS} chained dot products of {pairs} pairs: "
        f"{ms:.4f} ms each, {1e3 / ms:.1f} dot_products/s on {card}")
    return launches, ms


def object_api_path(par, mp: SimpleNamespace, variants: dict) -> None:
    """Phase 16, the object API at BASELINE config 3 on phase 4's keys and
    64 pairs: PublicKey (seed 2033) encryption, ct_mul to three parts and
    their decryption, ct_square, relinearizes, and Multiplicator.default
    and strategy2(rk, 1), each torch.equal to make_mul_relin's output
    (default and strategy 2 kP = 1) on the same ciphertexts; every run held
    to its exact launch counts, every slot checked, the noise printed."""
    from tpufhe_torch.bfv import (
        Ciphertext,
        Encoding,
        Multiplicator,
        Plaintext,
        PublicKey,
        ct_mul,
        ct_square,
    )
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

    t = par.plaintext.value
    va, vb = mp.va.astype(object), mp.vb.astype(object)
    rng = ChaCha8Rng(seed_from_u64(API_SEED))
    pk = PublicKey.new(mp.sk, rng)
    pts = [Plaintext.try_encode(v, Encoding.simd(), par) for v in mp.va[:2]]
    first, _ = run_program("public-key encryption", pk.try_encrypt,
                           (pts[0], rng), PK_ENCRYPT_LAUNCHES)
    second = pk.try_encrypt(pts[1], rng)
    check_parts("public-key encryption", par, mp.sk,
                Ciphertext(par, [torch.stack([x[i] for x in (first, second)])
                                 for i in (0, 1)], 0), mp.va[:2])
    a0, a1, b0, b1 = mp.inputs
    ca, cb = Ciphertext(par, [a0, a1], 0), Ciphertext(par, [b0, b1], 0)
    c3, _ = run_program("ct_mul to three parts", ct_mul, (ca, cb),
                        API_PRODUCT_LAUNCHES)
    row = Ciphertext(par, [x[0] for x in c3.c], 0)
    run_program("three-part decryption", mp.sk.try_decrypt, (row,),
                {"ntt": 1, "rns_scale": 1})
    want = (va * vb % t).astype(np.uint64)
    check_parts("ct_mul", par, mp.sk, c3, want)
    sq, _ = run_program("ct_square", ct_square, (ca,), API_SQUARE_LAUNCHES)
    check_parts("ct_square", par, mp.sk, sq, (va * va % t).astype(np.uint64))
    run_program("relinearizes", mp.rk.relinearizes, (c3,),
                {"ntt": 1, "rotate_tail": 1})
    equal = all(torch.equal(x, y) for x, y in zip(c3.c, mp.product))
    log(f"  ct_mul + relinearizes equal to make_mul_relin: {equal}")
    if not equal:
        raise SystemExit("ct_mul + relinearizes differs from make_mul_relin")
    s2_step = variants["strategy 2 kP=1 split"][0]
    for name, m, ref in (
            ("default", Multiplicator.default(mp.rk), mp.product),
            ("strategy 2 kP=1", Multiplicator.strategy2(mp.rk, 1),
             s2_step(a0, a1, b0, b1))):
        ct, _ = run_program(f"Multiplicator {name}", m.multiply, (ca, cb),
                            API_MULTIPLY_LAUNCHES)
        equal = all(torch.equal(x, y) for x, y in zip(ct.c, ref))
        log(f"  Multiplicator {name} equal to make_mul_relin: {equal}")
        if not equal:
            raise SystemExit(
                f"Multiplicator {name} differs from make_mul_relin")
        check_parts(f"Multiplicator {name}", par, mp.sk, ct, want)
    log(f"  phase 4's product noise: {sum(MODULI_SIZES) - mp.margin} bits")


def single_modulus_path(par) -> None:
    """Phase 17, one 62-bit modulus at N = 2048 (BASELINE config 1's ring,
    t = 65537, seed 2034): a key-switching key from s^2 with log_base 31
    and two digit rows as the relinearization key, then ct_mul of 16 pairs
    to three parts, relinearizes (K1 inverse, K1 forward of the digits,
    ks_accumulate) and make_mul_relin on the same pairs (K3, then the
    unfused tail on the digits), equal, every slot checked."""
    from tpufhe_torch.bfv import (
        Ciphertext,
        KeySwitchingKey,
        RelinearizationKey,
        ct_mul,
    )
    from tpufhe_torch.ops.rq import ntt_backward
    from tpufhe_torch.pipeline import make_mul_relin

    t = par.plaintext.value
    ctx = par.context_at_level(0)
    sk, _, va, vb, inputs, rng = keys_and_batch(par, K1_SEED, K1_BATCH,
                                                relin=False)
    s = sk.s_ntt(ctx)
    rk = RelinearizationKey(KeySwitchingKey.new(
        sk, ntt_backward(ctx, ctx.mul(s, s)), 0, 0, rng))
    log(f"  key: log_base {rk.ksk.log_base}, {rk.ksk.c0.shape[0]} digit rows")
    if (rk.ksk.log_base, rk.ksk.c0.shape[0]) != (31, 2):
        raise SystemExit("the single-modulus key is not log_base 31, 2 rows")
    ca, cb = (Ciphertext(par, list(inputs[i:i + 2]), 0) for i in (0, 2))
    ct, _ = run_program("ct_mul to three parts", ct_mul, (ca, cb),
                        API_PRODUCT_LAUNCHES)
    want = (va.astype(object) * vb % t).astype(np.uint64)
    check_parts("ct_mul", par, sk, ct, want)
    run_program("relinearizes (two digits)", rk.relinearizes, (ct,),
                {"ntt": 2, "ks_accumulate": 1})
    check_parts("relinearized", par, sk, ct, want)
    (c0, c1), _ = run_program(
        "make_mul_relin", make_mul_relin(par, rk), inputs,
        {"ntt": 3, "rns_scale": 2, "tensor_intt": 1, "ks_accumulate": 1})
    equal = torch.equal(c0, ct[0]) and torch.equal(c1, ct[1])
    log(f"  make_mul_relin equal to ct_mul + relinearizes: {equal}")
    if not equal:
        raise SystemExit("make_mul_relin differs from ct_mul + relinearizes")


def default128_path(par, card: str) -> None:
    """Phase 18, default_parameters_128(20)'s N = 8192 set (moduli of 43
    and 44 bits, seed 2035): keygen and a public key, 2 x 16 public-key
    encryptions, make_mul_relin (six launches) and Multiplicator.default
    on the same pairs, equal, every slot checked, then chained steps."""
    from tpufhe_torch.bfv import (
        Ciphertext,
        Encoding,
        Multiplicator,
        Plaintext,
        PublicKey,
        RelinearizationKey,
        SecretKey,
    )
    from tpufhe_torch.pipeline import make_mul_relin
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

    t, n, b = par.plaintext.value, par.degree(), D128_BATCH
    rng = ChaCha8Rng(seed_from_u64(D128_SEED))
    t0 = time.perf_counter()
    sk = SecretKey.random(par, rng)
    rk = RelinearizationKey.new(sk, rng)
    pk = PublicKey.new(sk, rng)
    vals = np.random.default_rng(D128_SEED)
    va = vals.integers(0, t, (b, n), dtype=np.uint64)
    vb = vals.integers(0, t, (b, n), dtype=np.uint64)
    pts = [Plaintext.try_encode(v, Encoding.simd(), par) for v in (*va, *vb)]
    run_program("public-key encryption", pk.try_encrypt, (pts[0], rng),
                PK_ENCRYPT_LAUNCHES)
    cts = [pk.try_encrypt(pt, rng) for pt in pts]
    torch.cuda.synchronize()
    log(f"  t = {t}; keygen, public key and {2 * b + 1} public-key "
        f"encryptions {time.perf_counter() - t0:.2f} s, noise fresh "
        f"{sk.measure_noise(cts[0])} bits")
    inputs = tuple(torch.stack([c[i] for c in cts[j * b:(j + 1) * b]])
                   for j in (0, 1) for i in (0, 1))
    check_parts("public-key encryptions", par, sk,
                Ciphertext(par, list(inputs[:2]), 0), va)
    step = make_mul_relin(par, rk)
    (c0, c1), _ = run_program(f"mul+relin of {b} pairs", step, inputs,
                              MUL_LAUNCHES)
    ca, cb = (Ciphertext(par, list(inputs[i:i + 2]), 0) for i in (0, 2))
    ct, _ = run_program("Multiplicator default", Multiplicator.default(rk)
                        .multiply, (ca, cb), API_MULTIPLY_LAUNCHES)
    equal = torch.equal(c0, ct[0]) and torch.equal(c1, ct[1])
    log(f"  Multiplicator default equal to make_mul_relin: {equal}")
    if not equal:
        raise SystemExit("Multiplicator default differs from make_mul_relin")
    check_parts("mul+relin", par, sk, ct,
                (va.astype(object) * vb % t).astype(np.uint64))
    ms = chained_ms(step, inputs, RATE_STEPS)
    log(f"  {RATE_STEPS} chained mul+relin steps at batch {b}: {ms:.3f} "
        f"ms/step, {b / ms * 1e3:.1f} mul+relin/s on {card}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    from tpufhe_torch import kernels, native
    from tpufhe_torch.bfv import BfvParameters, BfvParametersBuilder

    t_all = time.perf_counter()
    card = nvidia_smi("name,power.limit")
    log("phase 1: card")
    log(card)
    sm_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_rate = sms * INT32_MULS_PER_CLOCK_PER_SM * sm_clock_mhz * 1e6
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {sms} SMs, "
        f"max SM clock {sm_clock_mhz:.0f} MHz, int32 multiply rate "
        f"{int32_rate / 1e12:.2f} T/s")

    log("phase 2: build")
    t0 = time.perf_counter()
    built = kernels.build()
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lib = native.lib()
    if lib is None:
        raise SystemExit(f"the native sampler did not build: {native.error}")
    log(f"  sampler: native ({os.path.basename(lib._name)}, "
        f"{time.perf_counter() - t0:.1f} s)")

    par = (BfvParametersBuilder().set_degree(DEGREE)
           .set_plaintext_modulus(PLAINTEXT).set_moduli_sizes(MODULI_SIZES)
           .build())
    par_rot = (BfvParametersBuilder().set_degree(DEGREE)
               .set_plaintext_modulus(PLAINTEXT)
               .set_moduli_sizes(ROT_MODULI_SIZES).build())
    par_w30 = (BfvParametersBuilder().set_degree(DEGREE)
               .set_plaintext_modulus(PLAINTEXT)
               .set_moduli_sizes(NARROW_MODULI_SIZES).build())
    if not par_w30.context_at_level(0).narrow:
        raise SystemExit("7 x 30-bit parameters did not select the narrow mode")
    par_16k = (BfvParametersBuilder().set_degree(N16K)
               .set_plaintext_modulus(PLAINTEXT)
               .set_moduli_sizes(N16K_MODULI_SIZES).build())
    par_wider = [BfvParametersBuilder().set_degree(DEGREE)
                 .set_plaintext_modulus(PLAINTEXT).set_moduli_sizes(sizes)
                 .build() for _, sizes, _ in WIDER_SETS]
    par_4096 = (BfvParametersBuilder().set_degree(TAIL_N4096)
                .set_plaintext_modulus(PLAINTEXT)
                .set_moduli_sizes(TAIL_N4096_MODULI_SIZES).build())
    par_k1 = (BfvParametersBuilder().set_degree(K1_DEGREE)
              .set_plaintext_modulus(PLAINTEXT)
              .set_moduli_sizes(K1_MODULI_SIZES).build())
    par_d128 = next(p for p in BfvParameters.default_parameters_128(D128_BITS)
                    if p.degree() == DEGREE)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    log("phase 3: kernels against their plain versions")
    records = check_kernels(par, gen, int32_rate)
    tails = check_tails({"main": par.context_at_level(0),
                         "rot": par_rot.context_at_level(0),
                         "8x62": par_wider[0].context_at_level(0),
                         "n4096": par_4096.context_at_level(0)},
                        gen, int32_rate)
    records["relin_tail"] = tails["relin_tail"]
    records["rotate_tail"] = tails["rotate_tail"]
    side = check_side_kernels(par_rot, par_4096, gen, int32_rate)
    variant_records = check_variant_kernels(par, gen, int32_rate)
    records["tensor"] = variant_records["tensor"]
    records["intt_scale"] = variant_records["intt_scale"]
    narrow_records = check_narrow_kernels(par_w30, gen, int32_rate)
    records["ntt32"] = narrow_records["ntt32"]
    n16k_records = check_n16k_kernels(par_16k, gen, int32_rate)
    records["ks_accumulate"] = n16k_records["ks_accumulate"]
    wider_records = check_wider_kernels(par_wider, gen, int32_rate)
    dot_records = check_dot_kernels({"dot": par_rot, "n16k": par_16k,
                                     "main": par}, gen, int32_rate)
    records["ct_pt_dot"] = dot_records.pop("dot bench")
    api_records = check_api_kernels(par, gen, int32_rate)
    k1_records = check_single_modulus_kernels(par_k1, gen, int32_rate)
    d128_records = check_default128_kernels(par_d128, gen, int32_rate)

    log("phase 4: main path")
    mp = main_path(par)

    log("phase 5: rate")
    step = mp.step
    a0, a1, b0, b1 = mp.inputs

    def chained():
        c0, c1 = a0, a1
        for _ in range(RATE_STEPS):
            c0, c1 = step(c0, c1, b0, b1)
        return c0

    step_ms = time_ms(chained, 1) / RATE_STEPS
    log(f"  {RATE_STEPS} chained mul+relin steps at batch {BATCH}: "
        f"{step_ms:.3f} ms/step, {BATCH / step_ms * 1e3:.1f} mul+relin/s "
        f"on {card}")

    log("phase 6: rotation path")
    programs = rotation_path(par_rot)

    log("phase 7: rates")
    rot_launches, rot, (r0, r1) = programs["rotate"]

    def chained_rot():
        c0, c1 = r0, r1
        for _ in range(ROT_RATE_STEPS):
            c0, c1 = rot(c0, c1)
        return c0

    rot_ms = time_ms(chained_rot, 1) / ROT_RATE_STEPS
    rot_kernels = side["ntt_rotation"]["ms"] + records["rotate_tail"]["ms"]
    log(f"  {ROT_RATE_STEPS} chained rotations at batch {ROT_BATCH}: "
        f"{rot_ms:.3f} ms/step, {ROT_BATCH / rot_ms * 1e3:.1f} rotations/s, "
        f"kernels {rot_kernels:.3f} ms, glue {rot_ms - rot_kernels:.3f} ms "
        f"on {card}")
    _, inner, (i0, i1) = programs["inner_sum"]

    def chained_sum():
        c0, c1 = i0, i1
        for _ in range(SUM_RATE_STEPS):
            c0, c1 = inner(c0, c1)
        return c0

    sum_ms = time_ms(chained_sum, 1) / SUM_RATE_STEPS
    log(f"  {SUM_RATE_STEPS} chained inner sums at batch {SUM_BATCH}: "
        f"{sum_ms:.3f} ms/step, {SUM_BATCH / sum_ms * 1e3:.1f} inner sums/s "
        f"on {card}")

    log("phase 8: strategy 2, fused extend and square")
    variants = variants_path(par, mp)

    log("phase 9: variant rates")
    for name, (vstep, _) in variants.items():
        def chained_variant(vstep=vstep, square=name == "square"):
            c0, c1 = a0, a1
            for _ in range(RATE_STEPS):
                c0, c1 = vstep(c0, c1) if square else vstep(c0, c1, b0, b1)
            return c0

        v_ms = time_ms(chained_variant, 1) / RATE_STEPS
        log(f"  {RATE_STEPS} chained {name} steps at batch {BATCH}: "
            f"{v_ms:.3f} ms/step, {BATCH / v_ms * 1e3:.1f} ops/s on {card}")

    log(f"phase 10: narrow (w30) path, N = {DEGREE}, 7 x 30-bit")
    narrow = narrow_path(par_w30)

    log("phase 11: narrow rates")
    narrow_rates(narrow, narrow_records, card)

    log(f"phase 12: N = {N16K}, 6 x 62-bit (unfused route)")
    n16k = n16k_path(par_16k, mp.margin)
    n16k_rates(n16k, n16k_records, card)

    log(f"phase 13: multiplication bases above 16 limbs, N = {DEGREE}")
    wider_path(par_wider, card)

    log(f"phase 14: SIMD add + plaintext multiply, N = {TAIL_N4096}, "
        f"2 x 62-bit (BASELINE config 2)")
    addpt_path(par_4096, card)

    log(f"phase 15: dot products of {DOT_PAIRS} pairs, N = {DEGREE}, "
        f"4 x 62-bit")
    dot_launches, _ = dot_path(par_rot, card)

    log("phase 16: the object API at BASELINE config 3")
    object_api_path(par, mp, variants)

    log(f"phase 17: the single-modulus key switch, N = {K1_DEGREE}, 1 x 62-bit")
    single_modulus_path(par_k1)

    log(f"phase 18: default_parameters_128({D128_BITS}), N = {DEGREE}")
    default128_path(par_d128, card)

    # the program whose run gives each kernel's launches
    runs = {"rotate_tail": ("rotation", rot_launches),
            "tensor": ("square", variants["square"][1]),
            "intt_scale": ("default fused mul+relin",
                           variants["default fused"][1]),
            "ntt32": ("narrow mul+relin", narrow["mul_relin"][2]),
            "ks_accumulate": (f"N = {N16K} mul+relin", n16k["mul_relin"][2]),
            "ct_pt_dot": (f"dot product of {DOT_PAIRS} pairs", dot_launches)}
    other_shapes = {
        "ntt": {label: side[label] for label in side
                if label.startswith("ntt_")}
        | {"n16384": n16k_records["ntt"],
           "n16384_rotation": n16k_records["ntt_rotation"]},
        "rns_scale": {"strategy2_kp2": variant_records["rns_scale_s2"],
                      "narrow_int32": narrow_records["rns_scale_int32"],
                      "n16384": n16k_records["rns_scale"]}
        | {label: rec for label, rec in wider_records.items()},
        "tensor": {"n16384": n16k_records["tensor"]},
        "ct_pt_dot": dot_records,
        "ks_accumulate": {"rotation": n16k_records["ks_accumulate_rotation"]}
        | {label: narrow_records[label] for label in
           ("ks_accumulate_int32", "ks_accumulate_int32_rotation")},
        "tensor_intt": {f"strategy2_kp{kp}":
                        variant_records[f"tensor_intt_s2_kp{kp}"]
                        for kp in (1, 2)},
        "intt_scale": {"strategy2_kp2": variant_records["intt_scale_s2"],
                       "general": variant_records["intt_scale_general"]},
        "ntt32": {label: narrow_records[label] for label in
                  ("ntt32_rotation", "ntt32_512_forward", "ntt32_512_inverse")},
        "relin_tail": {label: tails[label] for label in
                       ("relin_tail_8x62", "relin_tail_n4096")},
        "rotate_tail": {"rotate_tail_n4096": tails["rotate_tail_n4096"]},
    }
    for tag, recs in (("object_api", api_records),
                      ("single_modulus", k1_records),
                      ("default128", d128_records)):
        for name, rec in recs.items():
            other_shapes[name][tag] = rec
    tail_keys = ("unfused_ms", "cluster", "blocks_per_sm", "clusters", "plan")
    out = []
    for name, (src, replaces) in kernels.KERNELS.items():
        r = records[name]
        program, launches = runs.get(name, ("mul+relin", mp.launches))
        entry = {
            "name": name, "route": "cuda",
            "source": f"tpufhe_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[name], "program": program,
            "shape": r["shapes"], "equal": True,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "bytes": r["bytes"],
            "int32_muls": r["int32_muls"],
        }
        if name in other_shapes:
            entry["other_shapes"] = {
                label: {k: rec[k] for k in
                        ("ms", "plain_ms", "bound_ms", "bound_by", "split_ms")
                        + tail_keys if k in rec}
                | {"shape": rec.get("shapes", rec.get("label"))}
                for label, rec in other_shapes[name].items()}
        entry |= {k: r[k] for k in ("split_ms",) + tail_keys if k in r}
        out.append(entry)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
