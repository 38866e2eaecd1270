"""Drive tpufhe_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the last line:

1. card: the card's name and power limit (nvidia-smi);
2. build: compile the sixteen CUDA kernels (one nvcc per kernel, in
   parallel; ks_tail from relin_tail.cu, beside K4, and rq_unpack from
   rq_pack.cu, beside rq_pack) and the native
   ChaCha8 / CBD sampler (g++); fails if either does not build;
3. kernels: each kernel against its plain torch version, compared with
   torch.equal, and both timed with CUDA events: first zq_mul (the glue's
   62-bit products, ops/zq.py on the card, whose digit chains are its
   plain versions; the other kernels' plain versions take it for their
   products) at MulPIR's switch-down, (2, L, 16, 2, 8192) rows by a
   (2, 1) column, for every L from 1 to 64, and at innerprod-b64's
   ct_mul_pt, (64, 4, 8192) by a (4, 8192) plaintext, then one
   inner-product step recorded (zq_mul 2); expand_fold (the expansion's
   fold) at mulpir-q16's doublings, (L, 16, 2, 8192) parts over the
   level-1 moduli by the level's monomial, L = 1, 2, 4, ..., 64, with the
   leveled key's addend, and at L = 64 without it, each beside its bytes
   bound; ntt, rns_scale and
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
   basis and ks_accumulate (two addends, and the rotation's one); at the
   same shapes over D = 2 and 4 shards, phase 25's four distributed
   transforms: every rank's ntt_dist and K1 on its shard tables (blocks of
   8192 and 4096 words), the D ranks' blocks side by side (computed in this
   process, the exchange by stacking) torch.equal to K1's whole-row
   transform, rank 0's kernels timed; rns_scale at
   phase 13's extends and down-scales from 17 limbs (int64) and 18
   (int32), its general instance; ks_accumulate on the int32 rows of the
   narrow mul+relin (two addends) and rotation (one); ct_pt_dot at the dot
   bench's (128 terms, 4 x 62-bit at N = 8192), PIR's first dimension (64
   terms, 8 columns, 6 x 62-bit at N = 16384), across its 14-term window
   (15 and 29 terms, 3 x 62-bit), at dot_product_scalar of 16 with two
   and three parts, rq.dot_product of 16 with a batch folded into the rows
   and 29 terms over phase 18's moduli, each with its launch plan
   (instance, ring stages, CTAs per SM); and at the shapes of phases 16,
   17 and 18 every kernel those phases launch: SIMD encoding's and
   decoding's ntt modulo t, public-key encryption's ntt, ct_mul's (ntt, rns_scale, tensor), the relinearization's (ntt and
   rotate_tail; for phase 17's single-modulus key ntt of the two digit
   rows and ks_accumulate), the decryption's (ntt, rns_scale),
   Multiplicator.strategy2(rk, 1)'s over the 4-limb basis (phase 16),
   make_mul_relin's at N = 2048 (phase 17, tensor_intt among them) and on
   phase 18's moduli of 43 and 44 bits (relin_tail among them); and, on
   the inputs each kernel wrapper records in one run of the PIR programs
   (KernelRecorder, after their set-up: keys, database, queries; the
   calls it records per kernel must equal the launch counters' reading
   over that run and the program's exact counts), every distinct call
   of phase 19's database build and response (ntt, rns_scale,
   ks_accumulate, ct_pt_dot) and of phase 20's key generation
   (rns_scale at the Switcher's scale-up, ntt), database build, leveled
   expansion (ntt over the ciphertext's and the key's moduli, ks_tail
   with 2 digit rows over 3 limbs) and response (ct_pt_dot
   at 58 terms x 57 columns, ntt, rns_scale, relin_tail), with ct_pt_dot's
   launch plans, and a batch of 16 queries as the benchmark's mulpir-q16
   serves it (expansion, response, the answer switched to the last level:
   zq_mul 8, expand_fold 7), then that batch's wire path as mulpir-q16
   serves it (its 16
   queries, (1, 2, 8192) at 50/55 bits, parsed and its 16 answers,
   (2, 1, 8192) at 50 bits, serialized: rq_unpack 16, rq_pack 16, ntt
   32) and a Galois key's round trip, each call of rq_pack and rq_unpack
   held to the host transcode, and to_bytes / from_bytes of a query, an
   answer and a Galois key timed per call on the host clock on the card
   route and on the host transcode (the bytes and decoded words equal);
   zq_mul wherever a recorded program makes a product; and
   the second dimension both ways on each program's own
   input, (a) tensor over all j and modular adds, (b) three ct_pt_dot
   (the programs' route), equal and timed, tensor held to its plain
   version there; and, after phase 22, every distinct call of phases 21
   and 22 recorded the same way (a KernelRecorder around each phase, the
   calls recorded per kernel equal to the counters' reading over it), and
   after phase 24 those of phases 23 and 24 (the protocols' and the
   batched programs' ntt, the collective mul+relin's kernels, the
   decryptions' rns_scale; the narrow expansion's and leveled programs'
   ntt32, rns_scale and ks_accumulate): the
   decoders' ntt, the walkthroughs' ntt, rns_scale, tensor and
   rotate_tail at N = 8192, the external product's ntt and ks_accumulate
   at batch 64, make_mul_relin's tensor_intt and relin_tail, rns_scale
   down-scaling by t = 2^127 - 1 (a 127-bit numerator) from the
   11-limb basis, and the applications' PIR calls (SealPIR's two ct_pt_dot
   shapes, its folds' ntt); the lazy forward (tpufhe's lazy flag) of
   ntt at (64, 3, 8192), (8, 2, 4096), N = 512 and 16 and the N = 16384
   split at phase 12's tail (8, 16, 6, 16384), of ntt32 at phase 10's
   (64, 7, 8192) and N = 512, and DistNtt's over D = 2 and 4 at that
   N = 16384 shape (every rank's block, computed in this process): each
   word below 4p and congruent to the plain version (lazy_check; never
   torch.equal, as tpufhe's lazy words are no fixed set of integers), the
   canonical forward timed beside it; ks_tail (the key switch alone) at
   MulPIR's expansion shape (2 digit rows over 3 limbs, 64 rows) and at
   BASELINE config 3's (64 rows, 3 over 3), torch.equal, timed beside
   pipeline.key_switch's other route on the same inputs (unfused_ms: K1 +
   ks_accumulate; lazy_unfused_ms on K1's lazy output), with its plan
   and occupancy, and that route canonical and lazy at N = 16384;
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
   ntt and rotate_tail, and the expansion's expand_fold 4); every slot of
   every output is checked after
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
    make_add then ct_mul_pt by a SIMD plaintext (zq_mul 2), every slot
    checked, chained steps timed (add+pt_mul/s); ct_add_pt, ct_sub_pt and
    ct_neg through the object API, every slot checked;
15. dot products (seed 2032): N = 8192, 4 x 62-bit, 128 SIMD encryptions
    and plaintexts; make_ct_pt_dot and dot_product_scalar over 16 (one
    ct_pt_dot launch each), decrypted against sum v_i w_i mod t, then
    chained dot products timed (dot_products/s);
16. the object API on phase 4's keys and pairs: PublicKey encryption
    (seed 2033; ntt 2, zq_mul 3), ct_mul to three parts (ntt 6,
    rns_scale 3, tensor 1) and their decryption (ntt 1, rns_scale 1,
    zq_mul 3), ct_square (ntt
    4, rns_scale 2, tensor 1), relinearizes (ntt 1, rotate_tail 1),
    Multiplicator.default and strategy2(rk, 1) (ntt 7, rns_scale 3,
    tensor 1, rotate_tail 1), each torch.equal to make_mul_relin's output,
    every slot checked, the noise printed beside phase 4's; the lazy Poly:
    Poly.into_ntt(lazy=True) of a product part (ntt 1), below 4p and
    congruent, times an NttShoup poly (zq_mul 1) torch.equal to the
    canonical product;
17. the single-modulus key switch (seed 2034): N = 2048, 1 x 62-bit,
    batch 16, a relinearization key with log_base 31 and two digit rows;
    ct_mul, relinearizes (ntt 2, ks_accumulate 1) and make_mul_relin (ntt
    3, rns_scale 2, tensor_intt 1, ks_accumulate 1), equal, every slot
    checked;
18. default_parameters_128(20)'s N = 8192 set (seed 2035; 5 moduli of 43
    and 44 bits): public-key encryptions (ntt 2, zq_mul 3 each),
    make_mul_relin
    (phase 4's counts) and Multiplicator.default at batch 16, equal, every
    slot checked, chained steps timed;
19. PIR at BASELINE config 5 (bench.py:509-552; seed 2036): N = 16384,
    6 x 62-bit, t = 65537, dims 8 x 8 (64 SIMD plaintexts of seeded random
    slots, built on the card by encode_pir_database: ntt 2), keys at
    level 0, an expansion of 4 levels; make_pir_response on a batch of 4
    queries, each selecting its own cell, held to its exact counts (ntt
    12, ks_accumulate 5, rns_scale 2, ct_pt_dot 4, expand_fold 4), every
    slot
    of every
    answer checked against its cell, the noise printed, chained responses
    timed (PIR responses/s);
20. MulPIR at its own configuration (tpufhe/models/pir.py:69-77; seed
    2037): N = 8192, moduli of 50, 55 and 55 bits, t = 1,785,857, 65,536
    elements of 1 KiB: dims (58, 57), 3,306 plaintexts in Encoding.poly(1)
    (3,277 of seeded random coefficients below 2^20, the rest zero; ntt
    1); the query at level 1, the expansion keys for level 1 held at level
    0, the relinearization key at level 1 (keygen and upload on the host
    clock); for two queries make_expand(level=1) (7 leveled doublings:
    ntt 21, ks_tail 7, zq_mul 7, expand_fold 7) and
    make_pir_response_db(level=1)
    (ct_pt_dot
    4, ntt 3, rns_scale 2, relin_tail 1), each held to its exact counts,
    the answer switched to the last level and all 8192 coefficients
    checked; the expansion and the response timed apart with CUDA events,
    and inside the expansion each doubling, its key switch and its
    switch-down marked with CUDA events as it runs; then a ciphertext
    switched to each level, Multiplicator.default with mod switching and
    public-key encryptions below the key's level, each decrypted;
21. the wire format (fhe.rs's proto3 messages, byte for byte tpufhe's):
    every object kind (parameters of configs 3, 4 and MulPIR; phase 4's
    secret and relinearization keys; phase 16's public key; phase 6's
    Galois and evaluation keys; phase 20's leveled expansion key,
    level-1 relinearization key and seeded level-1 query; an RGSW
    ciphertext; seeded fresh ciphertexts, a product ciphertext; a Poly in
    each representation) serialized on the card, its length equal to its
    closed form (sum_i nbits_i N / 8 bytes a polynomial, 32 a seed, plus
    the envelope), decoded on the card torch.equal to the original,
    decoded on the CPU and serialized again to the same bytes; the decoded
    ciphertexts decrypted, every slot checked; 64 ciphertexts, the
    relinearization key and MulPIR's expansion key serialized and
    deserialized three times each, ms and MB/s on the host clock, on the
    card route (rq_pack, rq_unpack) and on the host transcode, the same
    bytes;
22. the applications (tpufhe_torch.models) on the card: run_bfv_basic,
    run_bfv_ops and run_rgsw at N = 8192, 3 x 62-bit, t = 65537 (t =
    1153 has no SIMD slots at N = 8192), every result pair equal; the
    external product of phase 4's 64 ciphertexts by one RGSW ciphertext
    (ntt 2, ks_tail 1, ks_accumulate 1), decrypted equal to make_mul_relin
    on the same pairs, chained products timed (external products/s);
    t = 2^127 - 1 at
    N = 8192, 5 x 60-bit (seed 2040): 16 encryptions decrypted, ct_add and
    ct_mul without relinearization (ntt 6, rns_scale 3, tensor 1) of the
    batch, every coefficient against exact Python ints; run_mulpir
    (repeat=2: the seeded index and, warm, index + 1) and run_sealpir at
    65,536 x 1 KiB, N = 8192, MulPIR's t and moduli, each element byte
    for byte, each server phase of each query held to its exact counts
    (MulPIR expand ntt 21, ks_tail 7, zq_mul 7, expand_fold 7, response
    ct_pt_dot 4,
    ntt 5, rns_scale 2, relin_tail 1, zq_mul 1; SealPIR expand the same,
    dot1 ct_pt_dot 1, ntt 2, zq_mul 1, fold none, dot2 ntt 3, ct_pt_dot
    1, zq_mul 1), the report printed; the
    CLI (models.pir.main) for each scheme at 4,096 elements; MulPIR's
    object-API path at 4,096 retrieving what its programs retrieve;
23. multiparty BFV (tpufhe_torch.mbfv; seed 2041) at BASELINE config 3's
    ring with 11 parties (bench.py:422), each step also held to its exact
    zq_mul count (one launch a product): the CRP and the collective public
    key through PublicKeyShare + aggregate (ntt 22) and batched_public_key
    (ntt 2), torch.equal; the collective relinearization key through two
    rounds of RelinKeyGenerator (ntt 165) and batched_relin_keygen (ntt
    4), torch.equal, the same bytes; 128 SIMD encryptions under the
    collective key, make_mul_relin at batch 64 with it (phase 4's counts)
    and Multiplicator.default (phase 16's), torch.equal; the collective
    decryption of all 64 products through DecryptionShare + aggregate and
    batched_decryption, equal, every slot against (va vb) mod t, the noise
    under the sum of the party keys; a SecretKeySwitchShare to 11 other
    party keys and a PublicKeySwitchShare of a level-1 ciphertext to a
    one-party public key, each decrypted by its output key;
    make_sharded_pk_aggregation over an NCCL group of world size 1 on the
    11 stacked shares, equal to aggregate; bench config 6 (bench.py:422-506:
    11 parties, batch 8, N = 4096, 2 x 62-bit): one fused keygen-plus-
    decrypt round (ntt 3, rns_scale 1) held row by row to the object API,
    then chained rounds timed (collective rounds/s, with the kernels' and
    the party sums' share); run_voting at tpufhe's defaults and at N =
    8192, 11 parties, 1,000 voters, both tallies exact;
24. the rest of the narrow (w30) mode (seed 2042) at phase 10's ring: an
    expansion key at level 4 and make_expand of 4 ciphertexts into 16 each
    (ntt32 8, ks_accumulate 4), every coefficient of the 64 outputs
    checked, equal to EvaluationKey.expands on the first; a relinearization
    key and a column-rotation key at level 0 for level-1 ciphertexts:
    ct_mul + relinearizes (ntt32 10, rns_scale 3, ks_accumulate 1) and
    make_rotate (ntt32 4, ks_accumulate 1) at batch 16, every slot checked;
    chained steps of both and repeated expansions timed;
25. multi-GPU (tpufhe_torch.parallel): min(cards, 4) ranks (4 with four
    cards or more, else 2) over NCCL, one card each, or on a one-card
    machine 2 worker processes on the card over gloo (which takes CUDA
    tensors and moves each all_gather through the host), each a
    `chip_smoke.py --parallel-worker` process with a 60 s process-group
    timeout, the phase limited to 300 s; each rank runs DistNtt forward
    and inverse of phase 12's mul+relin input stack (ntt 2, ntt_dist 2),
    make_seq_sharded_mul_relin on phase 12's keys and inputs (N = 16384,
    6 x 62-bit, batch 16: ntt 4, ntt_dist 4, rns_scale 2, tensor 1,
    ks_accumulate 1) and make_sharded_mul_relin on phase 4's (BASELINE
    config 3, batch 64) over the (ranks, 1) and (1, ranks) batch x limb
    meshes (phase 4's counts), each held to its counts on every rank; the
    ranks' blocks side by side torch.equal to K1's whole-row transforms,
    phase 12's make_mul_relin output (every slot decrypted) and phase 4's;
    ms per step per rank and the all_gathers' share by CUDA events.

The second-to-last line is {"kernels": [...]} (sixteen entries; relin_tail
and rotate_tail also carry unfused_ms, cluster, blocks_per_sm and
clusters, ntt, tensor_intt, intt_scale and ntt32 their plan, intt_scale
its split_ms; other_shapes holds each program's records, those of
phases 19 and 20 with the launches of their counted runs there, those of
phases 21 to 24 under wire_format, applications, multiparty and
narrow_rest), the
last one {"ok": true, "device": {...}}. Exits nonzero without a CUDA card.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

# the bound arithmetic: the card's memory peak and the int32 multiplies of
# the modular operations, as the benchmark's roofline reads them
from fhebench.roofline.peaks import (
    HI,
    LO,
    MEM_BYTES_PER_S,
    MULMOD,
    RED128,
    SHOUP,
    SHOUP32,
    TENSOR_OPS,
    ks_digit_ops,
    ntt_ops,
    scale_ops,
)

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
# and rq.dot_product with a batch of 2 folded into the rows, and 29 terms
# over phase 18's moduli
DOT_FOLD = 2
DOT_D128_TERMS = 29
# phase 16: the object API at BASELINE config 3 on phase 4's keys
API_SEED = SEED + 7
API_PRODUCT_LAUNCHES = {"ntt": 6, "rns_scale": 3, "tensor": 1}
API_SQUARE_LAUNCHES = {"ntt": 4, "rns_scale": 2, "tensor": 1}
API_MULTIPLY_LAUNCHES = {"ntt": 7, "rns_scale": 3, "tensor": 1,
                         "rotate_tail": 1}
# the NTTs of Delta m and of the three samples at once; the products
# Delta m, u pk0 and u pk1
PK_ENCRYPT_LAUNCHES = {"ntt": 2, "zq_mul": 3}
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
# phase 19: BASELINE config 5, the PIR server response (bench.py:509-552):
# phase 12's ring, dims 8 x 8 (64 SIMD plaintexts), keys at level 0, an
# expansion of 4 levels, a batch of 4 queries (bench.py's max(2, 64 // 16))
PIR_SEED = SEED + 10
PIR_DIMS = (8, 8)
PIR_BATCH = 4
PIR_RATE_STEPS = 8
# expansion (ntt 2 + ks_accumulate 1 a level, and the fold,
# expand_fold 1), the first dimension and the
# three second-dimension dot products (ct_pt_dot 4), the extend (ntt 2,
# rns_scale 1), the down-scale (ntt 1, rns_scale 1), the unfused
# relinearization (ntt 1, ks_accumulate 1)
PIR_LAUNCHES = {"ntt": 12, "ks_accumulate": 5, "rns_scale": 2, "ct_pt_dot": 4,
                "expand_fold": 4}
# SIMD rows: the inverse NTT over t, then the forward over q
PIR_DB_LAUNCHES = {"ntt": 2}
# phase 20: MulPIR at its own configuration (tpufhe/models/pir.py:69-77,
# examples/mulpir.rs): N = 8192, moduli of 50, 55 and 55 bits, t =
# 2^20 + 2^19 + 2^17 + 2^16 + 2^14 + 1, 65,536 elements of 1 KiB; the query
# at level 1, expansion keys at level 0, the relinearization key at level 1
MULPIR_DEGREE = 8192
MULPIR_MODULI_SIZES = [50, 55, 55]
MULPIR_PLAINTEXT = (1 << 20) + (1 << 19) + (1 << 17) + (1 << 16) + (1 << 14) + 1
MULPIR_ELEMENTS = 65536
MULPIR_ELEMENT_BYTES = 1024
# elements a plaintext, rows, dims and expansion levels, as tpufhe's
# encode_database and its own run give them (benches/logs/pir_paper_r5.log)
MULPIR_SHAPE = (20, 3277, 58, 57, 7)
MULPIR_SEED = SEED + 11
MULPIR_QUERIES = 2
MULPIR_REPS = 5
# each of the 7 leveled doublings: K1 inverse, ks_tail (the key switch of
# the 2 digit rows over the key's 3 moduli), K1 inverse there, the
# switch-down (its Shoup product), K1 forward over the ciphertext's 2, the
# fold (expand_fold)
MULPIR_EXPAND_LAUNCHES = {"ntt": 21, "ks_tail": 7, "zq_mul": 7,
                          "expand_fold": 7}
# ct_pt_dot 4, the extend (ntt 2, rns_scale 1), the down-scale (ntt 1,
# rns_scale 1), the relinearization on K4 (N = 8192)
MULPIR_RESPONSE_LAUNCHES = {"ct_pt_dot": 4, "ntt": 3, "rns_scale": 2,
                            "relin_tail": 1}
MULPIR_DB_LAUNCHES = {"ntt": 1}
# mulpir-q16's batch of 16 queries as the benchmark serves it: the
# expansion (7 doublings: a Shoup product in the switch-down, the fold on
# expand_fold), the response and the switch of its answer to the last level
# (ntt 2, a Shoup product in the switch-down)
MULPIR_BATCH = 16
# the batch's wire path (mulpir-q16's): a K1 forward and an rq_unpack a
# query parsed, a K1 inverse and an rq_pack an answer serialized
MULPIR_WIRE_LAUNCHES = {"ntt": 2 * MULPIR_BATCH, "rq_unpack": MULPIR_BATCH,
                        "rq_pack": MULPIR_BATCH}
# to_bytes and from_bytes timed per call, each route
WIRE_CALL_REPS = 20
MULPIR_BATCH_LAUNCHES = {"ntt": 26, "ks_tail": 7, "ct_pt_dot": 4,
                         "rns_scale": 2, "relin_tail": 1, "zq_mul": 8,
                         "expand_fold": 7}
# phase 3's zq_mul (the glue's 62-bit products) at the shapes of the
# benchmark's glue-bound cells: MulPIR's switch-down, (2, L, 16, 2, 8192)
# rows by a (2, 1) column, at every L from 1 to 64 (a batch of 16 holds
# 2^l ciphertexts at doubling l), and innerprod-b64's step product,
# ct_mul_pt of (64, 4, 8192) parts by a (4, 8192) plaintext: 2 Barrett
# products; and expand_fold at the fold of each of MulPIR's 7 doublings,
# (2^l, 16, 2, 8192)
ZQ_FOLD_MAX = 64
IP_BATCH = 64
IP_LAUNCHES = {"zq_mul": 2}
# the key generation: the forward NTTs of the keys' rows and secrets (ntt
# 32) and the Switcher's scale-up of s and s^2 into the key context
# (rns_scale 7), and the keys' products (zq_mul 17)
MULPIR_KEYGEN_LAUNCHES = {"ntt": 32, "rns_scale": 7, "zq_mul": 17}
# phase 21: the wire format at BASELINE config 3 (phase 4's parameters),
# ciphertexts and keys timed through serialization WIRE_REPS times
WIRE_SEED = SEED + 12
WIRE_REPS = 3
# phase 22: the applications. The walkthroughs run at degree 8192 with
# phase 4's t = 65537: BfvParameters.default's t = 1153 has no SIMD slots
# there (the batch encoder needs 2N | t - 1, and 1152 = 2^7 9)
APP_MODULI = 3
RGSW_SEED = SEED + 13
RGSW_BATCH = BATCH
RGSW_CHAIN = 8
# K1 inverse of both parts, then the first key switch on ks_tail and the
# second, which accumulates onto the first, K1 of its digits and
# ks_accumulate
RGSW_LAUNCHES = {"ntt": 2, "ks_tail": 1, "ks_accumulate": 1}
BIGT_PLAINTEXT = (1 << 127) - 1  # the reference's big t (biguint.rs)
BIGT_MODULI_SIZES = [60] * 5
BIGT_SEED = SEED + 14
BIGT_BATCH = 16
BIGT_SPARSE = 4  # nonzero coefficients of each product's second operand
BIGT_MUL_LAUNCHES = API_PRODUCT_LAUNCHES
PIR_CLI_ELEMENTS = 4096
# the PIR server phases of models/pir.py per query, fused: MulPIR's
# expansion and response (make_pir_response_db, then the switch of the
# answer to the last level: ntt 2, and its switch-down's Shoup product);
# SealPIR's expansion, its first
# dimension (one ct_pt_dot, the batched switch to the last level), the
# host fold, and its second dimension (the folds encoded in one K1
# launch, one ct_pt_dot, the switch)
MULPIR_APP_LAUNCHES = {
    "expand": MULPIR_EXPAND_LAUNCHES,
    "response": {"ct_pt_dot": 4, "ntt": 5, "rns_scale": 2, "relin_tail": 1,
                 "zq_mul": 1}}
SEALPIR_APP_LAUNCHES = {"expand": MULPIR_EXPAND_LAUNCHES,
                        "dot1": {"ct_pt_dot": 1, "ntt": 2, "zq_mul": 1},
                        "fold": {},
                        "dot2": {"ntt": 3, "ct_pt_dot": 1, "zq_mul": 1}}
# phase 23: multiparty BFV at BASELINE config 3's ring (phase 4's
# parameters) with bench.py's 11 parties (bench.py:422)
MBFV_SEED = SEED + 15
MBFV_PARTIES = 11
MBFV_BATCH = BATCH
# bench config 6 (bench.py:422-506): 11 parties, batch 8, N = 4096,
# 2 x 62-bit, bench.py's t = 1153 (bench.py:81) and keys from seed 42
# (bench.py:93), ciphertexts of numpy seed 9; four chained rounds a step
MBFV_BENCH_DEGREE = 4096
MBFV_BENCH_MODULI_SIZES = [62, 62]
MBFV_BENCH_PLAINTEXT = 1153
MBFV_BENCH_BATCH = 8
MBFV_BENCH_INNER = 4
MBFV_BENCH_STEPS = 16
# the s, e and phase NTTs, and the round's two products
MBFV_BENCH_LAUNCHES = {"ntt": 3, "rns_scale": 1, "zq_mul": 2}
VOTING_DEGREE = 8192  # one 62-bit modulus, run_voting's default
VOTING_VOTERS = 1000
# phase 24: the rest of the narrow (w30) mode at phase 10's ring
NARROW_REST_SEED = SEED + 16
NARROW_LEVELED_BATCH = 16
NARROW_REST_STEPS = 32
# ct_mul (K9 inverse and forward of each operand's extend, of the
# down-scale; K2 for the two extends and the down-scale) then the leveled
# relinearization (K9 inverse of c2, forward of its digits over the key's
# moduli, inverse there, forward after the switch-down; ks_accumulate)
NARROW_LEVELED_MUL_LAUNCHES = {"ntt32": 10, "rns_scale": 3,
                               "ks_accumulate": 1}
NARROW_LEVELED_ROT_LAUNCHES = {"ntt32": 4, "ks_accumulate": 1}
# phase 3's distributed NTT (D shards of phase 12's ring) and phase 25, the
# multi-GPU programs: ranks over NCCL (one card each) or, on one card, two
# processes over gloo; each worker's process-group timeout and the phase's
# limit, start-up included
DIST_SHARDS = (2, 4)
PAR_PG_TIMEOUT = 60
PAR_TIMEOUT = 300
PAR_RATE_STEPS = 4
SEQ_LAUNCHES = {"ntt": 4, "ntt_dist": 4, "rns_scale": 2, "tensor": 1,
                "ks_accumulate": 1}
DIST_LAUNCHES = {"ntt": 2, "ntt_dist": 2}  # one forward, one inverse
INT32_MULS_PER_CLOCK_PER_SM = 64  # CUDA C++ Programming Guide, cc 9.0


_STARTED = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's header line also gets the script's elapsed
    seconds."""
    if msg.startswith("phase "):
        msg = f"{msg} [{time.perf_counter() - _STARTED:.1f} s]"
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


def run_case(name, label, kfn, pfn, int32_rate, nbytes, ops,
             check=None) -> dict:
    """One kernel call against its plain version: torch.equal, or for a
    lazy output check(got, want) -> (agrees, max_abs_err, note)
    (lazy_check); then both timed. Raises SystemExit if they disagree."""

    def as_tensor(out):
        return torch.stack(out) if isinstance(out, tuple) else out

    got = as_tensor(kfn())
    want = as_tensor(pfn())
    torch.cuda.synchronize()
    if check is None:
        equal = torch.equal(got, want)
        err = int((got - want).abs().max().item())
        note = ""
    else:
        equal, err, note = check(got, want)
    log(f"  {name} {label}: equal={equal} max_abs_err={err}{note}")
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


def lazy_check(tables, sl):
    """run_case's check of a lazy forward (K1, K9) on limbs `sl` of
    `tables`: every word, read as unsigned (a word of a 62-bit p may read
    as a negative int64, a narrow one as a negative int32), below 4p, and
    congruent mod p to the plain version's canonical word; the note gives
    the share of words at or above p."""
    from tpufhe_torch.ops import zq

    p = tables.p[sl].long()[:, None]

    def check(got, want):
        if tables.narrow:
            u = got.long() & 0xFFFFFFFF
            below = bool((u < 4 * p).all())
            canon = torch.remainder(u, p).to(got.dtype)
        else:  # w < 4p exactly when floor(w / 2) < 2p, which fits an int64
            below = bool((((got >> 1) & 0x7FFFFFFFFFFFFFFF) < 2 * p).all())
            canon = zq.reduce_u64(got, tables.mod[sl])
        err = int((canon - want).abs().max().item())
        above = float((canon != got).float().mean().item())
        return (below and torch.equal(canon, want), err,
                f" (lazy: below 4p {below}, congruent, {above:.4f} of the "
                f"words at or above p)")

    return check


def k1_case(label, x, tables, sl, inverse, lazy=False):
    """A run_cases item for K1 on (..., k_sel, n) rows of `tables` (limbs
    `sl`): each row read and written once, plus its twiddle tables. lazy:
    the lazy forward, held by lazy_check (a sixth element)."""
    from tpufhe_torch.ops import ntt as ntt_mod

    k_sel, n = x.shape[-2:]
    mod = tables.mod[sl]
    if inverse:
        pfn = (lambda: ntt_mod.backward_plain(x, tables.zetas_inv[sl],
                                              tables.ninv[sl], mod))
    else:
        pfn = lambda: ntt_mod.forward_plain(x, tables.omegas[sl], mod)  # noqa: E731
    direction = "lazy forward" if lazy else (
        "inverse" if inverse else "forward")
    return (f"{direction} {label} {tuple(x.shape)}",
            lambda: ntt_mod.ntt_cuda(x, tables, sl, inverse, lazy), pfn,
            2 * x.numel() * 8 + 2 * k_sel * n * 8,
            x.numel() // n * ntt_ops(n, inverse)) + (
                (lazy_check(tables, sl),) if lazy else ())


def k9_case(label, x, tables, sl, inverse, lazy=False):
    """A run_cases item for K9 on (..., k_sel, n) int32 rows of narrow
    `tables` (limbs `sl`): each row read and written once, plus its
    twiddle tables. lazy: as k1_case."""
    from tpufhe_torch.ops import ntt as ntt_mod

    k_sel, n = x.shape[-2:]
    if inverse:
        pfn = (lambda: ntt_mod.backward32_plain(
            x, tables.zetas_inv[sl], tables.ninv[sl], tables.p[sl]))
    else:
        pfn = lambda: ntt_mod.forward32_plain(x, tables.omegas[sl], tables.p[sl])  # noqa: E731
    direction = "lazy forward" if lazy else (
        "inverse" if inverse else "forward")
    return (f"{direction} {label} {tuple(x.shape)}",
            lambda: ntt_mod.ntt32_cuda(x, tables, sl, inverse, lazy), pfn,
            2 * x.numel() * 4 + 2 * k_sel * n * 4,
            x.numel() // n * ntt_ops(n, inverse, SHOUP32)) + (
                (lazy_check(tables, sl),) if lazy else ())


def k2_case(label, scaler, x, start, size):
    """A run_cases item for K2 on x (..., k_in, n) into `size` rows."""
    k_in, n = x.shape[-2:]
    coeffs = x.numel() // k_in
    return (f"{label} {tuple(x.shape)} -> {size} limbs",
            lambda: scaler.scale_cuda(x, start, size),
            lambda: scaler.scale_plain(x, start, size),
            (x.numel() + coeffs * size) * x.element_size(),
            scale_ops(scaler.factor.is_one, k_in, size, coeffs))


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
            b * k * (k * ks_digit_ops(ctx.moduli, ctx.degree) + 2 * ntt_ops(n, False)))


def k5_case(label, ctx, s0, c2, key):
    """A run_cases item for K5 on (B, k, N) s0 and c2 with a random Garner
    key."""
    from tpufhe_torch import pipeline

    k, n = s0.shape[-2:]
    b = s0.numel() // (k * n)
    return (f"{label} s0, c2 {tuple(s0.shape)} + ksk 4 x {(k, k, n)} -> "
            f"(2, {', '.join(map(str, s0.shape))})",
            lambda: pipeline.rotate_tail_cuda(ctx, s0, c2, key),
            lambda: pipeline.rotate_tail_plain(ctx, s0, c2, key),
            (4 * b * k * n + 4 * k * k * n + 2 * k * n) * 8,
            b * k * k * ks_digit_ops(ctx.moduli, ctx.degree))


def ks_tail_case(label, ctx, c2, key):
    """A run_cases item for ks_tail on power-basis c2 (..., d, N) with a
    Garner key of d rows over ctx's k limbs: c2 and the key read once (the
    key stays in L2), the two outputs written once, the forward tables;
    per (row, limb) d digit transforms and Shoup products."""
    from tpufhe_torch import pipeline

    k, n, d = ctx.k, ctx.degree, c2.shape[-2]
    rows = c2.numel() // (d * n)
    return (f"{label} c2 {tuple(c2.shape)} + ksk 4 x {(d, k, n)} -> "
            f"{(2,) + tuple(c2.shape[:-2]) + (k, n)}",
            lambda: pipeline.ks_tail_cuda(ctx, c2, key),
            lambda: pipeline.ks_tail_plain(ctx, c2, key),
            (c2.numel() + 4 * d * k * n + 2 * k * n + 2 * rows * k * n) * 8,
            rows * k * d * ks_digit_ops(ctx.moduli, ctx.degree))


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
             batch * k * (k * ks_digit_ops(ctx.moduli, ctx.degree) + 2 * ntt_ops(n, False)))],
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
             batch * k * k * ks_digit_ops(ctx.moduli, ctx.degree))], int32_rate, "per call")
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
    """run_case over (label, kernel_fn, plain_fn, bytes, ops[, check])
    items whose launches make up one step; returns the step's record
    (times and bound summed over the items)."""
    runs = [run_case(name, label, kfn, pfn, int32_rate, nbytes, ops, *check)
            for label, kfn, pfn, nbytes, ops, *check in items]
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
                rows * k * ntt_ops(n, True)
                + scale_ops(scaler.factor.is_one, k, size, rows * n))

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
        BATCH * 12 * ntt_ops(1024, True)
        + scale_ops(g_scaler.factor.is_one, 12, 1, BATCH * 1024))
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
    from tpufhe_torch.ops.rq import Context

    ctx = par.context_at_level(0)
    mp = par.context_level_at(0).mul_params()
    ctx_mul = mp.to_ctx
    k, k_mul, n = ctx.k, ctx_mul.k, ctx.degree
    t_ctx, t_mul = ctx.tables, ctx_mul.tables

    k9 = k9_case
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


def dist_case(label, blocks, plan, sl, inverse):
    """A run_cases item for ntt_dist on the D gathered blocks (D, ...,
    k_sel, B) of one rank: each block read once, the rank's block written
    once; D Shoup products a word."""
    from tpufhe_torch.parallel import ntt_dist as nd

    w, ws = ((plan.w_inv, plan.w_inv_shoup) if inverse
             else (plan.w, plan.w_shoup))
    start = sl.indices(w.shape[0])[0]
    shards, words = blocks.shape[0], blocks[0].numel()
    direction = "inverse" if inverse else "forward"
    return (f"{direction} {label} {tuple(blocks.shape)} rank {plan.rank}",
            lambda: nd.cross_cuda(blocks, w, ws, plan.tables.p, start),
            lambda: nd.cross_plain(blocks, w[sl], ws[sl], plan.tables.mod[sl]),
            (shards + 1) * words * 8 + 2 * w[sl].numel() * 8,
            shards * words * SHOUP)


def check_dist_kernels(par, gen, int32_rate: float) -> dict:
    """Phase 3, the distributed NTT at phase 12's shapes (N = 16384, 6 x
    62-bit, batch 16) over D = 2 and 4 shards, at the four transforms of
    phase 25's sequence-sharded mul+relin (the extend's inverse, the
    forward of the 7 new limbs, the inverse of the tensor over the 13-limb
    basis, the tail's forward of 2 + 6 parts): every rank's ntt_dist and
    K1 on its shard tables held torch.equal to their plain versions, the D
    ranks' blocks side by side (computed in this process, the exchange by
    stacking) torch.equal to K1's whole-row transform; rank 0's kernels
    timed. Returns {"ntt_dist_d{D}": record, "ntt_d{D}": record}."""
    from tpufhe_torch.ops import ntt as ntt_mod
    from tpufhe_torch.parallel import ntt_dist as nd

    ctx = par.context_at_level(0)
    ctx_mul = par.context_level_at(0).mul_params().to_ctx
    k, k_mul, n, b = ctx.k, ctx_mul.k, ctx.degree, N16K_BATCH
    transforms = [("extend", ctx, (4, b, k), slice(None), True),
                  (f"new limbs {k}..{k_mul}", ctx_mul, (4, b, k_mul - k),
                   slice(k, k_mul), False),
                  ("tensor parts", ctx_mul, (3, b, k_mul), slice(None), True),
                  ("tail", ctx, (2 + k, b, k), slice(None), False)]
    out = {}
    for shards in DIST_SHARDS:
        blk = n // shards
        cross_items, k1_items = [], []
        for label, c, lead, sl, inverse in transforms:
            plans = [nd.DistNttPlan.new(c, shards, e) for e in range(shards)]
            x = rand_residues(lead + (n,), c.tables.p[sl], gen)
            parts = [x[..., e * blk:(e + 1) * blk].contiguous()
                     for e in range(shards)]
            if inverse:
                sent = torch.stack([ntt_mod.ntt_cuda(xe, pl.tables, sl, True)
                                    for xe, pl in zip(parts, plans)])
            else:
                sent = torch.stack(parts)
            got = []
            for e, plan in enumerate(plans):
                item = dist_case(f"{label} D = {shards}", sent, plan, sl,
                                 inverse)
                y = item[1]()
                if not torch.equal(y, item[2]()):
                    raise SystemExit(f"ntt_dist disagrees with its plain "
                                     f"version at {item[0]}")
                k1 = k1_case(f"shard {e} of {shards} {label}",
                             parts[e] if inverse else y, plan.tables, sl,
                             inverse)
                z = k1[1]()
                if not torch.equal(z, k1[2]()):
                    raise SystemExit(f"K1 on shard tables disagrees with its "
                                     f"plain version at {k1[0]}")
                got.append(y if inverse else z)
                if e == 0:
                    cross_items.append(item)
                    k1_items.append(k1)
            whole = ntt_mod.ntt_cuda(x, c.tables, sl, inverse)
            if not torch.equal(torch.cat(got, dim=-1), whole):
                raise SystemExit(f"the {shards} shards' {label} transform "
                                 f"differs from K1's whole-row one")
            log(f"  D = {shards} {label} {tuple(x.shape)}: {shards} ranks' "
                f"blocks side by side equal K1's whole-row transform")
        per = f"per rank of a D = {shards} sequence-sharded mul+relin"
        out[f"ntt_dist_d{shards}"] = run_cases("ntt_dist", cross_items,
                                               int32_rate, per)
        out[f"ntt_d{shards}"] = run_cases("ntt", k1_items, int32_rate, per)
    return out


def check_lazy_kernels(ctxs, gen, int32_rate: float) -> dict:
    """Phase 3, the lazy forward (tpufhe's `lazy` flag, words left below
    4p) of K1 at BASELINE config 3's (64, 3, 8192), config 2's
    (8, 2, 4096), at N = 512 and 16 (the general instance, k = 3, 4 rows)
    and at N = 16384 (the split, phase 12's tail forward of 2 + 6 parts at
    batch 16), and of K9 at phase 10's (64, 7, 8192) and at N = 512: each
    output every word below 4p and congruent to the plain version
    (lazy_check), both timed, the canonical forward's time on the same
    rows beside it (canonical_ms). Then DistNtt's lazy forward at phase
    12's tail shape over D = 2 and 4 (every rank's forward_post computed in
    this process, the exchange by stacking): each rank's block below 4p and
    congruent to K1's whole-row transform, rank 0's lazy K1 on its shard
    tables timed. Returns {label: record}."""
    from tpufhe_torch.bfv import BfvParametersBuilder
    from tpufhe_torch.ops.ntt import ntt_transform
    from tpufhe_torch.ops.rq import Context
    from tpufhe_torch.parallel import ntt_dist as nd

    def small(n, bits):
        moduli = BfvParametersBuilder.generate_moduli([bits] * 3, n)
        return Context(moduli, n, narrow=bits <= 30)

    n16k = ctxs["n16k"]
    out = {}
    for label, ctx, lead in (("n8192", ctxs["main"], (BATCH,)),
                             ("n4096", ctxs["n4096"], (8,)),
                             ("n512", small(512, 62), (4,)),
                             ("n16", small(16, 62), (4,)),
                             ("n16384", n16k, (2 + n16k.k, N16K_BATCH)),
                             ("narrow_n8192", ctxs["narrow"], (BATCH,)),
                             ("narrow_n512", small(512, 30), (4,))):
        tb = ctx.tables
        x = rand_residues(lead + (ctx.k, ctx.degree), tb.p, gen)
        kernel, case = (("ntt32", k9_case) if ctx.narrow else ("ntt", k1_case))
        rec = run_cases(kernel, [case(label, x, tb, slice(None), False, True)],
                        int32_rate, "per call")
        rec["canonical_ms"] = time_ms(lambda: ntt_transform(x, tb), 20)
        out[f"{kernel}_lazy_{label}"] = rec
        log(f"  {kernel} lazy {label}: {rec['ms']:.4f} ms, the canonical "
            f"forward {rec['canonical_ms']:.4f} ms")
    n, tb = n16k.degree, n16k.tables
    x = rand_residues((2 + n16k.k, N16K_BATCH, n16k.k, n), tb.p, gen)
    whole = ntt_transform(x, tb)
    for shards in DIST_SHARDS:
        blk = n // shards
        plans = [nd.DistNttPlan.new(n16k, shards, e) for e in range(shards)]
        blocks = torch.stack([x[..., e * blk:(e + 1) * blk]
                              for e in range(shards)])
        check = lazy_check(tb, slice(None))
        for e, plan in enumerate(plans):
            agrees, err, note = check(nd.forward_post(blocks, plan, lazy=True),
                                      whole[..., e * blk:(e + 1) * blk])
            if not agrees:
                raise SystemExit(f"DistNtt lazy forward, rank {e} of {shards}: "
                                 f"max_abs_err {err}{note}")
        log(f"  DistNtt lazy forward D = {shards} {tuple(x.shape)}: every "
            f"rank's block below 4p and congruent to K1's whole-row transform")
        y = nd.cross_cuda(blocks, plans[0].w, plans[0].w_shoup,
                          plans[0].tables.p, 0)
        out[f"ntt_lazy_dist_d{shards}"] = run_cases("ntt", [k1_case(
            f"shard 0 of {shards}", y, plans[0].tables, slice(None), False,
            True)], int32_rate, f"per rank of a D = {shards} forward")
    return out


def check_ks_tail(ctxs, gen, int32_rate: float) -> dict:
    """Phase 3, ks_tail (the key switch alone, tpufhe's mode ks_only) with
    random Garner keys: at MulPIR's expansion shape (2 digit rows over the
    key's 3 limbs of 50, 55, 55 bits; 64 rows, its last doubling) and at
    BASELINE config 3's (64 rows, 3 over 3), torch.equal to ks_tail_plain,
    timed beside the route it replaces on the same inputs (unfused_ms:
    pipeline.key_switch's other branch, the digits, K1 and ks_accumulate)
    and beside that route on K1's lazy output (lazy_unfused_ms, its output
    torch.equal), with its launch plan and occupancy. Then that route
    canonical and lazy at phase 12's rotation shape (N = 16384, 6 digit
    rows, batch 16, one addend), where ks_tail does not run. Returns
    {label: record}."""
    from tpufhe_torch import kernels, pipeline
    from tpufhe_torch.ops.ntt import ntt_transform
    from tpufhe_torch.ops.rq import Context

    def unfused(ctx, c2, key, lazy, add0=None):
        lifted = ntt_transform(pipeline.ksk_rows(ctx, c2, key), ctx.tables,
                               lazy=lazy)
        return pipeline.ks_accumulate_cuda(ctx, lifted, key, add0)

    out = {}
    for label, ctx, d, rows in (("mulpir", ctxs["mulpir"], 2, 64),
                                ("n8192", ctxs["main"], 3, BATCH)):
        k, n = ctx.k, ctx.degree
        key = random_key(ctx, gen)
        for name in ("c0", "c0_shoup", "c1", "c1_shoup"):
            setattr(key, name, getattr(key, name)[:d])
        key.ctx_ciphertext = Context(ctx.moduli[:d], n)
        c2 = rand_residues((rows, d, n), ctx.tables.p[:d], gen)
        rec = run_cases("ks_tail", [ks_tail_case(label, ctx, c2, key)],
                        int32_rate, "per call")
        want = pipeline.ks_tail_cuda(ctx, c2, key)
        if not torch.equal(unfused(ctx, c2, key, True), want):
            raise SystemExit(f"ks_tail {label}: K1 lazy + ks_accumulate "
                             f"differs")
        rec["unfused_ms"] = time_ms(lambda: unfused(ctx, c2, key, False), 20)
        rec["lazy_unfused_ms"] = time_ms(lambda: unfused(ctx, c2, key, True),
                                         20)
        out[f"ks_tail_{label}"] = rec | occupancy(kernels.function(
            "ks_tail", "tpufhe_ks_tail_occupancy", OCC_ARGS), d, n)
        r = out[f"ks_tail_{label}"]
        log(f"  ks_tail {label}: {r['ms']:.4f} ms, unfused {r['unfused_ms']:.4f}"
            f" ms, lazy unfused {r['lazy_unfused_ms']:.4f} ms; cluster "
            f"{r['cluster']} x {r['threads']} threads, {r['smem_bytes']} "
            f"shared bytes, {r['blocks_per_sm']} CTAs per SM, "
            f"{r['clusters']} clusters at once")
    ctx = ctxs["n16k"]
    key = random_key(ctx, gen)
    c2 = rand_residues((N16K_BATCH, ctx.k, ctx.degree), ctx.tables.p, gen)
    s0 = rand_residues((N16K_BATCH, ctx.k, ctx.degree), ctx.tables.p, gen)
    if not torch.equal(unfused(ctx, c2, key, True, s0),
                       unfused(ctx, c2, key, False, s0)):
        raise SystemExit("K1 lazy + ks_accumulate differs at N = 16384")
    rec = {"canonical_ms": time_ms(lambda: unfused(ctx, c2, key, False, s0),
                                   20),
           "lazy_ms": time_ms(lambda: unfused(ctx, c2, key, True, s0), 20)}
    log(f"  K1 + ks_accumulate at N = 16384 (c2 {tuple(c2.shape)}, one "
        f"addend): canonical {rec['canonical_ms']:.4f} ms, on K1's lazy "
        f"output {rec['lazy_ms']:.4f} ms, equal")
    out["unfused_lazy_n16384"] = rec
    return out


def zq_case(label, a, b, b_shoup, m):
    """A run_cases item for zq_mul: a b mod p by Barrett's method (b_shoup
    None) or Shoup's, against the digit chain of its mode. Bytes: every
    output word and each operand's own words once (a broadcast operand is
    read again from L2), the moduli's constants."""
    from tpufhe_torch.ops import zq

    ops = (a, b) if b_shoup is None else (a, b, b_shoup)
    words = math.prod(torch.broadcast_shapes(*(t.shape for t in ops),
                                             m.p.shape))
    if b_shoup is None:
        mode, per = "Barrett", MULMOD
        pfn = lambda: zq.mul_plain(a, b, m)  # noqa: E731
    else:
        mode, per = "Shoup", SHOUP
        pfn = lambda: zq.mul_shoup_plain(a, b, b_shoup, m)  # noqa: E731
    return (f"{mode} {label} {tuple(a.shape)} x {tuple(b.shape)}",
            lambda: zq.mul_cuda(a, b, b_shoup, m), pfn,
            8 * (words + sum(t.numel() for t in ops)
                 + (2 if b_shoup is None else 1) * m.p.numel()),
            words * per)


def rq_pack_case(label, ctx, x):
    """A run_cases item for rq_pack: the packed words of the (m, k, N)
    words x (the flag's word last) against the host transcode's bytes in
    the same layout. Bytes: each word read once, each packed byte
    written once; no arithmetic."""
    from tpufhe_torch.serialize import rq_pack

    nbits = [q.nbits for q in ctx.q]
    row = sum(nbits) * ctx.degree // 8

    def plain():
        rows = rq_pack.pack_plain(ctx, x).reshape(-1)
        words = np.zeros((rows.size + 7) // 8 + 1, np.int64)
        words.view(np.uint8)[:rows.size] = rows
        return torch.from_numpy(words).to(x.device)

    return (f"{label} {tuple(x.shape)} at {nbits} bits",
            lambda: rq_pack.rq_pack_cuda(ctx, x), plain,
            x.numel() * x.element_size() + x.shape[0] * row, 0)


def rq_unpack_case(label, ctx, packed, m):
    """A run_cases item for rq_unpack: the words of m packed rows against
    the host transcode's (unpack_plain, which also uploads them). Bytes:
    each packed byte read once, each word written once."""
    from tpufhe_torch.serialize import rq_pack

    nbits = [q.nbits for q in ctx.q]
    row = sum(nbits) * ctx.degree // 8
    raw = packed.cpu().numpy().view(np.uint8)[:m * row].reshape(m, row)
    payloads = [r.tobytes() for r in raw]
    word = 4 if ctx.narrow else 8
    return (f"{label} {m} rows of {ctx.k} x {ctx.degree} at {nbits} bits",
            lambda: rq_pack.rq_unpack_cuda(ctx, packed, m),
            lambda: rq_pack.unpack_plain(ctx, payloads),
            m * row + m * ctx.k * ctx.degree * word, 0)


@contextlib.contextmanager
def host_transcode():
    """The wire codec's host route on the card's tensors while active (the
    words copied to the host and packed by numpy, the payloads unpacked by
    numpy and uploaded), the codec before rq_pack and rq_unpack."""
    from tpufhe_torch.serialize import rq_pack

    saved = rq_pack.on_card
    rq_pack.on_card = lambda x: False
    try:
        yield
    finally:
        rq_pack.on_card = saved


def wire_call_ms(fn, reps: int = WIRE_CALL_REPS) -> float:
    """Median host ms of fn() a call, each call ending on a synchronize,
    after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def wire_calls(m: SimpleNamespace, answer, card: str) -> dict:
    """Phase 3, to_bytes and from_bytes per call at mulpir-q16's objects:
    a query (level 1, seeded: one part), an answer (two parts at level 2)
    and one of the expansion's Galois keys (level 0, seeded: its c0 rows),
    on the card route and on the host transcode (host_transcode): the same
    bytes and the same decoded words both ways, then each timed
    (wire_call_ms). Returns {object: {"bytes", "to_ms", "from_ms",
    "host_to_ms", "host_from_ms"}}."""
    from tpufhe_torch.bfv import Ciphertext, GaloisKey

    gk = next(iter(m.ek.gk.values()))
    out = {}
    for name, obj, decode in (
            ("query", m.query_cts[0], Ciphertext.from_bytes),
            ("answer", answer, Ciphertext.from_bytes),
            ("Galois key", gk, GaloisKey.from_bytes)):
        data = obj.to_bytes()
        back = decode(data, m.par)
        with host_transcode():
            host_data = obj.to_bytes()
            host_back = decode(data, m.par)
            host_to = wire_call_ms(obj.to_bytes)
            host_from = wire_call_ms(lambda: decode(data, m.par))
        if data != host_data or not same_state(back, host_back) or \
                not same_state(back, obj):
            raise SystemExit(f"wire: the card route's {name} differs from "
                             f"the host transcode's")
        rec = {"bytes": len(data), "to_ms": wire_call_ms(obj.to_bytes),
               "from_ms": wire_call_ms(lambda: decode(data, m.par)),
               "host_to_ms": host_to, "host_from_ms": host_from}
        log(f"  wire {name}: {len(data)} bytes, to_bytes {rec['to_ms']:.3f} "
            f"ms (host transcode {host_to:.3f}), from_bytes "
            f"{rec['from_ms']:.3f} ms (host transcode {host_from:.3f}), "
            f"the same bytes and words, host clock on {card}")
        out[name] = rec
    return out


def check_zq_mul_kernels(par_mulpir, par_ip, gen, int32_rate: float) -> dict:
    """Phase 3, zq_mul at the benchmark's glue-bound shapes (ZQ_FOLD_MAX):
    MulPIR's switch-down (its q_last^-1 column over the level-1 moduli of
    50 and 55 bits) at every L from 1 to 64, and innerprod-b64's ct_mul_pt;
    then one inner-product step's ct_mul_pt on a (64, 4, 8192) ciphertext
    recorded (KernelRecorder) and held to IP_LAUNCHES and, call by call,
    to its plain version. Returns {label: record}."""
    from tpufhe_torch.bfv import Ciphertext, Encoding, Plaintext
    from tpufhe_torch.bfv.ops import ct_mul_pt
    from tpufhe_torch.ops.rq import _switch_tables

    ctx0, ctx1 = par_mulpir.context_at_level(0), par_mulpir.context_at_level(1)
    k, n = ctx1.k, ctx1.degree
    inv, inv_shoup, _ = _switch_tables(ctx0)
    down = rand_residues((2, ZQ_FOLD_MAX, MULPIR_BATCH, k, n), ctx1.tables.p,
                         gen)
    out = {}
    for size in range(1, ZQ_FOLD_MAX + 1):
        rows = down[:, :size].contiguous()
        out[f"switch_down_L{size}"] = run_cases(
            "zq_mul", [zq_case("switch-down", rows, inv, inv_shoup,
                               ctx1.mod)], int32_rate, "per call")
        del rows
    del down
    ctx = par_ip.context_at_level(0)
    parts = [rand_residues((IP_BATCH, ctx.k, ctx.degree), ctx.tables.p, gen)
             for _ in range(2)]
    weights = Plaintext.try_encode(
        np.arange(ctx.degree, dtype=np.uint64) % PLAINTEXT, Encoding.simd(),
        par_ip)
    out["ct_mul_pt"] = run_cases(
        "zq_mul", [zq_case("ct_mul_pt", parts[0], weights.poly_ntt, None,
                           ctx.mod)], int32_rate, "per part")
    with KernelRecorder("inner-product step") as rec:
        ct_mul_pt(Ciphertext(par_ip, parts, 0), weights)
    out["ip_step"] = check_recorded(rec, int32_rate, "per inner-product step",
                                    IP_LAUNCHES)["zq_mul"]
    return out


def fold_case(label, ctx, cur0, cur1, s0, ks0, ks1, mono, mono_shoup):
    """A run_cases item for expand_fold: both parts' fold of a doubling
    against its plain version (zq add, sub, mul_shoup, cat). Bytes: each
    streamed operand's words read once (cur0, cur1, s0, ks1, and ks0 where
    there is an addend), both parts' two halves written once, the
    monomial's two rows and the moduli; one Shoup product a word of each
    part."""
    from tpufhe_torch import pipeline

    args = (ctx, cur0, cur1, s0, ks0, ks1, mono, mono_shoup)
    words = cur0.numel()
    streamed = 4 + (ks0 is not None) + 4
    return (f"{label} {tuple(cur0.shape)}"
            f"{'' if ks0 is not None else ' without the addend'}",
            lambda: pipeline.expand_fold_cuda(*args),
            lambda: pipeline.expand_fold_plain(*args),
            8 * (streamed * words + 2 * mono.numel() + ctx.k),
            2 * words * SHOUP)


def check_expand_fold_kernels(par_mulpir, gen, int32_rate: float) -> dict:
    """Phase 3, expand_fold at mulpir-q16's doublings: (L, 16, 2, 8192)
    parts over the level-1 moduli of 50 and 55 bits and the doubling's own
    monomial x^{-L} with its Shoup constants, L = 1, 2, ..., 64, with the
    leveled key's addend (s0 + ks0), and at L = 64 without it (a key at
    the ciphertexts' level); each torch.equal to its plain version and
    timed beside its bytes bound. Returns {label: record}."""
    from tpufhe_torch.bfv.keys.evaluation_key import monomials

    ctx = par_mulpir.context_at_level(1)
    monos = monomials(ctx)
    parts = rand_residues((5, ZQ_FOLD_MAX, MULPIR_BATCH, ctx.k, ctx.degree),
                          ctx.tables.p, gen)
    out = {}
    for l in range(ZQ_FOLD_MAX.bit_length()):
        size = 1 << l
        cur0, cur1, s0, ks0, ks1 = (x[:size] for x in parts)
        out[f"fold_L{size}"] = run_cases("expand_fold", [fold_case(
            f"doubling {l}", ctx, cur0, cur1, s0, ks0, ks1, *monos[l])],
            int32_rate, "per doubling")
    out[f"fold_L{size}_no_addend"] = run_cases("expand_fold", [fold_case(
        f"doubling {l}", ctx, cur0, cur1, s0, None, ks1, *monos[l])],
        int32_rate, "per doubling")
    del parts
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
    return SimpleNamespace(sk=sk, rk=rk, va=va, vb=vb, fresh=cas,
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
    """Phase 6. Returns {program: (launches, step, inputs)} and, under
    "keys", (the secret key, the evaluation key)."""
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
        {"ntt": EXPAND_LEVEL, "rotate_tail": EXPAND_LEVEL,
         "expand_fold": EXPAND_LEVEL})
    if tuple(c0.shape) != (size, EXPAND_BATCH, par.context_at_level(0).k, n):
        raise SystemExit(f"expansion: unexpected shape {tuple(c0.shape)}")
    want = np.zeros((size, EXPAND_BATCH, n), dtype=np.uint64)
    want[:, :, 0] = ((poly[:, :size].T.astype(object) << EXPAND_LEVEL) % t
                     ).astype(np.uint64)
    check_outputs("expansion", par, sk, c0, c1, want, Encoding.poly())
    out["expand"] = (launches, expand, (p0, p1))
    out["keys"] = (sk, ek)
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
    ({program: (step, inputs, launches)}, the keys and values: sk, rk, va,
    vb)."""
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
    return out, SimpleNamespace(sk=sk, rk=rk, va=va, vb=vb)


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
    """Phase 3, ct_pt_dot against its plain version at every shape its
    callers launch: the dot bench (128 terms, m = B = 1, 4 x 62-bit at
    N = 8192; phase 15's make_ct_pt_dot), PIR's first dimension (64 terms,
    8 columns, 6 x 62-bit at N = 16384), 15 and 29 terms over 3 x 62-bit
    at N = 8192 (one and two reductions of the 14-term window), phase 15's
    dot_product_scalar of 16, rq.dot_product of 16 with a batch of
    DOT_FOLD folded into the rows (one part, R = DOT_FOLD k), a three-part
    ciphertext through dot_product_scalar (the general instance) and 29
    terms over phase 18's 5 x 44-bit moduli. Each record carries the
    call's launch plan from the kernel's own plan and occupancy entry
    points. Returns {label: record}."""
    rot, n16k, main, d128 = (pars[key].context_at_level(0)
                             for key in ("dot", "n16k", "main", "d128"))
    # (label, context, parts, terms, columns, batch rows, rows per limb set)
    shapes = [("dot bench", rot, 2, DOT_PAIRS, 1, 1, 1),
              ("PIR first dimension", n16k, 2, *DOT_PIR, 1, 1)]
    shapes += [(f"{t} terms", main, 2, t, 1, 1, 1) for t in DOT_WINDOW_TERMS]
    shapes += [(f"dot_product_scalar of {DOT_SCALAR}", rot, 2, DOT_SCALAR,
                1, 1, 1),
               (f"rq.dot_product of {DOT_SCALAR}, rows folded", rot, 1,
                DOT_SCALAR, 1, 1, DOT_FOLD),
               (f"three-part dot_product_scalar of {DOT_SCALAR}", rot, 3,
                DOT_SCALAR, 1, 1, 1),
               (f"{DOT_D128_TERMS} terms, 5 x 44-bit", d128, 2,
                DOT_D128_TERMS, 1, 1, 1)]
    out = {}
    for label, ctx, nparts, n, m, b, fold in shapes:
        r = ctx.k * fold
        p = ctx.tables.p.repeat(fold)
        parts = [rand_residues((n, b, r, ctx.degree), p, gen)
                 for _ in range(nparts)]
        db = rand_residues((n, m, r, ctx.degree), p, gen)
        out[label] = run_cases("ct_pt_dot", [dot_case(label, ctx, parts, db)],
                               int32_rate, "per call")
        out[label]["plan"] = dot_plan(nparts, m, b * r * ctx.degree)
    return out


def dot_plan(nparts: int, m: int, plane: int) -> dict:
    """The launch plan of a ct_pt_dot call of `nparts` parts, m columns and
    `plane` words a part and column, from the kernel's plan and occupancy
    entry points: its instance, ring stages, grid, shared bytes and CTAs
    per SM (printed)."""
    from tpufhe_torch import kernels

    argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    plan_fn = kernels.function("ct_pt_dot", "tpufhe_ct_pt_dot_plan", argtypes)
    occ_fn = kernels.function("ct_pt_dot", "tpufhe_ct_pt_dot_occupancy",
                              argtypes)
    plan = (ctypes.c_longlong * 7)()
    kernels.check(plan_fn(nparts, m, plane, plan), "plan")
    blocks_per_sm = ctypes.c_int()
    kernels.check(occ_fn(nparts, m, plane, ctypes.byref(blocks_per_sm)),
                  "occupancy")
    keys = ("parts", "columns", "stages", "threads", "blocks", "shared_bytes",
            "general")
    rec = dict(zip(keys, plan)) | {"blocks_per_sm": blocks_per_sm.value}
    log(f"  plan ct_pt_dot {nparts} parts, {m} columns, {plane} words: "
        f"instance <{rec['parts']}, {rec['columns']}>"
        f"{' (general)' if rec['general'] else ''}, a ring of "
        f"{rec['stages']} terms, {rec['blocks']} blocks x {rec['threads']} "
        f"threads, {rec['shared_bytes']} shared bytes, "
        f"{rec['blocks_per_sm']} blocks per SM")
    return rec


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

    (c0, c1), _ = run_program(f"add + pt_mul of {b} pairs", step, inputs,
                              {"zq_mul": 2})
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


def object_api_path(par, mp: SimpleNamespace, variants: dict):
    """Phase 16, the object API at BASELINE config 3 on phase 4's keys and
    64 pairs: PublicKey (seed 2033) encryption, ct_mul to three parts and
    their decryption, ct_square, relinearizes, and Multiplicator.default
    and strategy2(rk, 1), each torch.equal to make_mul_relin's output
    (default and strategy 2 kP = 1) on the same ciphertexts; every run held
    to its exact launch counts, every slot checked, the noise printed.
    Returns the public key."""
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
                {"ntt": 1, "rns_scale": 1, "zq_mul": 3})
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
    lazy_poly(par, mp)
    log(f"  phase 4's product noise: {sum(MODULI_SIZES) - mp.margin} bits")
    return pk


def lazy_poly(par, mp: SimpleNamespace) -> None:
    """Phase 16, the lazy Poly at BASELINE config 3: the power basis of
    make_mul_relin's first output part (64, 3, 8192) into the NTT domain
    with lazy=True (ntt 1, K1's lazy instance), its words below 4p and
    congruent to the canonical forward's, times an NttShoup poly (phase 4's
    first b0 row; no kernel) torch.equal to the canonical product."""
    from tpufhe_torch.ops.rq import NTT, Poly

    ctx = par.context_at_level(0)
    pb = Poly(ctx, NTT, mp.product[0]).into_power_basis()
    shoup = Poly(ctx, NTT, mp.inputs[2][0]).into_ntt_shoup()
    lazy, _ = run_program("Poly.into_ntt(lazy=True)", pb.into_ntt, (True,),
                          {"ntt": 1})
    canonical = pb.into_ntt()
    agrees, err, note = lazy_check(ctx.tables, slice(None))(lazy.coeffs,
                                                            canonical.coeffs)
    prod, _ = run_program("lazy Poly x NttShoup", lazy.__mul__, (shoup,),
                          {"zq_mul": 1})
    equal = torch.equal(prod.coeffs, (canonical * shoup).coeffs)
    log(f"  lazy Poly {tuple(lazy.coeffs.shape)}: max_abs_err {err}{note}; "
        f"x NttShoup equal to the canonical product: {equal}")
    if not (agrees and equal and lazy.lazy and not prod.lazy):
        raise SystemExit("the lazy Poly disagrees with the canonical one")


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


# ---------------------------------------------------------------------------
# Phases 19 and 20: the PIR server programs
# ---------------------------------------------------------------------------


class KernelRecorder:
    """While active, each kernel wrapper a program calls on the card records
    its inputs, once per distinct call (kernel, shapes, context or tables,
    options), with the number of calls of that signature: phase 3 holds
    each against its plain version at the program's own shapes
    (check_recorded): ntt, ntt32, rns_scale, ks_accumulate, ct_pt_dot,
    relin_tail, tensor, rotate_tail, tensor_intt, ks_tail, zq_mul,
    expand_fold, rq_pack and rq_unpack. The
    second dimension's input is kept too, to
    time its two routes. The launch counters are set to 0 on entry and read on
    exit (launches), so a kernel call the recorder missed shows."""

    def __init__(self, label: str):
        self.label = label
        self.calls: dict = {}
        self.second = None
        self.launches: dict = {}

    def add(self, name, sig, item, plan=None) -> None:
        """Count a call of `name` with signature `sig`; keep the run_case
        item thunk (and ct_pt_dot's plan arguments) of its first."""
        entry = self.calls.get((name,) + sig)
        if entry is None:
            self.calls[(name,) + sig] = [name, 1, item, plan]
        else:
            entry[1] += 1

    def __enter__(self):
        from tpufhe_torch import kernels, pipeline
        from tpufhe_torch.ops import dot
        from tpufhe_torch.ops import ntt as ntt_mod
        from tpufhe_torch.ops import zq
        from tpufhe_torch.ops.rns import RnsScaler
        from tpufhe_torch.serialize import rq_pack

        targets = [(ntt_mod, "ntt_cuda"), (ntt_mod, "ntt32_cuda"),
                   (RnsScaler, "scale_cuda"),
                   (pipeline, "ks_accumulate_cuda"), (dot, "ct_pt_dot_cuda"),
                   (pipeline, "relin_tail_cuda"),
                   (pipeline, "_second_dimension"),
                   (pipeline, "tensor_cuda"), (pipeline, "rotate_tail_cuda"),
                   (pipeline, "tensor_intt_cuda"), (pipeline, "ks_tail_cuda"),
                   (zq, "mul_cuda"), (pipeline, "expand_fold_cuda"),
                   (rq_pack, "rq_pack_cuda"), (rq_pack, "rq_unpack_cuda")]
        self._saved = [(owner, name, getattr(owner, name))
                       for owner, name in targets]
        orig = {name: fn for _, name, fn in self._saved}
        label, rec = self.label, self

        def ntt(x, tables, sl, inverse, lazy=False):
            rec.add("ntt", (tuple(x.shape), id(tables), sl.start, sl.stop,
                            inverse, lazy),
                    lambda: k1_case(label, x, tables, sl, inverse, lazy))
            return orig["ntt_cuda"](x, tables, sl, inverse, lazy)

        def ntt32(x, tables, sl, inverse, lazy=False):
            rec.add("ntt32", (tuple(x.shape), id(tables), sl.start, sl.stop,
                              inverse, lazy),
                    lambda: k9_case(label, x, tables, sl, inverse, lazy))
            return orig["ntt32_cuda"](x, tables, sl, inverse, lazy)

        def scale(scaler, x, start, size):
            rec.add("rns_scale", (tuple(x.shape), start, size,
                                  tuple(scaler.from_ctx.moduli_u64),
                                  tuple(scaler.to_ctx.moduli_u64),
                                  scaler.factor),
                    lambda: k2_case(label, scaler, x, start, size))
            return orig["scale_cuda"](scaler, x, start, size)

        def ks(ctx, d, key, add0=None, add1=None):
            rec.add("ks_accumulate", (tuple(d.shape), id(ctx), add0 is None,
                                      add1 is None),
                    lambda: ks_case(label, ctx, d, key, add0, add1))
            return orig["ks_accumulate_cuda"](ctx, d, key, add0, add1)

        def dot_kernel(ctx, parts, db):
            rec.add("ct_pt_dot", (tuple(tuple(p.shape) for p in parts),
                                  tuple(db.shape), id(ctx)),
                    lambda: dot_case(label, ctx, parts, db),
                    (len(parts), db.shape[1],
                     parts[0].shape[1] * db.shape[2] * ctx.degree))
            return orig["ct_pt_dot_cuda"](ctx, parts, db)

        def relin(ctx, dsc, key):
            rec.add("relin_tail", (tuple(dsc.shape), id(ctx)),
                    lambda: k4_case(label, ctx, dsc, key))
            return orig["relin_tail_cuda"](ctx, dsc, key)

        def second(ctx_mul, ext):
            rec.second = (ctx_mul, ext)
            return orig["_second_dimension"](ctx_mul, ext)

        def tensor(ctx, a0, a1, b0, b1):
            rec.add("tensor", (tuple(a0.shape), id(ctx), a0 is b0),
                    lambda: k7_case(label, ctx, a0, a1, b0, b1))
            return orig["tensor_cuda"](ctx, a0, a1, b0, b1)

        def rotate(ctx, s0, c2, key):
            rec.add("rotate_tail", (tuple(s0.shape), id(ctx)),
                    lambda: k5_case(label, ctx, s0, c2, key))
            return orig["rotate_tail_cuda"](ctx, s0, c2, key)

        def tensor_intt(ctx_mul, ext):
            rec.add("tensor_intt", (tuple(ext.shape), id(ctx_mul)),
                    lambda: k3_case(label, ctx_mul, ext))
            return orig["tensor_intt_cuda"](ctx_mul, ext)

        def ks_tail(ctx, c2, key):
            rec.add("ks_tail", (tuple(c2.shape), id(ctx)),
                    lambda: ks_tail_case(label, ctx, c2, key))
            return orig["ks_tail_cuda"](ctx, c2, key)

        def zq_mul(a, b, b_shoup, m):
            rec.add("zq_mul", (tuple(a.shape), a.stride(), tuple(b.shape),
                               b.stride(), b_shoup is None, m.moduli,
                               m.shape),
                    lambda: zq_case(label, a, b, b_shoup, m))
            return orig["mul_cuda"](a, b, b_shoup, m)

        def fold(ctx, cur0, cur1, s0, ks0, ks1, mono, mono_shoup):
            args = (ctx, cur0, cur1, s0, ks0, ks1, mono, mono_shoup)
            rec.add("expand_fold", (tuple(cur0.shape), id(ctx), ks0 is None,
                                    id(mono)),
                    lambda: fold_case(label, *args))
            return orig["expand_fold_cuda"](*args)

        def pack(ctx, x):
            rec.add("rq_pack", (tuple(x.shape), x.dtype, tuple(ctx.moduli)),
                    lambda: rq_pack_case(label, ctx, x))
            return orig["rq_pack_cuda"](ctx, x)

        def unpack(ctx, packed, m):
            rec.add("rq_unpack", (m, tuple(ctx.moduli), ctx.degree,
                                  ctx.narrow),
                    lambda: rq_unpack_case(label, ctx, packed, m))
            return orig["rq_unpack_cuda"](ctx, packed, m)

        for (owner, name, _), fn in zip(self._saved, (ntt, ntt32, scale, ks,
                                                      dot_kernel, relin,
                                                      second, tensor,
                                                      rotate, tensor_intt,
                                                      ks_tail, zq_mul, fold,
                                                      pack, unpack)):
            setattr(owner, name, fn)
        kernels.reset_launches()
        return self

    def __exit__(self, *exc) -> bool:
        from tpufhe_torch import kernels

        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        self.launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        return False


def check_recorded(rec: KernelRecorder, int32_rate: float, per: str,
                   expected: dict | None) -> dict:
    """Phase 3 at a program's recorded calls: fails unless the calls
    recorded per kernel equal both the launch counters' reading over the
    recorded run and `expected` (the program's exact counts; None for a
    phase whose runs are held to their counts where they run); then each
    distinct call against its plain version (torch.equal, both timed,
    ct_pt_dot with its launch plan); per kernel one record of the
    program's run, each call's time and bound counted as often as the
    program makes it. Returns {kernel: record}."""
    recorded: dict = {}
    for name, count, _, _ in rec.calls.values():
        recorded[name] = recorded.get(name, 0) + count
    if recorded != rec.launches or recorded != (
            rec.launches if expected is None else expected):
        raise SystemExit(f"{rec.label}: recorded calls {recorded}, launches "
                         f"counted {rec.launches}, expected {expected}")
    by_kernel: dict = {}
    for name, count, item, plan in rec.calls.values():
        by_kernel.setdefault(name, []).append((count, item(), plan))
    out = {}
    for name, entries in by_kernel.items():
        bound = Bound(int32_rate)
        runs = []
        for count, (label, kfn, pfn, nbytes, ops, *check), plan in entries:
            r = run_case(name, label if count == 1 else f"{label} x {count}",
                         kfn, pfn, int32_rate, nbytes, ops, *check)
            bound.add(count * nbytes, count * ops)
            if plan is not None:
                r["plan"] = dot_plan(*plan)
            runs.append((count, r))
        bound_ms, bound_by = bound.result()
        out[name] = {
            "ms": sum(c * r["ms"] for c, r in runs),
            "item_ms": [r["ms"] for _, r in runs],
            "plain_ms": sum(c * r["plain_ms"] for c, r in runs),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": max(r["max_abs_err"] for _, r in runs),
            "shapes": [r["label"] for _, r in runs],
            "launches": sum(c for c, _ in runs),
            "bytes": bound.bytes, "int32_muls": bound.ops}
        plans = [r["plan"] for _, r in runs if "plan" in r]
        if plans:
            out[name]["plan"] = plans
        log(f"  {name}: kernel {out[name]['ms']:.4f} ms, plain "
            f"{out[name]['plain_ms']:.3f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}) over {out[name]['launches']} launches {per}")
    return out


def pir_setup(par) -> SimpleNamespace:
    """Phase 19's set-up (BASELINE config 5, bench.py:509-552; seed 2036):
    secret, relinearization and expansion keys at level 0, the database of
    dim1 x dim2 SIMD plaintexts of seeded random slots, and a batch of
    PIR_BATCH queries, each selecting its own cell (i, j) with
    (2^levels)^-1 mod t on its two selectors (tests/test_pipeline.py:
    193-200)."""
    from tpufhe_torch.bfv import (
        Encoding,
        EvaluationKeyBuilder,
        Plaintext,
        RelinearizationKey,
        SecretKey,
    )
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

    t, n = par.plaintext.value, par.degree()
    dim1, dim2 = PIR_DIMS
    levels = (dim1 + dim2 - 1).bit_length()
    rng = ChaCha8Rng(seed_from_u64(PIR_SEED))
    t0 = time.perf_counter()
    sk = SecretKey.random(par, rng)
    rk = RelinearizationKey.new(sk, rng)
    ek = EvaluationKeyBuilder(sk).enable_expansion(levels).build(rng)
    torch.cuda.synchronize()
    log(f"  phase 19 set-up: keygen (sk, rk, {len(ek.gk)} Galois keys) "
        f"{time.perf_counter() - t0:.2f} s")
    vals = np.random.default_rng(PIR_SEED).integers(0, t, (dim1, dim2, n),
                                                    dtype=np.uint64)
    cells = [((3 * b + 1) % dim1, (5 * b + 2) % dim2)
             for b in range(PIR_BATCH)]
    inv = pow(1 << levels, -1, t)
    cts = []
    for i, j in cells:
        q = np.zeros(n, dtype=np.uint64)
        q[i] = q[dim1 + j] = inv
        cts.append(sk.try_encrypt(
            Plaintext.try_encode(q, Encoding.poly(), par), rng))
    query = tuple(torch.stack([c[i] for c in cts]) for i in (0, 1))
    return SimpleNamespace(par=par, sk=sk, rk=rk, ek=ek, vals=vals,
                           cells=cells, query=query, dims=(dim1, dim2))


def pir_kernels(pir: SimpleNamespace, int32_rate: float, card: str) -> tuple:
    """Phase 3 at phase 19's shapes: the database build and one PIR
    response recorded (KernelRecorder), each call held to its plain
    version, and the second dimension's two routes timed on the
    response's own input. The database and the recorded inputs are
    dropped after (phase 19 builds the database again). Returns ({program:
    {kernel: record}}, the routes' record)."""
    from tpufhe_torch.bfv import Encoding
    from tpufhe_torch.pipeline import encode_pir_database, make_pir_response

    with KernelRecorder("PIR database") as rec_db:
        db = encode_pir_database(pir.par, pir.vals, Encoding.simd())
    with KernelRecorder("PIR response") as rec:
        make_pir_response(pir.par, pir.ek, pir.rk, db, *pir.dims)(*pir.query)
    records = {"pir_database": check_recorded(rec_db, int32_rate,
                                              "per PIR database build",
                                              PIR_DB_LAUNCHES),
               "pir_response": check_recorded(rec, int32_rate,
                                              "per PIR response",
                                              PIR_LAUNCHES)}
    return records, second_dimension_routes("PIR", rec.second, int32_rate,
                                            card)


def mulpir_setup(par) -> SimpleNamespace:
    """Phase 20's set-up (tpufhe/models/pir.py:69-77; seed 2037): the
    database shape of 65,536 elements of 1 KiB (tpufhe/models/util.py:
    25-48: 20 elements a plaintext, 3,277 rows, dims (58, 57), the rest
    zero), its rows seeded random coefficients below 2^20 in
    Encoding.poly(1); the secret key, the expansion keys for level-1
    ciphertexts held at level 0 and the relinearization key at level 1
    (their generation recorded: K2 scales the keys' secrets up into level
    0 through the Switcher), and MULPIR_QUERIES queries at level 1."""
    from tpufhe_torch.bfv import (
        Encoding,
        EvaluationKeyBuilder,
        Plaintext,
        RelinearizationKey,
        SecretKey,
    )
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

    t, n = par.plaintext.value, par.degree()
    nbits = t.bit_length() - 1
    per_pt = nbits * n // (MULPIR_ELEMENT_BYTES * 8)
    rows = -(-MULPIR_ELEMENTS // per_pt)
    dim1 = math.isqrt(rows - 1) + 1
    dim2 = -(-rows // dim1)
    levels = max((dim1 + dim2 - 1).bit_length(), 1)
    if (per_pt, rows, dim1, dim2, levels) != MULPIR_SHAPE:
        raise SystemExit(f"MulPIR shape {(per_pt, rows, dim1, dim2, levels)}, "
                         f"expected {MULPIR_SHAPE}")
    rng = ChaCha8Rng(seed_from_u64(MULPIR_SEED))
    t0 = time.perf_counter()
    sk = SecretKey.random(par, rng)
    with KernelRecorder("MulPIR key generation") as rec_keygen:
        ek = EvaluationKeyBuilder(sk, 1, 0).enable_expansion(levels).build(rng)
        rk = RelinearizationKey.new(sk, rng, 1, 1)
        torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    log(f"  phase 20 set-up: keygen (sk, {len(ek.gk)} Galois keys for level "
        f"1 held at level 0, rk at level 1) {keygen_s:.2f} s")
    gen = np.random.default_rng(MULPIR_SEED)
    vals = gen.integers(0, 1 << nbits, (dim1 * dim2, n), dtype=np.uint64)
    vals[rows:] = 0
    vals = vals.reshape(dim1, dim2, n)
    indices = [int(i) for i in gen.integers(0, MULPIR_ELEMENTS,
                                            MULPIR_QUERIES)]
    inv = pow(1 << levels, -1, t)
    queries, query_cts = [], []
    for index in indices:
        row = index // per_pt
        q = np.zeros(n, dtype=np.uint64)
        q[row // dim2] = q[dim1 + row % dim2] = inv
        ct = sk.try_encrypt(Plaintext.try_encode(q, Encoding.poly(1), par),
                            rng)
        queries.append((ct[0][None], ct[1][None]))
        query_cts.append(ct)
    return SimpleNamespace(par=par, sk=sk, ek=ek, rk=rk, vals=vals,
                           query_cts=query_cts,
                           indices=indices, queries=queries, per_pt=per_pt,
                           dims=(dim1, dim2), levels=levels,
                           keygen_s=keygen_s, rec_keygen=rec_keygen, rng=rng)


def mulpir_database(m: SimpleNamespace) -> torch.Tensor:
    """MulPIR's database on the card: the rows uploaded as int64 and
    encoded at level 1 (encode_pir_database: one K1 forward)."""
    from tpufhe_torch.bfv import Encoding
    from tpufhe_torch.pipeline import encode_pir_database

    values = torch.from_numpy(m.vals.astype(np.int64)).to(m.par.device)
    return encode_pir_database(m.par, values, Encoding.poly(1))


def mulpir_kernels(m: SimpleNamespace, int32_rate: float, card: str) -> tuple:
    """Phase 3 at phase 20's shapes: the key generation (K2 at the
    Switcher's scale-up, K1), the database build, the leveled expansion and the
    response recorded, each call held to its plain version, and the
    second dimension's two routes timed on the response's own input. Sets
    m.expand and m.respond; the database and the recorded inputs are
    dropped after (phase 20 uploads the database again). Returns
    ({program: {kernel: record}}, the routes' record)."""
    from tpufhe_torch.bfv import Ciphertext, GaloisKey
    from tpufhe_torch.pipeline import make_expand, make_pir_response_db

    with KernelRecorder("MulPIR database") as rec_db:
        db = mulpir_database(m)
    m.expand = make_expand(m.par, m.ek, m.levels, level=1)
    m.respond = make_pir_response_db(m.par, m.rk, *m.dims, level=1)
    with KernelRecorder("MulPIR expansion") as rec_exp:
        e0, e1 = m.expand(*m.queries[0])
    with KernelRecorder("MulPIR response") as rec:
        m.respond(e0, e1, db)
    del e0, e1
    batch = [m.query_cts[i % len(m.query_cts)] for i in range(MULPIR_BATCH)]
    with KernelRecorder(f"MulPIR batch of {MULPIR_BATCH}") as rec_batch:
        e0, e1 = m.expand(*(torch.stack([ct[i] for ct in batch])
                            for i in (0, 1)))
        ans = Ciphertext(m.par, list(m.respond(e0, e1, db)), 1)
        ans.switch_to_level(ans.max_switchable_level())
    del e0, e1
    # the batch's wire path as mulpir-q16 serves it, then a Galois key's
    # round trip and the codec's calls timed on both routes
    queries = [ct.to_bytes() for ct in batch]
    answers = [Ciphertext(m.par, [x[j] for x in ans.c], ans.level)
               for j in range(MULPIR_BATCH)]
    with KernelRecorder(f"MulPIR wire of {MULPIR_BATCH}") as rec_wire:
        for q in queries:
            Ciphertext.from_bytes(q, m.par)
        for a in answers:
            a.to_bytes()
    gk = next(iter(m.ek.gk.values()))
    with KernelRecorder("MulPIR Galois key wire") as rec_gk:
        GaloisKey.from_bytes(gk.to_bytes(), m.par)
    m.wire_calls = wire_calls(m, answers[0], card)
    del ans, answers
    records = {
        "mulpir_keygen": check_recorded(m.rec_keygen, int32_rate,
                                        "per MulPIR key generation",
                                        MULPIR_KEYGEN_LAUNCHES),
        "mulpir_database": check_recorded(rec_db, int32_rate,
                                          "per MulPIR database build",
                                          MULPIR_DB_LAUNCHES),
        "mulpir_expansion": check_recorded(rec_exp, int32_rate,
                                           "per MulPIR expansion",
                                           MULPIR_EXPAND_LAUNCHES),
        "mulpir_response": check_recorded(rec, int32_rate,
                                          "per MulPIR response",
                                          MULPIR_RESPONSE_LAUNCHES),
        "mulpir_batch": check_recorded(rec_batch, int32_rate,
                                       f"per MulPIR batch of {MULPIR_BATCH}",
                                       MULPIR_BATCH_LAUNCHES),
        "mulpir_wire": check_recorded(
            rec_wire, int32_rate, f"per MulPIR batch of {MULPIR_BATCH}'s "
            f"wire path", MULPIR_WIRE_LAUNCHES),
        "mulpir_galois_wire": check_recorded(
            rec_gk, int32_rate, "per Galois key round trip", None)}
    m.batch_launches = rec_batch.launches
    m.wire_launches = rec_wire.launches
    del m.rec_keygen, rec_batch, rec_wire, rec_gk
    return records, second_dimension_routes("MulPIR", rec.second, int32_rate,
                                            card)


def second_dimension_routes(name: str, second, int32_rate: float,
                            card: str) -> dict:
    """The second dimension sum_j sel_j (x) resp_j on the program's own
    input, both ways: (a) K7 over all j and a tree of modular adds, (b)
    three ct_pt_dot (pipeline._second_dimension, the route the programs
    take); both torch.equal, timed with CUDA events, and K7 held to its
    plain version at this shape. Returns {"a_ms", "b_ms", "tensor"}."""
    from tpufhe_torch import pipeline

    ctx_mul, ext = second
    s1, s0, r0, r1 = ext

    def route_a():
        t = pipeline.tensor_cuda(ctx_mul, s0, s1, r0, r1)
        while t.shape[1] > 1:
            h = t.shape[1] // 2
            head = ctx_mul.add(t[:, :h], t[:, h:2 * h])
            t = torch.cat([head, t[:, 2 * h:]], dim=1) if t.shape[1] % 2 else head
        return t[:, 0]

    def route_b():
        return pipeline._second_dimension(ctx_mul, ext)

    if not torch.equal(route_a(), route_b()):
        raise SystemExit(f"{name}: the two second-dimension routes disagree")
    a_ms, b_ms = time_ms(route_a, 10), time_ms(route_b, 10)
    tensor = run_cases("tensor", [k7_case(f"{name} second dimension", ctx_mul,
                                          s0, s1, r0, r1)],
                       int32_rate, f"per {name} response, route (a)")
    log(f"  {name} second dimension {tuple(ext.shape)}: (a) K7 + adds "
        f"{a_ms:.4f} ms, (b) 3 x ct_pt_dot {b_ms:.4f} ms "
        f"(pipeline._second_dimension) on {card}")
    return {"a_ms": a_ms, "b_ms": b_ms, "tensor": tensor}


def torch_ops(fn) -> int:
    """The torch operations fn() dispatches (each a launch on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def kernel_ms(records: dict) -> float:
    """The kernels' device ms of one program run: phase 3's records of its
    recorded calls, each counted as often as the program makes it."""
    return sum(rec["ms"] for rec in records.values())


def pir_path(pir: SimpleNamespace, records: dict, card: str) -> tuple:
    """Phase 19: the database build (ntt 2) and make_pir_response on the
    batch of queries, each run with the counters set to 0 just before it
    and held to its exact counts; every slot of every answer decrypted
    against its cell, the noise printed; then chained responses (each
    answer fed back as the next query, as bench_pir_response chains them)
    timed. Returns ({program: launches} of the counted runs, ms per
    response step)."""
    from tpufhe_torch.bfv import Ciphertext, Encoding
    from tpufhe_torch.pipeline import encode_pir_database, make_pir_response

    par, sk = pir.par, pir.sk
    db, db_launches = run_program("PIR database build", encode_pir_database,
                                  (par, pir.vals, Encoding.simd()),
                                  PIR_DB_LAUNCHES)
    log(f"  database {tuple(db.shape)} ({db.numel() * 8 / 2**20:.1f} MiB)")
    step = make_pir_response(par, pir.ek, pir.rk, db, *pir.dims)
    (c0, c1), launches = run_program(
        f"PIR response, dims {pir.dims}, batch {PIR_BATCH}", step, pir.query,
        PIR_LAUNCHES)
    ctx = par.context_at_level(0)
    if tuple(c0.shape) != (PIR_BATCH, ctx.k, par.degree()):
        raise SystemExit(f"PIR: output shape {tuple(c0.shape)}")
    want = np.stack([pir.vals[cell] for cell in pir.cells])
    check_outputs("PIR answers", par, sk, c0, c1, want, Encoding.simd())
    noise = sk.measure_noise(Ciphertext(par, [c0[0], c1[0]], 0))
    ms = chained_ms(step, pir.query, PIR_RATE_STEPS)
    kms = kernel_ms(records)
    log(f"  {PIR_RATE_STEPS} chained PIR responses at batch {PIR_BATCH}: "
        f"{ms:.3f} ms/step, {PIR_BATCH / ms * 1e3:.1f} PIR responses/s, "
        f"kernels {kms:.3f} ms, glue {ms - kms:.3f} ms, noise {noise} bits "
        f"on {card}")
    return {"pir_database": db_launches, "pir_response": launches}, ms


def mulpir_levels(m: SimpleNamespace) -> None:
    """Phase 20, the rest of the leveled path at MulPIR's parameters, each
    result decrypted: a SIMD ciphertext switched to each level,
    Multiplicator.default with mod switching (its product one level down),
    and public-key encryptions below the key's level."""
    from tpufhe_torch.bfv import (
        Encoding,
        Multiplicator,
        Plaintext,
        PublicKey,
        RelinearizationKey,
    )

    par, sk, rng = m.par, m.sk, m.rng
    t, n = par.plaintext.value, par.degree()
    vals = np.random.default_rng(MULPIR_SEED + 1)
    va = vals.integers(0, t, n, dtype=np.uint64)
    vb = vals.integers(0, t, n, dtype=np.uint64)
    ca, cb = (sk.try_encrypt(Plaintext.try_encode(v, Encoding.simd(), par),
                             rng) for v in (va, vb))

    def check(name, ct, want):
        got = sk.try_decrypt(ct).try_decode(Encoding.simd())
        bad = int((got != want).sum())
        log(f"  {name}: level {ct.level}, wrong slots {bad}, noise "
            f"{sk.measure_noise(ct)} bits")
        if bad:
            raise SystemExit(f"{name}: {bad} slots decrypted wrong")

    down = ca.clone()
    for level in range(1, par.max_level() + 1):
        down.switch_to_level(level)
        check(f"switch_to_level({level})", down, va)
    mult = Multiplicator.default(RelinearizationKey.new(sk, rng))
    mult.enable_mod_switching()
    prod = mult.multiply(ca, cb)
    if prod.level != 1:
        raise SystemExit(f"Multiplicator with mod switching: level {prod.level}")
    check("Multiplicator.default with mod switching", prod,
          (va.astype(object) * vb % t).astype(np.uint64))
    pk = PublicKey.new(sk, rng)
    for level in range(1, par.max_level() + 1):
        ct = pk.try_encrypt(Plaintext.try_encode(va, Encoding.simd(level),
                                                 par), rng)
        check(f"public-key encryption at level {level}", ct, va)


def mulpir_path(m: SimpleNamespace, records: dict, card: str) -> dict:
    """Phase 20: for each query, make_expand at level 1 (7 leveled
    doublings) and make_pir_response_db, each run with the counters set to
    0 just before it and held to its exact counts; the answer switched to
    the last level and decrypted, all N coefficients held to the selected
    plaintext's. Then the expansion and the response timed apart with CUDA
    events, the switch-down timed inside the expansion
    (expansion_switch_downs), the leveled path's other operations
    (mulpir_levels). Returns {"expand_ms", "response_ms", "switch_share",
    "launches": {program: launches} of the counted runs}."""
    from tpufhe_torch.bfv import Ciphertext, Encoding

    par, sk = m.par, m.sk
    dim1, dim2 = m.dims
    ctx1 = par.context_at_level(1)
    t0 = time.perf_counter()
    db, db_launches = run_program("MulPIR database upload and build",
                                  mulpir_database, (m,), MULPIR_DB_LAUNCHES)
    log(f"  keygen {m.keygen_s:.2f} s, database {tuple(db.shape)} "
        f"({db.numel() * 8 / 2**20:.1f} MiB) uploaded and built "
        f"{time.perf_counter() - t0:.3f} s (host clock)")
    for qi, (index, query) in enumerate(zip(m.indices, m.queries)):
        (e0, e1), exp_launches = run_program(
            f"MulPIR expansion of query {qi} ({m.levels} leveled doublings)",
            m.expand, query, MULPIR_EXPAND_LAUNCHES)
        if tuple(e0.shape) != (1 << m.levels, 1, ctx1.k, par.degree()):
            raise SystemExit(f"MulPIR expansion: shape {tuple(e0.shape)}")
        (o0, o1), resp_launches = run_program(
            f"MulPIR response to query {qi}", m.respond, (e0, e1, db),
            MULPIR_RESPONSE_LAUNCHES)
        ans = Ciphertext(par, [o0[0], o1[0]], 1)
        noise = sk.measure_noise(ans)
        ans.switch_to_level(ans.max_switchable_level())
        got = sk.try_decrypt(ans).try_decode(Encoding.poly(ans.level))
        row = index // m.per_pt
        bad = int((got != m.vals[row // dim2, row % dim2]).sum())
        log(f"  element {index} (row {row}, cell ({row // dim2}, "
            f"{row % dim2})): {par.degree()} coefficients, wrong {bad}, noise "
            f"{noise} bits at level 1, {sk.measure_noise(ans)} at level "
            f"{ans.level}")
        if bad:
            raise SystemExit(f"MulPIR: {bad} coefficients of element {index} "
                             f"wrong")
    query = m.queries[0]
    expand_ms = time_ms(lambda: m.expand(*query), MULPIR_REPS)
    e0, e1 = m.expand(*query)
    response_ms = time_ms(lambda: m.respond(e0, e1, db), MULPIR_REPS)
    exp_k = kernel_ms(records["mulpir_expansion"])
    resp_k = kernel_ms(records["mulpir_response"])
    log(f"  MulPIR expansion {expand_ms:.3f} ms (kernels {exp_k:.3f} ms, glue "
        f"{expand_ms - exp_k:.3f} ms), response {response_ms:.3f} ms "
        f"(kernels {resp_k:.3f} ms, glue {response_ms - resp_k:.3f} ms), per "
        f"query, on {card}")
    share = expansion_switch_downs(m, query, card)
    mulpir_levels(m)
    return {"expand_ms": expand_ms, "response_ms": response_ms,
            "switch_share": share,
            "launches": {"mulpir_database": db_launches,
                         "mulpir_expansion": exp_launches,
                         "mulpir_response": resp_launches}}


def expansion_switch_downs(m: SimpleNamespace, query, card: str) -> float:
    """The switch-down inside MulPIR's expansion: MULPIR_REPS expansions of
    `query` after a warm-up, recorded by the program's tracer
    (tpufhe_torch.utils.obs), whose device-timed spans tile each doubling
    into its key switch, switch-down and fold. Prints per doubling its
    span and the three stages' device times, and the switch-downs' share
    of the expansion. Returns that share."""
    from tpufhe_torch.ops.rq import switch_down_to
    from tpufhe_torch.utils import obs

    ctx0, ctx1 = m.par.context_at_level(0), m.par.context_at_level(1)
    m.expand(*query)
    torch.cuda.synchronize()
    with obs.recording() as rec:
        for _ in range(MULPIR_REPS):
            m.expand(*query)
    rec.resolve()
    lv = m.levels
    spans = [s for s in rec.spans if s.parent is None and s.name == "expand"]
    stages: dict = {name: [] for name in ("keyswitch", "switch_down", "fold")}
    for s in rec.spans:
        if s.name in stages:
            stages[s.name].append(s.device[1] - s.device[0])
    if len(spans) != MULPIR_REPS or any(
            len(v) != lv * MULPIR_REPS for v in stages.values()):
        raise SystemExit(f"expansion spans: {len(spans)} expansions, "
                         f"{ {k: len(v) for k, v in stages.items()} }")

    def ms(name, level):
        return sum(stages[name][rep * lv + level]
                   for rep in range(MULPIR_REPS)) / MULPIR_REPS / 1e6

    total = sum(s.device[1] - s.device[0] for s in spans) / MULPIR_REPS / 1e6
    switch_total = 0.0
    for level in range(lv):
        ks, sw, fold = (ms(name, level) for name in stages)
        span = ks + sw + fold
        switch_total += sw
        log(f"  doubling {level} ({1 << level} ciphertexts): {span:.4f} ms, "
            f"its key switch {ks:.4f} ms (substitutions, K1 x 2, ks_tail), "
            f"the switch-down {sw:.4f} ms ({100 * sw / span:.1f} % of the "
            f"doubling), the fold {fold:.4f} ms (K1, adds, Shoup products)")
    share = switch_total / total
    log(f"  switch-downs {switch_total:.4f} ms of the {total:.3f} ms "
        f"expansion ({100 * share:.1f} %), timed inside it, on {card}")
    mono, mono_shoup = m.ek.monomials[0]
    ks_pb = torch.zeros((2, 1, ctx0.k, ctx0.degree), dtype=torch.int64,
                        device=query[0].device)
    log(f"  torch operations: a switch-down "
        f"{torch_ops(lambda: switch_down_to(ctx0, ctx1, ks_pb))}, a "
        f"Shoup product by a monomial "
        f"{torch_ops(lambda: ctx1.mul_shoup(query[0], mono, mono_shoup))}")
    return share


# ---------------------------------------------------------------------------
# phases 21 and 22: the wire format and the applications
# ---------------------------------------------------------------------------


def run_counted(name: str, fn, args, expected: dict):
    """run_program by the counters' change over the call, without setting
    them to 0 (a KernelRecorder around the phase reads their total): fails
    unless the launches equal `expected`. Returns (outputs, launches)."""
    from tpufhe_torch import kernels

    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                if v != before[k]}
    log(f"  {name} {secs:.3f} s, launches {launches}")
    if launches != expected:
        raise SystemExit(f"{name}: launches {launches}, expected {expected}")
    return out, launches


class PhaseLaunches:
    """While active, each timeit block of tpufhe_torch.models.pir (the
    applications' phases: setup, keygen, query, expand, response, ...)
    records the kernel launches made inside it, by label."""

    def __enter__(self):
        from contextlib import contextmanager

        from tpufhe_torch import kernels
        from tpufhe_torch.models import pir

        self.orig, self.launches = pir.timeit, {}
        orig, launches = self.orig, self.launches

        @contextmanager
        def timed(label, report=None, key=None, n=1):
            before = dict(kernels.LAUNCHES)
            with orig(label, report, key, n):
                yield
            launches[label] = {k: v - before[k] for k, v in
                               kernels.LAUNCHES.items() if v != before[k]}

        pir.timeit = timed
        return self

    def __exit__(self, *exc) -> bool:
        from tpufhe_torch.models import pir

        pir.timeit = self.orig
        return False


def varint_len(v: int) -> int:
    return max(1, (int(v).bit_length() + 6) // 7)


def field_len(n: int) -> int:
    """A length-delimited field of n bytes (a one-byte tag)."""
    return 1 + varint_len(n) + n


def uint_field_len(v: int) -> int:
    """A varint field, left out when 0 (proto3)."""
    return 0 if v == 0 else 1 + varint_len(v)


def rq_len(ctx) -> int:
    """An Rq message: its sum_i nbits_i N / 8 payload bytes, its
    representation and its degree."""
    payload = sum(q.nbits for q in ctx.q) * ctx.degree // 8
    return 2 + uint_field_len(ctx.degree) + field_len(payload)


def ksk_len(k) -> int:
    rows = k.c0.shape[0] * (1 if k.seed is not None else 2)
    return (rows * field_len(rq_len(k.ctx_ksk))
            + (field_len(32) if k.seed is not None else 0)
            + uint_field_len(k.ciphertext_level) + uint_field_len(k.ksk_level)
            + uint_field_len(k.log_base))


def ct_len(ct) -> int:
    parts = len(ct) - (ct.seed is not None)
    return (parts * field_len(rq_len(ct.par.context_at_level(ct.level)))
            + (field_len(32) if ct.seed is not None else 0)
            + uint_field_len(ct.level))


def gk_len(gk) -> int:
    return field_len(ksk_len(gk.ksk)) + uint_field_len(gk.element.exponent)


def wire_len(obj) -> int:
    """The closed form of obj's wire size: sum_i nbits_i N / 8 bytes a
    polynomial (a seed 32 bytes), plus the envelope of its messages."""
    kind = type(obj).__name__
    if kind == "Poly":
        return rq_len(obj.ctx)
    if kind == "Ciphertext":
        return ct_len(obj)
    if kind == "SecretKey":
        zigzag = [2 * c if c >= 0 else -2 * c - 1 for c in obj.coeffs.tolist()]
        return field_len(sum(varint_len(z) for z in zigzag))
    if kind == "PublicKey":
        return field_len(ct_len(obj.c))
    if kind == "RelinearizationKey":
        return field_len(ksk_len(obj.ksk))
    if kind == "GaloisKey":
        return gk_len(obj)
    if kind == "EvaluationKey":
        return (sum(field_len(gk_len(gk)) for gk in obj.gk.values())
                + uint_field_len(obj.ciphertext_level)
                + uint_field_len(obj.evaluation_key_level))
    if kind == "RGSWCiphertext":
        return field_len(ksk_len(obj.ksk0)) + field_len(ksk_len(obj.ksk1))
    if kind == "BfvParameters":
        t = obj.plaintext.value
        return (uint_field_len(obj.degree())
                + field_len(sum(varint_len(m) for m in obj.moduli))
                + uint_field_len(obj.variance)
                + (1 + varint_len(t) if obj.plaintext.is_small
                   else field_len((t.bit_length() + 7) // 8)))
    raise SystemExit(f"no closed form for {kind}")


def wire_state(obj) -> list:
    """What a decoded object must reproduce: its tensors (torch.equal) and
    its levels, seeds and exponents."""
    kind = type(obj).__name__
    if kind == "Poly":
        return [obj.representation, obj.coeffs] + (
            [obj.coeffs_shoup] if obj.coeffs_shoup is not None else [])
    if kind == "Ciphertext":
        return [obj.level, obj.seed] + list(obj.c)
    if kind == "SecretKey":
        return [torch.from_numpy(obj.coeffs)]
    if kind == "PublicKey":
        return wire_state(obj.c)
    if kind == "KeySwitchingKey":
        return [obj.seed, obj.log_base, obj.ciphertext_level, obj.ksk_level,
                obj.c0, obj.c0_shoup, obj.c1, obj.c1_shoup]
    if kind == "RelinearizationKey":
        return wire_state(obj.ksk)
    if kind == "GaloisKey":
        return [obj.element.exponent] + wire_state(obj.ksk)
    if kind == "EvaluationKey":
        return ([obj.ciphertext_level, obj.evaluation_key_level, list(obj.gk)]
                + [x for gk in obj.gk.values() for x in wire_state(gk)]
                + [x for mono in obj.monomials for x in mono])
    if kind == "RGSWCiphertext":
        return wire_state(obj.ksk0) + wire_state(obj.ksk1)
    return [obj]


def same_state(a, b) -> bool:
    sa, sb = wire_state(a), wire_state(b)
    return len(sa) == len(sb) and all(
        (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
        for x, y in zip(sa, sb))


def wire_case(name, obj, decode, pars) -> object:
    """Phase 21 for one object: its bytes of the closed-form length,
    decoded on the card equal to it (torch.equal), decoded on the CPU and
    serialized again to the same bytes. `decode(data, par)` is the class's
    decoder; pars = (the card's parameters, the same on the CPU). Returns
    the card's decoding."""
    data = obj.to_bytes()
    torch.cuda.synchronize()
    want = wire_len(obj)
    back = decode(data, pars[0])
    torch.cuda.synchronize()
    equal = same_state(obj, back)
    again = decode(data, pars[1]).to_bytes()
    log(f"  {name}: {len(data)} bytes (closed form {want}), decoded on the "
        f"card equal {equal}, CPU round trip equal {again == data}")
    if len(data) != want or not equal or again != data:
        raise SystemExit(f"wire format: {name} does not round-trip")
    return back


def wire_passes(objs, decode, par) -> tuple:
    """WIRE_REPS passes of serialization and deserialization of `objs`,
    each ending on a synchronize: (ser ms, de ms, the bytes, the last
    pass's decoded objects)."""
    ser, de = [], []
    for _ in range(WIRE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        datas = [o.to_bytes() for o in objs]
        ser.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        backs = [decode(d, par) for d in datas]
        torch.cuda.synchronize()
        de.append((time.perf_counter() - t0) * 1e3)
    return ser, de, datas, backs


def wire_rate(name, objs, decode, par, card) -> dict:
    """Serialization and deserialization of `objs` on the card, WIRE_REPS
    times each, on the host clock, on the card route and on the host
    transcode (host_transcode), the same bytes both ways: {"bytes",
    "ser_ms", "de_ms", "host_ser_ms", "host_de_ms", "last"} with each
    pass's ms."""
    with host_transcode():
        host_ser, host_de, host_datas, _ = wire_passes(objs, decode, par)
    ser, de, datas, backs = wire_passes(objs, decode, par)
    if datas != host_datas:
        raise SystemExit(f"wire format: {name}: the card route's bytes "
                         f"differ from the host transcode's")
    nbytes = sum(len(d) for d in datas)

    def span(ms):
        return (f"{min(ms):.1f}-{max(ms):.1f} ms "
                f"({nbytes / max(ms) / 1e3:.1f}-{nbytes / min(ms) / 1e3:.1f} "
                f"MB/s)")

    log(f"  {name}: {nbytes} bytes; serialize {span(ser)}, deserialize "
        f"{span(de)}; host transcode: serialize {span(host_ser)}, "
        f"deserialize {span(host_de)}, host clock, on {card}")
    return {"bytes": nbytes, "ser_ms": ser, "de_ms": de,
            "host_ser_ms": host_ser, "host_de_ms": host_de, "last": backs}


def wire_path(par, mp, pk, rot, m, card) -> None:
    """Phase 21, the wire format: every object kind at BASELINE config 3
    (phase 4's parameters, keys and pairs, phase 16's public key, a new
    RGSW ciphertext, a Poly in each representation), phase 6's Galois and
    evaluation keys (config 4) and phase 20's leveled keys and level-1
    query (MulPIR), each through wire_case; the decoded ciphertexts
    decrypted, every slot checked; 64 ciphertexts, the relinearization key
    and MulPIR's expansion key timed through serialization."""
    from tpufhe_torch.bfv import (
        BfvParameters,
        Ciphertext,
        Encoding,
        EvaluationKey,
        GaloisKey,
        Plaintext,
        PublicKey,
        RelinearizationKey,
        RGSWCiphertext,
        SecretKey,
    )
    from tpufhe_torch.ops.rq import NTT, Poly
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

    t = par.plaintext.value
    rot_par = rot[1].par

    def pair(p):
        return (p, BfvParameters.try_deserialize(p.to_bytes(), "cpu"))

    cfg3, cfg4, mul = pair(par), pair(rot_par), pair(m.par)
    for name, p in (("parameters, config 3", par),
                    ("parameters, config 4", rot_par),
                    ("parameters, MulPIR", m.par)):
        wire_case(name, p, lambda d, q: BfvParameters.try_deserialize(
            d, q.device), pair(p))
    wire_case("secret key", mp.sk, SecretKey.from_bytes, cfg3)
    wire_case("public key", pk, PublicKey.from_bytes, cfg3)
    wire_case("relinearization key", mp.rk, RelinearizationKey.from_bytes,
              cfg3)
    ek_rot = rot[1]
    gk = ek_rot.gk[ek_rot.rot_to_gk_exponent[1]]
    wire_case("Galois key (config 4)", gk, GaloisKey.from_bytes, cfg4)
    wire_case("evaluation key, inner sum and expansion (config 4)", ek_rot,
              EvaluationKey.from_bytes, cfg4)
    wire_case("MulPIR expansion key (level 1, held at level 0)", m.ek,
              EvaluationKey.from_bytes, mul)
    wire_case("MulPIR relinearization key (level 1)", m.rk,
              RelinearizationKey.from_bytes, mul)
    rng = ChaCha8Rng(seed_from_u64(WIRE_SEED))
    rg = RGSWCiphertext.encrypt(mp.sk, Plaintext.try_encode(
        mp.vb[0], Encoding.simd(), par), rng)
    wire_case("RGSW ciphertext", rg, RGSWCiphertext.from_bytes, cfg3)
    ctx = par.context_at_level(0)
    poly = Poly(ctx, NTT, mp.fresh[0][0])
    for p in (poly, poly.into_power_basis(), poly.into_ntt_shoup()):
        wire_case(f"Poly, {p.representation}", p,
                  lambda d, q, rep=p.representation: Poly.from_bytes(
                      d, q.context_at_level(0), rep), cfg3)

    # ciphertexts: seeded fresh ones, a product, MulPIR's level-1 query
    for i in range(2):
        back = wire_case(f"fresh ciphertext {i} (seeded)", mp.fresh[i],
                         Ciphertext.from_bytes, cfg3)
        check_parts(f"decoded fresh ciphertext {i}", par, mp.sk,
                    Ciphertext(par, [x[None] for x in back.c], 0),
                    mp.va[i:i + 1])
    c0, c1 = mp.product
    back = wire_case("product ciphertext", Ciphertext(par, [c0[0], c1[0]], 0),
                     Ciphertext.from_bytes, cfg3)
    query = m.query_cts[0]
    back_q = wire_case("MulPIR query (level 1, seeded)", query,
                       Ciphertext.from_bytes, mul)
    got = m.sk.try_decrypt(back_q).try_decode(Encoding.poly(1))
    want = m.sk.try_decrypt(query).try_decode(Encoding.poly(1))
    if back_q.level != 1 or not np.array_equal(got, want) or \
            np.count_nonzero(got) != 2:
        raise SystemExit("wire format: the decoded query decrypts wrong")
    log(f"  decoded query: level 1, its two selectors {got[got != 0]}")

    # timed: 64 products, the relinearization key, MulPIR's expansion key
    cts = [Ciphertext(par, [c0[i], c1[i]], 0) for i in range(c0.shape[0])]
    rate = wire_rate(f"{len(cts)} product ciphertexts", cts,
                     Ciphertext.from_bytes, par, card)
    decoded = rate.pop("last")
    check_parts(f"{len(decoded)} decoded products", par, mp.sk,
                Ciphertext(par, [torch.stack([c[i] for c in decoded])
                                 for i in (0, 1)], 0),
                (mp.va.astype(object) * mp.vb % t).astype(np.uint64))
    wire_rate("relinearization key", [mp.rk], RelinearizationKey.from_bytes,
              par, card).pop("last")
    wire_rate("MulPIR expansion key", [m.ek], EvaluationKey.from_bytes,
              m.par, card).pop("last")


def walkthroughs(card: str) -> None:
    """Phase 22's walkthroughs at degree 8192 on 3 x 62-bit moduli, t =
    65537: every (got, want) pair of run_bfv_basic, run_bfv_ops and
    run_rgsw equal; their noise and wire sizes printed."""
    from tpufhe_torch.models import run_bfv_basic, run_bfv_ops, run_rgsw

    for fn in (run_bfv_basic, run_bfv_ops, run_rgsw):
        t0 = time.perf_counter()
        res = fn(num_moduli=APP_MODULI, degree=DEGREE,
                 plaintext_modulus=PLAINTEXT)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        pairs = {k: v for k, v in res.items()
                 if k not in ("noise_bits", "bytes")}
        bad = [k for k, (got, want) in pairs.items() if got != want]
        log(f"  {fn.__name__}: {len(pairs)} results, wrong {bad}, noise "
            f"{res.get('noise_bits')} bits, bytes {res.get('bytes')}, "
            f"{secs:.2f} s on {card}")
        if bad:
            raise SystemExit(f"{fn.__name__}: {bad} differ")


def rgsw_batch(par, mp, card: str) -> float:
    """Phase 22: the external product of phase 4's 64 ciphertexts of va by
    one RGSW ciphertext of vb[0] (seed 2039), held to its launch counts,
    every slot of its decryption equal to va vb[0] mod t, as are the
    decryptions of make_mul_relin on the same pairs; then chained
    external products timed with CUDA events. Returns products/s."""
    from tpufhe_torch.bfv import Ciphertext, Encoding, Plaintext, RGSWCiphertext
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

    t = par.plaintext.value
    rng = ChaCha8Rng(seed_from_u64(RGSW_SEED))
    rg = RGSWCiphertext.encrypt(mp.sk, Plaintext.try_encode(
        mp.vb[0], Encoding.simd(), par), rng)
    a0, a1, b0, b1 = mp.inputs
    ca = Ciphertext(par, [a0, a1], 0)
    out, _ = run_counted(f"external product of {RGSW_BATCH} ciphertexts",
                         rg.external_product, (ca,), RGSW_LAUNCHES)
    want = (mp.va.astype(object) * mp.vb[0] % t).astype(np.uint64)
    check_parts("external product", par, mp.sk, out, want)
    r0, r1 = mp.step(a0, a1, b0[:1].expand_as(b0).contiguous(),
                     b1[:1].expand_as(b1).contiguous())
    check_parts("make_mul_relin of the same pairs", par, mp.sk,
                Ciphertext(par, [r0, r1], 0), want)

    def chained():
        c = ca
        for _ in range(RGSW_CHAIN):
            c = rg.external_product(c)
        return c[0]

    ms = time_ms(chained, 1) / RGSW_CHAIN
    rate = RGSW_BATCH / ms * 1e3
    log(f"  {RGSW_CHAIN} chained external products at batch {RGSW_BATCH}: "
        f"{ms:.3f} ms/step, {rate:.1f} external products/s on {card}")
    return rate


def large_t_path(card: str) -> None:
    """Phase 22, t = 2^127 - 1 at N = 8192, 5 x 60-bit (seed 2040): 2 x 16
    encryptions of random coefficients below t (the second operand with
    BIGT_SPARSE nonzero coefficients), each decrypted; ct_add and ct_mul
    without relinearization of the batch (ntt 6, rns_scale 3, tensor 1;
    K2's down-scale by t / q_mul, a 127-bit numerator), every coefficient
    against exact Python-int arithmetic (the negacyclic product)."""
    from tpufhe_torch.bfv import (
        BfvParametersBuilder,
        Ciphertext,
        Encoding,
        Plaintext,
        SecretKey,
        ct_add,
        ct_mul,
    )
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

    big, n = BIGT_PLAINTEXT, DEGREE
    par = (BfvParametersBuilder().set_degree(n).set_plaintext_modulus(big)
           .set_moduli_sizes(BIGT_MODULI_SIZES).build())
    rng = ChaCha8Rng(seed_from_u64(BIGT_SEED))
    sk = SecretKey.random(par, rng)
    gen = np.random.default_rng(BIGT_SEED)
    a = [[int.from_bytes(gen.bytes(16), "little") % big for _ in range(n)]
         for _ in range(BIGT_BATCH)]
    b = []
    for _ in range(BIGT_BATCH):
        row = [0] * n
        for j in gen.choice(n, BIGT_SPARSE, replace=False):
            row[int(j)] = int.from_bytes(gen.bytes(16), "little") % big
        b.append(row)
    t0 = time.perf_counter()
    ca, cb = ([sk.try_encrypt(Plaintext.try_encode(v, Encoding.poly(), par),
                              rng) for v in vs] for vs in (a, b))
    torch.cuda.synchronize()
    log(f"  {2 * BIGT_BATCH} encryptions {time.perf_counter() - t0:.2f} s")

    def rows(ct):
        return [Ciphertext(par, [x[i] for x in ct.c], 0)
                for i in range(ct[0].shape[0])]

    def check(name, cts, want):
        t0 = time.perf_counter()
        bad = sum(sum(int(x) != y for x, y in zip(
            sk.try_decrypt(c).try_decode(Encoding.poly()), w))
            for c, w in zip(cts, want))
        log(f"  {name}: {len(cts)} ciphertexts, {len(cts) * n} coefficients "
            f"decrypted, wrong {bad}, noise {sk.measure_noise(cts[0])} bits "
            f"of {sum(BIGT_MODULI_SIZES)}, {time.perf_counter() - t0:.2f} s")
        if bad:
            raise SystemExit(f"large t: {name}: {bad} coefficients wrong")

    check("encrypt, decrypt", ca, a)
    batch = [Ciphertext(par, [torch.stack([c[i] for c in cs]) for i in (0, 1)],
                        0) for cs in (ca, cb)]
    check("ct_add", rows(ct_add(*batch)),
          [[(x + y) % big for x, y in zip(u, v)] for u, v in zip(a, b)])
    prod, _ = run_counted(f"ct_mul of {BIGT_BATCH} pairs, t = 2^127 - 1",
                          ct_mul, batch, BIGT_MUL_LAUNCHES)
    want = []
    for u, v in zip(a, b):
        w = [0] * n
        for j, vj in enumerate(v):
            if vj:
                for i, ui in enumerate(u):
                    k = i + j
                    if k < n:
                        w[k] += ui * vj
                    else:
                        w[k - n] -= ui * vj
        want.append([x % big for x in w])
    check("ct_mul without relinearization", rows(prod), want)


def pir_apps(card: str) -> dict:
    """Phase 22's PIR: run_mulpir (repeat=2: index and index + 1) and
    run_sealpir at 65,536 x 1 KiB, N = 8192, the paper's t and moduli,
    through models.pir on the card (the programs), each retrieving its
    elements byte for byte, each server phase of each query held to its
    exact launch counts (PhaseLaunches), the report printed; then the CLI
    (models.pir.main) for each scheme at PIR_CLI_ELEMENTS, and MulPIR's
    object-API path (fused=False) at that size retrieving what the
    programs do. Returns {scheme: report}."""
    from tpufhe_torch.models import pir

    out = {}
    for scheme, run, expected, kw in (
            ("mulpir", pir.run_mulpir, MULPIR_APP_LAUNCHES, {"repeat": 2}),
            ("sealpir", pir.run_sealpir, SEALPIR_APP_LAUNCHES, {})):
        report: dict = {}
        t0 = time.perf_counter()
        with PhaseLaunches() as phases:
            got, want = run(MULPIR_ELEMENTS, MULPIR_ELEMENT_BYTES,
                            MULPIR_DEGREE, MULPIR_PLAINTEXT,
                            MULPIR_MODULI_SIZES, report=report, **kw)
        secs = time.perf_counter() - t0
        log(f"  {scheme}: {MULPIR_ELEMENTS} x {MULPIR_ELEMENT_BYTES} B, "
            f"retrieved {'the right' if got == want else 'a WRONG'} element"
            f"{' (and, warm, index + 1)' if kw else ''} in {secs:.2f} s on "
            f"{card}")
        if got != want:
            raise SystemExit(f"{scheme}: wrong element retrieved")
        for label, launches in phases.launches.items():
            phase = label.split("/")[1].removesuffix("_warm")
            held = phase in expected
            log(f"    {label}: {report.get(label.split('/')[1] + '_s', 0) * 1e3:.3f} "
                f"ms, launches {launches}{' (held)' if held else ''}")
            if held and launches != expected[phase]:
                raise SystemExit(f"{label}: launches {launches}, expected "
                                 f"{expected[phase]}")
        missing = [p for p in expected if f"{scheme}/{p}" not in phases.launches]
        if missing:
            raise SystemExit(f"{scheme}: phases {missing} did not run")
        log(f"    report {json.dumps(report)}")
        out[scheme] = report
    for scheme in ("mulpir", "sealpir"):
        t0 = time.perf_counter()
        args = ["--scheme", scheme, "--database-size", str(PIR_CLI_ELEMENTS),
                "--element-size", str(MULPIR_ELEMENT_BYTES), "--degree",
                str(MULPIR_DEGREE)]
        rc = pir.main(args)
        log(f"  python -m tpufhe_torch.models.pir {' '.join(args)}: exit {rc}, "
            f"{time.perf_counter() - t0:.2f} s")
        if rc != 0:
            raise SystemExit(f"the {scheme} CLI failed")
    answers = []
    for fused in (True, False):
        report = {}
        got, want = pir.run_mulpir(PIR_CLI_ELEMENTS, MULPIR_ELEMENT_BYTES,
                                   MULPIR_DEGREE, MULPIR_PLAINTEXT,
                                   MULPIR_MODULI_SIZES, report=report,
                                   fused=fused)
        answers.append(got)
        log(f"  mulpir at {PIR_CLI_ELEMENTS} x {MULPIR_ELEMENT_BYTES} B, "
            f"{'programs' if fused else 'object API'}: "
            f"{'right' if got == want else 'WRONG'} element, expand "
            f"{report['expand_s'] * 1e3:.3f} ms, response "
            f"{report['response_s'] * 1e3:.3f} ms")
        if got != want:
            raise SystemExit("mulpir: wrong element retrieved")
    if answers[0] != answers[1]:
        raise SystemExit("mulpir: the object API retrieved another element")
    return out


def same_tensors(name: str, xs, ys) -> None:
    """Fails unless the tensors of xs and ys are torch.equal, pair by pair."""
    xs, ys = list(xs), list(ys)
    equal = len(xs) == len(ys) and all(torch.equal(x, y)
                                       for x, y in zip(xs, ys))
    log(f"  {name}: equal={equal}")
    if not equal:
        raise SystemExit(f"{name}: not equal")


def mbfv_path(par, card: str) -> dict:
    """Phase 23, multiparty BFV at BASELINE config 3's ring with 11 parties
    (seed 2041): the collective public key and relinearization key through
    the protocol objects and through the batched programs, equal (the keys'
    bytes too); 64 SIMD pairs under the collective key, make_mul_relin and
    Multiplicator.default with the collective key, equal; their collective
    decryption both ways, equal, every slot checked; a SecretKeySwitchShare
    to a second set of party keys and a PublicKeySwitchShare of a level-1
    ciphertext to a one-party key, each decrypted by its output key; the
    aggregation over an NCCL group of world size 1, equal to aggregate;
    bench config 6 (mbfv_bench); run_voting at tpufhe's defaults and at
    N = 8192 with 11 parties and 1,000 voters. Every program is held to its
    exact launch counts (run_counted). Returns bench config 6's record."""
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist

    from tpufhe_torch.bfv import (
        Ciphertext,
        Encoding,
        Multiplicator,
        Plaintext,
        PublicKey,
        SecretKey,
    )
    from tpufhe_torch.mbfv import (
        CommonRandomPoly,
        DecryptionShare,
        PublicKeyShare,
        PublicKeySwitchShare,
        RelinKeyGenerator,
        SecretKeySwitchShare,
        aggregate,
    )
    from tpufhe_torch.mbfv.batched import (
        batched_decryption,
        batched_public_key,
        batched_relin_keygen,
        make_sharded_pk_aggregation,
    )
    from tpufhe_torch.models import run_voting
    from tpufhe_torch.pipeline import make_mul_relin
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

    parties, k, t, n = (MBFV_PARTIES, par.context_at_level(0).k,
                        par.plaintext.value, par.degree())
    batch = MBFV_BATCH

    def stream(i: int):
        """The phase's i-th ChaCha8 stream: the object API and the batched
        program of one protocol each draw a fresh copy."""
        return ChaCha8Rng(seed_from_u64(MBFV_SEED * 100 + i))

    def summed(keys) -> "SecretKey":
        return SecretKey(np.sum([sk.coeffs for sk in keys], axis=0), par)

    t0 = time.perf_counter()
    rng = ChaCha8Rng(seed_from_u64(MBFV_SEED))
    sks = [SecretKey.random(par, rng) for _ in range(parties)]
    crp = CommonRandomPoly.new(par, rng)
    crp_vec = CommonRandomPoly.new_vec(par, rng)
    collective = summed(sks)
    log(f"  {parties} party keys and the CRPs {time.perf_counter() - t0:.2f} s")

    def object_pk(r):
        return aggregate([PublicKeyShare.new(sk, crp, r) for sk in sks])

    def object_rk(r):
        gens = [RelinKeyGenerator(sk, crp_vec, r) for sk in sks]
        agg1 = aggregate([g.round_1(r) for g in gens])
        return aggregate([g.round_2(agg1, r) for g in gens])

    pk, _ = run_counted(f"public key: PublicKeyShare x {parties} + aggregate",
                        object_pk, (stream(1),),
                        {"ntt": 2 * parties, "zq_mul": parties})
    pk_b, _ = run_counted("public key: batched_public_key", batched_public_key,
                          (sks, crp, stream(1)), {"ntt": 2, "zq_mul": 1})
    same_tensors("collective public key, object API and batched", pk.c.c,
                 pk_b.c.c)
    rk, _ = run_counted(f"relinearization key: RelinKeyGenerator x {parties}, "
                        "two rounds", object_rk, (stream(2),),
                        {"ntt": parties * (3 + 4 * k),
                         "zq_mul": parties * 5 * k})
    rk_b, _ = run_counted("relinearization key: batched_relin_keygen",
                          batched_relin_keygen, (sks, crp_vec, stream(2)),
                          {"ntt": 4, "zq_mul": 5 * k})
    tables = ("c0", "c0_shoup", "c1", "c1_shoup")
    same_tensors("collective relinearization key, object API and batched",
                 [getattr(rk.ksk, a) for a in tables],
                 [getattr(rk_b.ksk, a) for a in tables])
    wire = [key.to_bytes() for key in (rk, rk_b)]
    log(f"  the keys serialized: {len(wire[0])} bytes each, "
        f"equal={wire[0] == wire[1]}, seed {rk.ksk.seed}")
    if wire[0] != wire[1] or rk.ksk.seed is not None:
        raise SystemExit("the collective relinearization keys' bytes differ")

    vals = np.random.default_rng(MBFV_SEED)
    va, vb = (vals.integers(0, t, (batch, n), dtype=np.uint64)
              for _ in range(2))
    pts = [Plaintext.try_encode(v, Encoding.simd(), par)
           for v in np.concatenate([va, vb])]
    r3 = stream(3)
    cts, _ = run_counted(f"{len(pts)} encryptions under the collective key",
                         lambda: [pk.try_encrypt(x, r3) for x in pts], (),
                         {"ntt": 2 * len(pts), "zq_mul": 3 * len(pts)})
    a0, a1, b0, b1 = (torch.stack([c[i] for c in cs])
                      for cs in (cts[:batch], cts[batch:]) for i in (0, 1))
    (c0, c1), _ = run_counted(
        f"make_mul_relin with the collective key at batch {batch}",
        make_mul_relin(par, rk), (a0, a1, b0, b1), MUL_LAUNCHES)
    prod, _ = run_counted("Multiplicator.default(collective key)",
                          Multiplicator.default(rk).multiply,
                          (Ciphertext(par, [a0, a1], 0),
                           Ciphertext(par, [b0, b1], 0)),
                          API_MULTIPLY_LAUNCHES)
    same_tensors("Multiplicator.default and make_mul_relin", prod.c, (c0, c1))

    rows = [Ciphertext(par, [c0[i], c1[i]], 0) for i in range(batch)]
    obj, _ = run_counted(
        f"collective decryption of {batch}: DecryptionShare x {parties} + "
        "aggregate",
        lambda r: [aggregate([DecryptionShare.new(sk, ct, r) for sk in sks])
                   for ct in rows], (stream(4),),
        {"ntt": batch * (3 * parties + 1), "rns_scale": batch,
         "zq_mul": batch * parties})
    bat, _ = run_counted(
        f"collective decryption of {batch}: batched_decryption",
        lambda r: [batched_decryption(sks, ct, r) for ct in rows],
        (stream(4),), {"ntt": 3 * batch, "rns_scale": batch,
                       "zq_mul": batch})
    want = (va.astype(object) * vb % t).astype(np.uint64)
    bad = 0
    for x, y, w in zip(obj, bat, want):
        if not np.array_equal(x.value, y.value):
            raise SystemExit("collective decryption: the object API and the "
                             "batched program differ")
        bad += int((y.try_decode(Encoding.simd()) != w).sum())
    noise = collective.measure_noise(rows[0])
    log(f"  {batch} products decrypted collectively, both ways equal, wrong "
        f"slots {bad}, noise {noise} bits (of {sum(MODULI_SIZES)})")
    if bad:
        raise SystemExit(f"collective decryption: {bad} slots wrong")

    r5 = stream(5)
    outs = [SecretKey.random(par, r5) for _ in range(parties)]
    ct_sks, _ = run_counted(
        f"SecretKeySwitchShare x {parties} + aggregate",
        lambda: aggregate([SecretKeySwitchShare.new(si, so, rows[0], r5)
                           for si, so in zip(sks, outs)]), (),
        {"ntt": 3 * parties, "zq_mul": parties})
    sk_o = SecretKey.random(par, r5)
    pk_o = PublicKey.new(sk_o, r5)
    ct1 = pk.try_encrypt(Plaintext.try_encode(va[1], Encoding.simd(1), par), r5)
    ct_pks, _ = run_counted(
        f"PublicKeySwitchShare x {parties} + aggregate at level 1",
        lambda: aggregate([PublicKeySwitchShare.new(sk, pk_o, ct1, r5)
                           for sk in sks]), (),
        {"ntt": 6 * parties, "zq_mul": 4 * parties})
    for name, key, ct, w in (("secret key switch", summed(outs), ct_sks,
                              want[0]),
                             ("public key switch", sk_o, ct_pks, va[1])):
        got = key.try_decrypt(ct).try_decode(Encoding.simd(ct.level))
        wrong = int((got != w).sum())
        log(f"  {name}: level {ct.level}, decrypted by its output key, wrong "
            f"slots {wrong}, noise {key.measure_noise(ct)} bits")
        if wrong or (name == "public key switch") != (ct.level == 1):
            raise SystemExit(f"{name}: {wrong} slots wrong at level {ct.level}")

    r6 = stream(6)
    shares = [PublicKeyShare.new(sk, crp, r6) for sk in sks]
    stacked = torch.stack([sh.p0_share.coeffs for sh in shares])
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, timeout=timedelta(seconds=120))
        try:
            t0 = time.perf_counter()
            got = make_sharded_pk_aggregation(par)(stacked)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    log(f"  make_sharded_pk_aggregation over NCCL (world size 1), "
        f"{parties} stacked shares, {secs * 1e3:.2f} ms")
    same_tensors("NCCL aggregation and aggregate", [got],
                 [aggregate(shares).c[0]])

    bench = mbfv_bench(card)

    for label, kwargs in (("defaults", {}),
                          (f"N = {VOTING_DEGREE}, {parties} parties",
                           dict(num_voters=VOTING_VOTERS, num_parties=parties,
                                degree=VOTING_DEGREE))):
        t0 = time.perf_counter()
        tally, expected = run_voting(**kwargs)
        torch.cuda.synchronize()
        log(f"  run_voting at {label}: tally {tally}, expected {expected}, "
            f"{time.perf_counter() - t0:.2f} s")
        if tally != expected:
            raise SystemExit(f"run_voting at {label}: tally {tally}, "
                             f"expected {expected}")
    return bench


def mbfv_bench(card: str) -> dict:
    """Bench config 6 (bench.py:422-506): one multiparty round for 11 parties
    and 8 ciphertexts at N = 4096, 2 x 62-bit, the party axis leading --
    every share p0_i = -a s_i + e_i against the ciphertexts' c1 as the CRP
    and their sum, every decryption share s_i c1 + e_i, their sum plus c0
    (the phase) and its t/q scale. Inputs as bench.py makes them (t = 1153,
    the secrets and errors drawn after a secret key of seed 42, ciphertexts
    of numpy seed 9). One round held to its launch counts and, row by row,
    to the object API (PublicKeyShare, DecryptionShare, aggregate) on the
    same inputs; then rounds chained as bench.py chains them (the scaled
    row and the key feed the next c0, the phase the next c1), four a step,
    timed with CUDA events beside each kernel of the round and the party
    sums. Returns {rounds_per_s, round_ms, kernels_ms, sums_ms}."""
    from tpufhe_torch.bfv import BfvParametersBuilder, Ciphertext, SecretKey
    from tpufhe_torch.mbfv import (
        CommonRandomPoly,
        DecryptionShare,
        PublicKeyShare,
        aggregate,
    )
    from tpufhe_torch.bfv.keys.secret_key import scaled_plaintext
    from tpufhe_torch.mbfv.batched import sum_parties
    from tpufhe_torch.ops import zq
    from tpufhe_torch.ops.rq import NTT, Poly, ntt_backward, ntt_forward
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64
    from tpufhe_torch.utils.sampling import sample_vec_cbd

    par = (BfvParametersBuilder().set_degree(MBFV_BENCH_DEGREE)
           .set_plaintext_modulus(MBFV_BENCH_PLAINTEXT)
           .set_moduli_sizes(MBFV_BENCH_MODULI_SIZES).build())
    ctx = par.context_at_level(0)
    scaler = par.context_level_at(0).cipher_plain_context.scaler.rns_scaler
    parties, batch, n = MBFV_PARTIES, MBFV_BENCH_BATCH, MBFV_BENCH_DEGREE

    def stream(skip: int):
        """bench.py's stream after its secret key and `skip` CBD rows."""
        rng = ChaCha8Rng(seed_from_u64(42))
        SecretKey.random(par, rng)
        for _ in range(skip):
            sample_vec_cbd(n, par.variance, rng)
        return rng

    rng = stream(0)
    s_rows, e_rows = (np.stack([sample_vec_cbd(n, par.variance, rng)
                                for _ in range(parties)]) for _ in range(2))

    def residues(rows):
        """(P, N) signed rows -> (P, 1, k, N) residues on the card."""
        x = torch.from_numpy(rows).to(ctx.device)[:, None, None, :]
        return torch.remainder(x, ctx.mod.p).to(ctx.dtype)

    s_raw, e_raw = residues(s_rows), residues(e_rows)
    nprng = np.random.default_rng(9)
    c0, c1 = (torch.from_numpy(zq.as_int64(np.stack(
        [nprng.integers(0, m, (batch, n), dtype=np.uint64)
         for m in ctx.moduli], axis=1))).to(ctx.device) for _ in range(2))

    def one_round(c0, c1):
        s = ntt_forward(ctx, s_raw)
        e = ntt_forward(ctx, e_raw)
        pk0 = sum_parties(ctx.add(ctx.mul(ctx.neg(c1), s), e), ctx)
        phase = ctx.add(c0, sum_parties(ctx.add(ctx.mul(s, c1), e), ctx))
        return pk0, phase, scaler.scale(ntt_backward(ctx, phase))

    (pk0, phase, d), _ = run_counted(
        f"bench config 6: one round, {parties} parties x {batch} ciphertexts",
        one_round, (c0, c1), MBFV_BENCH_LAUNCHES)
    sks = [SecretKey(r, par) for r in s_rows]
    for b in range(batch):
        crp = CommonRandomPoly(Poly(ctx, NTT, c1[b]))
        r = stream(parties)
        key = aggregate([PublicKeyShare.new(sk, crp, r) for sk in sks])
        r = stream(parties)
        ct = Ciphertext(par, [c0[b], c1[b]], 0)
        dec = [DecryptionShare.new(sk, ct, r) for sk in sks]
        ph = aggregate([sh.sks_share for sh in dec])
        if not (torch.equal(key.c[0], pk0[b]) and torch.equal(ph[0], phase[b])
                and np.array_equal(aggregate(dec).value,
                                   scaled_plaintext(par, d[b], 0).value)):
            raise SystemExit(f"bench config 6: row {b} differs from the "
                             "object API")
    log(f"  bench config 6: all {batch} rows equal to the object API "
        "(public key, phase, plaintext)")

    rounds = MBFV_BENCH_INNER * MBFV_BENCH_STEPS

    def chained():
        x0, x1 = c0, c1
        for _ in range(rounds):
            key0, ph, dd = one_round(x0, x1)
            x0 = torch.cat([dd[..., :1, :], key0[..., 1:, :]], dim=-2)
            x1 = ph
        return x0

    round_ms = time_ms(chained, 1) / rounds
    s, e = ntt_forward(ctx, s_raw), ntt_forward(ctx, e_raw)
    p0_all = ctx.add(ctx.mul(ctx.neg(c1), s), e)
    h_all = ctx.add(ctx.mul(s, c1), e)
    phase_pb = ntt_backward(ctx, phase)
    kernels_ms = (time_ms(lambda: ntt_forward(ctx, s_raw), 20)
                  + time_ms(lambda: ntt_forward(ctx, e_raw), 20)
                  + time_ms(lambda: ntt_backward(ctx, phase), 20)
                  + time_ms(lambda: scaler.scale(phase_pb), 20))
    sums_ms = time_ms(lambda: (sum_parties(p0_all, ctx),
                               sum_parties(h_all, ctx)), 20)
    rate = batch / round_ms * 1e3
    log(f"  bench config 6: {rounds} chained rounds ({MBFV_BENCH_STEPS} steps "
        f"of {MBFV_BENCH_INNER}), {round_ms:.3f} ms a round of {batch}, "
        f"{rate:.1f} collective rounds/s; kernels {kernels_ms:.3f} ms "
        f"({100 * kernels_ms / round_ms:.1f} %), party sums {sums_ms:.3f} ms "
        f"({100 * sums_ms / round_ms:.1f} %), the rest of the glue "
        f"{round_ms - kernels_ms - sums_ms:.3f} ms on {card}")
    return {"rounds_per_s": rate, "round_ms": round_ms,
            "kernels_ms": kernels_ms, "sums_ms": sums_ms}


def narrow_rest_path(par, card: str) -> None:
    """Phase 24, the rest of the narrow (w30) mode at phase 10's ring (seed
    2042): an expansion key at level 4 and make_expand of 4 ciphertexts
    into 16 each (ntt32 8, ks_accumulate 4), every coefficient of the 64
    outputs checked (output j of ciphertext b holds 2^4 v_b[j + 16 i] at
    x^(16 i), zero elsewhere), equal to
    EvaluationKey.expands on the first; a relinearization key and a
    column-rotation key at level 0 for level-1 ciphertexts (the Switcher's
    scale-up, K2 on int32 rows), ct_mul + relinearizes and make_rotate at
    batch 16, held to their exact counts, every slot checked; then chained
    steps of both and repeated expansions, timed with CUDA events."""
    from tpufhe_torch.bfv import (
        Ciphertext,
        Encoding,
        EvaluationKeyBuilder,
        Plaintext,
        RelinearizationKey,
        SecretKey,
        ct_mul,
    )
    from tpufhe_torch.pipeline import make_decrypt_phase, make_expand, make_rotate
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

    t, n, levels = par.plaintext.value, par.degree(), EXPAND_LEVEL
    size = 1 << levels
    rng = ChaCha8Rng(seed_from_u64(NARROW_REST_SEED))
    t0 = time.perf_counter()
    sk = SecretKey.random(par, rng)
    ek = EvaluationKeyBuilder(sk).enable_expansion(levels).build(rng)
    rk1 = RelinearizationKey.new(sk, rng, 1, 0)
    ek1 = EvaluationKeyBuilder(sk, 1, 0).enable_column_rotation(1).build(rng)
    torch.cuda.synchronize()
    log(f"  keygen (sk, expansion key at level {levels}, relinearization and "
        f"column-rotation keys at level 0 for level 1) "
        f"{time.perf_counter() - t0:.2f} s")

    vals = np.random.default_rng(NARROW_REST_SEED)
    v = vals.integers(0, t, (EXPAND_BATCH, n), dtype=np.uint64)
    cts = [sk.try_encrypt(Plaintext.try_encode(x, Encoding.poly(), par), rng)
           for x in v]
    c0, c1 = (torch.stack([c[i] for c in cts]) for i in (0, 1))
    expand = make_expand(par, ek, levels)
    (e0, e1), _ = run_counted(
        f"narrow expansion of {EXPAND_BATCH} into {size} each", expand,
        (c0, c1), {"ntt32": 2 * levels, "ks_accumulate": levels})
    d = make_decrypt_phase(par, sk)(e0, e1)  # (size, B, k_plain, N)
    got = (d[..., 0, :].cpu().numpy().astype(np.int64) + t) % par.moduli[0] % t
    want = np.zeros((size, EXPAND_BATCH, n), dtype=np.int64)
    want[..., ::size] = (v.reshape(EXPAND_BATCH, n // size, size).transpose(
        2, 0, 1).astype(np.int64) << levels) % t
    bad = int((got != want).sum())
    first = Ciphertext(par, [e0[size - 1, 0], e1[size - 1, 0]], 0)
    log(f"  {size * EXPAND_BATCH} expanded ciphertexts decrypted, wrong "
        f"coefficients {bad}, noise {sk.measure_noise(first)} bits")
    if bad:
        raise SystemExit(f"narrow expansion: {bad} coefficients wrong")
    outs = ek.expands(cts[0], size)
    same_tensors("EvaluationKey.expands and make_expand",
                 [x for ct in outs for x in ct.c],
                 [x[j, 0] for j in range(size) for x in (e0, e1)])

    batch = NARROW_LEVELED_BATCH
    va, vb = (vals.integers(0, t, (batch, n), dtype=np.uint64)
              for _ in range(2))
    ca, cb = (Ciphertext(par, [torch.stack([c[i] for c in cs])
                               for i in (0, 1)], 1)
              for cs in ([sk.try_encrypt(Plaintext.try_encode(
                  x, Encoding.simd(1), par), rng) for x in vs]
                  for vs in (va, vb)))

    def mul_relin(a, b):
        c = ct_mul(a, b)
        rk1.relinearizes(c)
        return c

    prod, _ = run_counted(f"narrow leveled mul+relin at batch {batch}",
                          mul_relin, (ca, cb), NARROW_LEVELED_MUL_LAUNCHES)
    check_parts("narrow leveled mul+relin", par, sk, prod,
                (va.astype(object) * vb % t).astype(np.uint64))
    gk = ek1.gk[ek1.rot_to_gk_exponent[1]]
    rotate = make_rotate(par, gk, level=1)
    (r0, r1), _ = run_counted(f"narrow leveled rotation at batch {batch}",
                              rotate, (ca[0], ca[1]),
                              NARROW_LEVELED_ROT_LAUNCHES)
    h = n // 2
    check_parts("narrow leveled rotation", par, sk,
                Ciphertext(par, [r0, r1], 1),
                np.concatenate([np.roll(va[:, :h], -1, axis=1),
                                np.roll(va[:, h:], -1, axis=1)], axis=1))

    steps = NARROW_REST_STEPS

    def chained_mul():
        c = ca
        for _ in range(steps):
            c = mul_relin(c, cb)
        return c[0]

    def chained_rot():
        x0, x1 = ca[0], ca[1]
        for _ in range(steps):
            x0, x1 = rotate(x0, x1)
        return x0

    mul_ms = time_ms(chained_mul, 1) / steps
    rot_ms = time_ms(chained_rot, 1) / steps
    exp_ms = time_ms(lambda: expand(c0, c1), steps)
    log(f"  {steps} chained narrow leveled mul+relin at batch {batch}: "
        f"{mul_ms:.3f} ms/step, {batch / mul_ms * 1e3:.1f} mul+relin/s; "
        f"rotations {rot_ms:.3f} ms/step, {batch / rot_ms * 1e3:.1f} "
        f"rotations/s; expansion of {EXPAND_BATCH} into {size} "
        f"{exp_ms:.3f} ms, {EXPAND_BATCH / exp_ms * 1e3:.1f} expansions/s "
        f"on {card}")


# phase 25: the multi-GPU programs (tpufhe_torch.parallel)


def parallel_worker(rank: str, world: str, backend: str, work: str) -> int:
    """One rank of phase 25 (chip_smoke.py --parallel-worker RANK WORLD
    BACKEND DIR): joins the group through a FileStore in DIR, loads the
    parent's inputs and keys (wire bytes), and runs on its blocks, each
    with the launch counters set to 0 just before it: DistNtt forward and
    inverse of phase 12's mul+relin input stack, make_seq_sharded_mul_relin
    on phase 12's inputs, then chained steps timed (the all_gathers marked
    with CUDA events), and make_sharded_mul_relin on phase 4's inputs over
    the (world, 1) and (1, world) batch x limb meshes; saves its blocks,
    launches and times to DIR/outRANK.pt."""
    from datetime import timedelta

    import torch.distributed as dist

    from tpufhe_torch import kernels
    from tpufhe_torch.bfv import BfvParametersBuilder, RelinearizationKey
    from tpufhe_torch.parallel import (
        batch_limb_mesh,
        make_sharded_mul_relin,
        shard_ciphertext,
    )
    from tpufhe_torch.parallel import ntt_dist as nd
    from tpufhe_torch.parallel.seq_pipeline import make_seq_sharded_mul_relin

    rank, world = int(rank), int(world)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(work, "store"), world), rank=rank, world_size=world,
        timeout=timedelta(seconds=PAR_PG_TIMEOUT))
    data = torch.load(os.path.join(work, "in.pt"), weights_only=False)
    out = {"launches": {}, "ms": {}}

    def counted(name, fn, *args):
        torch.cuda.synchronize()
        kernels.reset_launches()
        res = fn(*args)
        torch.cuda.synchronize()
        out["launches"][name] = {k: v for k, v in kernels.LAUNCHES.items()
                                 if v}
        return res

    par16 = (BfvParametersBuilder().set_degree(N16K)
             .set_plaintext_modulus(PLAINTEXT)
             .set_moduli_sizes(N16K_MODULI_SIZES).build())
    blk = N16K // world
    a16 = [t[..., rank * blk:(rank + 1) * blk].cuda().contiguous()
           for t in data["n16k"]]
    dist_ntt = nd.DistNtt(par16.context_at_level(0))
    x = torch.stack(a16)
    out["dist"] = [t.cpu() for t in counted(
        "dist", lambda: (dist_ntt.forward(x), dist_ntt.backward(x)))]

    seq = make_seq_sharded_mul_relin(
        par16, RelinearizationKey.from_bytes(data["rk16"], par16), None)
    out["seq"] = [t.cpu() for t in counted("seq", seq, *a16)]
    marks = []
    gather = nd.gather_blocks

    def marked_gather(x, group):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        y = gather(x, group)
        ev[1].record()
        marks.append(ev)
        return y

    def chained():
        c0, c1 = a16[0], a16[1]
        for _ in range(PAR_RATE_STEPS):
            c0, c1 = seq(c0, c1, a16[2], a16[3])

    nd.gather_blocks = marked_gather
    chained()
    torch.cuda.synchronize()
    marks.clear()
    step_ms = time_ms(chained, 1) / PAR_RATE_STEPS
    nd.gather_blocks = gather
    coll = sum(s.elapsed_time(e) for s, e in marks[-4 * PAR_RATE_STEPS:])
    out["ms"]["seq"] = step_ms
    out["ms"]["seq_collective"] = coll / PAR_RATE_STEPS

    par = (BfvParametersBuilder().set_degree(DEGREE)
           .set_plaintext_modulus(PLAINTEXT).set_moduli_sizes(MODULI_SIZES)
           .build())
    rk = RelinearizationKey.from_bytes(data["rk"], par)
    main = [t.cuda() for t in data["main"]]
    for shape in ((world, 1), (1, world)):
        mesh = batch_limb_mesh(*shape)
        fn = make_sharded_mul_relin(par, rk, mesh)
        args = [shard_ciphertext(mesh, t) for t in main]
        name = f"sharded_{shape[0]}x{shape[1]}"
        out[name] = [t.cpu() for t in counted(name, fn, *args)]
        out["ms"][name] = time_ms(lambda: fn(*args), 3)
    torch.save(out, os.path.join(work, f"out{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def parallel_path(par16, keys16, n16k, par, mp, card) -> dict:
    """Phase 25: the multi-GPU programs over min(cards, 4) ranks on NCCL
    (4 with four cards or more, else 2), or, on a one-card machine, two
    worker processes on the card over gloo. The workers (parallel_worker)
    run DistNtt at phase 12's shapes, make_seq_sharded_mul_relin on phase
    12's keys and inputs (N = 16384, 6 x 62-bit, batch 16) and
    make_sharded_mul_relin on phase 4's (BASELINE config 3) over the
    (ranks, 1) and (1, ranks) batch x limb meshes, each logging to a file;
    the phase fails if a worker fails or the workers outlast PAR_TIMEOUT
    in all. Their blocks side by side must
    equal K1's whole-row transforms, phase 12's make_mul_relin output
    (every slot of the product decrypted) and phase 4's, each rank's
    launches their exact counts. Returns {"launches": rank 0's seq counts,
    "ms": per-rank times}."""
    import tempfile

    from tpufhe_torch.bfv import Encoding
    from tpufhe_torch.ops.rq import ntt_backward, ntt_forward

    cards = torch.cuda.device_count()
    if cards >= 2:
        world, backend = (4 if cards >= 4 else 2), "nccl"
        log(f"  {world} ranks over NCCL, one card each ({cards} cards)")
    else:
        world, backend = 2, "gloo"
        log("  one card: 2 ranks on it over gloo, which takes the CUDA "
            "tensors and moves each all_gather through the host (the "
            "collective's time is the host's, not NVLink's)")
    step16, a16, _ = n16k["mul_relin"]
    want16 = step16(*a16)
    ctx16 = par16.context_at_level(0)
    x = torch.stack(a16)
    want_dist = (ntt_forward(ctx16, x), ntt_backward(ctx16, x))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        torch.save({"n16k": [t.cpu() for t in a16],
                    "main": [t.cpu() for t in mp.inputs],
                    "rk16": keys16.rk.to_bytes(), "rk": mp.rk.to_bytes()},
                   os.path.join(work, "in.pt"))
        torch.cuda.empty_cache()
        here = os.path.dirname(os.path.abspath(__file__))
        logs = [os.path.join(work, f"log{r}.txt") for r in range(world)]
        procs = []
        for r, path in enumerate(logs):
            with open(path, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--parallel-worker", str(r), str(world), backend, work],
                    cwd=here, stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + PAR_TIMEOUT
        late = False
        try:
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            late = True
        finally:
            for p in procs:
                p.kill()
                p.wait()

        def tails():
            out = []
            for r, path in enumerate(logs):
                with open(path) as f:
                    out.append(f"rank {r}:\n{f.read()[-3000:]}")
            return "\n".join(out)

        if late:
            raise SystemExit(f"phase 25: the workers outlasted {PAR_TIMEOUT} "
                             f"s\n{tails()}")
        if any(p.returncode != 0 for p in procs):
            raise SystemExit(f"phase 25: worker exit codes "
                             f"{[p.returncode for p in procs]}\n{tails()}")
        outs = [torch.load(os.path.join(work, f"out{r}.pt"), weights_only=False)
                for r in range(world)]
    log(f"  {world} workers ran in {time.perf_counter() - t0:.1f} s "
        f"(start-up included)")

    def same(name, got, want):
        if not all(torch.equal(g, w.cpu()) for g, w in zip(got, want)):
            raise SystemExit(f"phase 25: {name} differs from the single-card "
                             f"result")
        log(f"  {name}: the {world} ranks' blocks equal the single-card "
            f"result")

    expected = {"dist": DIST_LAUNCHES, "seq": SEQ_LAUNCHES}
    expected |= {f"sharded_{w}x{h}": MUL_LAUNCHES
                 for w, h in ((world, 1), (1, world))}
    for r, o in enumerate(outs):
        for name, want in expected.items():
            if o["launches"][name] != want:
                raise SystemExit(f"phase 25: rank {r} {name} launches "
                                 f"{o['launches'][name]}, expected {want}")
    log(f"  launches per rank: DistNtt forward + inverse {DIST_LAUNCHES}, "
        f"sequence-sharded mul+relin {SEQ_LAUNCHES}, batch x limb "
        f"mul+relin {MUL_LAUNCHES}, on every rank")

    def side_by_side(name, dim):
        return [torch.cat([o[name][i] for o in outs], dim=dim)
                for i in range(len(outs[0][name]))]

    same(f"DistNtt forward and inverse of {tuple(x.shape)} vs K1",
         side_by_side("dist", -1), want_dist)
    c0, c1 = side_by_side("seq", -1)
    same(f"N = {N16K} sequence-sharded mul+relin of {N16K_BATCH} vs phase "
         f"12's make_mul_relin", (c0, c1), want16)
    va, vb = keys16.va.astype(object), keys16.vb.astype(object)
    check_outputs("sequence-sharded mul+relin", par16, keys16.sk,
                  c0.cuda(), c1.cuda(),
                  (va * vb % par16.plaintext.value).astype(np.uint64),
                  Encoding.simd())
    same(f"batch x limb mul+relin of {BATCH} on {world} x 1 vs phase 4's",
         side_by_side(f"sharded_{world}x1", 0), mp.product)
    same(f"batch x limb mul+relin of {BATCH} on 1 x {world} vs phase 4's",
         side_by_side(f"sharded_1x{world}", -2), mp.product)
    ms = {name: [o["ms"][name] for o in outs] for name in outs[0]["ms"]}

    def fmt(vals):
        return ", ".join(f"{v:.3f}" for v in vals)

    log(f"  sequence-sharded mul+relin, batch {N16K_BATCH}: ms per step per "
        f"rank [{fmt(ms['seq'])}], of which the 4 all_gathers [{fmt(ms['seq_collective'])}] "
        f"({backend}) on {card}")
    for w, h in ((world, 1), (1, world)):
        name = f"sharded_{w}x{h}"
        log(f"  batch x limb mul+relin on {w} x {h}: ms per step per rank "
            f"[{fmt(ms[name])}] ({backend}) on {card}")
    return {"launches": outs[0]["launches"]["seq"], "ms": ms,
            "world": world, "backend": backend}


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--parallel-worker":
        return parallel_worker(*sys.argv[2:6])
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
    par_mulpir = (BfvParametersBuilder().set_degree(MULPIR_DEGREE)
                  .set_plaintext_modulus(MULPIR_PLAINTEXT)
                  .set_moduli_sizes(MULPIR_MODULI_SIZES).build())
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
    dist_records = check_dist_kernels(par_16k, gen, int32_rate)
    records["ntt_dist"] = dist_records["ntt_dist_d2"]
    wider_records = check_wider_kernels(par_wider, gen, int32_rate)
    dot_records = check_dot_kernels({"dot": par_rot, "n16k": par_16k,
                                     "main": par, "d128": par_d128}, gen,
                                    int32_rate)
    records["ct_pt_dot"] = dot_records.pop("dot bench")
    api_records = check_api_kernels(par, gen, int32_rate)
    k1_records = check_single_modulus_kernels(par_k1, gen, int32_rate)
    d128_records = check_default128_kernels(par_d128, gen, int32_rate)
    lazy_records = check_lazy_kernels({"main": par.context_at_level(0),
                                       "n4096": par_4096.context_at_level(0),
                                       "n16k": par_16k.context_at_level(0),
                                       "narrow": par_w30.context_at_level(0)},
                                      gen, int32_rate)
    ks_tail_records = check_ks_tail({"mulpir": par_mulpir.context_at_level(0),
                                     "main": par.context_at_level(0),
                                     "n16k": par_16k.context_at_level(0)},
                                    gen, int32_rate)
    zq_records = check_zq_mul_kernels(par_mulpir, par_rot, gen, int32_rate)
    fold_records = check_expand_fold_kernels(par_mulpir, gen, int32_rate)
    pir = pir_setup(par_16k)
    pir_records, pir_routes = pir_kernels(pir, int32_rate, card)
    mulpir = mulpir_setup(par_mulpir)
    mulpir_records, mulpir_routes = mulpir_kernels(mulpir, int32_rate, card)
    torch.cuda.empty_cache()  # the PIR checks' buffers, before phase 4

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
    n16k, keys16 = n16k_path(par_16k, mp.margin)
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
    pk = object_api_path(par, mp, variants)

    log(f"phase 17: the single-modulus key switch, N = {K1_DEGREE}, 1 x 62-bit")
    single_modulus_path(par_k1)

    log(f"phase 18: default_parameters_128({D128_BITS}), N = {DEGREE}")
    default128_path(par_d128, card)

    log(f"phase 19: PIR at BASELINE config 5, N = {N16K}, 6 x 62-bit, dims "
        f"{PIR_DIMS}, batch {PIR_BATCH}")
    path_launches, _ = pir_path(pir, pir_records["pir_response"], card)

    log(f"phase 20: MulPIR, N = {MULPIR_DEGREE}, moduli of "
        f"{MULPIR_MODULI_SIZES} bits, {MULPIR_ELEMENTS} elements of "
        f"{MULPIR_ELEMENT_BYTES} bytes")
    path_launches |= mulpir_path(mulpir, mulpir_records, card)["launches"]

    log("phase 21: the wire format at BASELINE config 3")
    with KernelRecorder("phase 21") as rec21:
        wire_path(par, mp, pk, programs["keys"], mulpir, card)
    torch.cuda.empty_cache()
    log(f"phase 22: the applications, N = {DEGREE}")
    with KernelRecorder("phase 22") as rec22:
        walkthroughs(card)
        rgsw_batch(par, mp, card)
        large_t_path(card)
        pir_apps(card)
    torch.cuda.empty_cache()
    log(f"phase 23: multiparty BFV, N = {DEGREE}, 3 x 62-bit, "
        f"{MBFV_PARTIES} parties")
    with KernelRecorder("phase 23") as rec23:
        mbfv_path(par, card)
    torch.cuda.empty_cache()
    log(f"phase 24: the rest of the narrow mode, N = {DEGREE}, 7 x 30-bit")
    with KernelRecorder("phase 24") as rec24:
        narrow_rest_path(par_w30, card)
    log("phase 3 at the calls of phases 21 to 24")
    app_records = {
        "wire_format": check_recorded(rec21, int32_rate, "per phase-21 run",
                                      None),
        "applications": check_recorded(rec22, int32_rate, "per phase-22 run",
                                       None),
        "multiparty": check_recorded(rec23, int32_rate, "per phase-23 run",
                                     None),
        "narrow_rest": check_recorded(rec24, int32_rate, "per phase-24 run",
                                      None)}
    del rec21, rec22, rec23, rec24
    torch.cuda.empty_cache()
    log(f"phase 25: multi-GPU, N = {N16K} sequence-sharded and BASELINE "
        f"config 3 batch x limb")
    par_run = parallel_path(par_16k, keys16, n16k, par, mp, card)
    # each PIR program's launches from its counted run in phase 19 or 20
    # (the key generation's from its recorded run, counted likewise)
    program_records = pir_records | mulpir_records
    for tag, launches in path_launches.items():
        for name, count in launches.items():
            program_records[tag][name]["launches"] = count
    # ks_tail: its calls in MulPIR's expansion as recorded in phase 3, or
    # where no program takes it, the phase-3 case at that shape
    records["ks_tail"] = mulpir_records["mulpir_expansion"].get(
        "ks_tail", ks_tail_records["ks_tail_mulpir"])
    # zq_mul: its calls in phase 3's recorded MulPIR batch of 16
    records["zq_mul"] = mulpir_records["mulpir_batch"]["zq_mul"]
    # expand_fold: its calls in that batch (one a doubling)
    records["expand_fold"] = mulpir_records["mulpir_batch"]["expand_fold"]
    # rq_pack, rq_unpack: their calls in that batch's recorded wire path
    for name in ("rq_pack", "rq_unpack"):
        records[name] = mulpir_records["mulpir_wire"][name]

    # the program whose run gives each kernel's launches
    runs = {"rotate_tail": ("rotation", rot_launches),
            "tensor": ("square", variants["square"][1]),
            "intt_scale": ("default fused mul+relin",
                           variants["default fused"][1]),
            "ntt32": ("narrow mul+relin", narrow["mul_relin"][2]),
            "ks_accumulate": (f"N = {N16K} mul+relin", n16k["mul_relin"][2]),
            "ct_pt_dot": (f"dot product of {DOT_PAIRS} pairs", dot_launches),
            "ntt_dist": (f"rank 0 of phase 25's N = {N16K} sequence-sharded "
                         f"mul+relin ({par_run['world']} ranks, "
                         f"{par_run['backend']})", par_run["launches"]),
            "ks_tail": ("MulPIR expansion (phase 20)",
                        path_launches["mulpir_expansion"]),
            "zq_mul": (f"MulPIR batch of {MULPIR_BATCH} (phase 3)",
                       mulpir.batch_launches),
            "expand_fold": (f"MulPIR batch of {MULPIR_BATCH} (phase 3)",
                            mulpir.batch_launches),
            "rq_pack": (f"MulPIR batch of {MULPIR_BATCH}'s wire path "
                        f"(phase 3)", mulpir.wire_launches),
            "rq_unpack": (f"MulPIR batch of {MULPIR_BATCH}'s wire path "
                          f"(phase 3)", mulpir.wire_launches)}
    other_shapes = {
        "ntt": {label: side[label] for label in side
                if label.startswith("ntt_")}
        | {"n16384": n16k_records["ntt"],
           "n16384_rotation": n16k_records["ntt_rotation"]}
        | {f"dist_d{d}": dist_records[f"ntt_d{d}"] for d in DIST_SHARDS}
        | {label: rec for label, rec in lazy_records.items()
           if label.startswith("ntt_")},
        "ntt_dist": {f"d{d}": dist_records[f"ntt_dist_d{d}"]
                     for d in DIST_SHARDS[1:]},
        "rns_scale": {"strategy2_kp2": variant_records["rns_scale_s2"],
                      "narrow_int32": narrow_records["rns_scale_int32"],
                      "n16384": n16k_records["rns_scale"]}
        | {label: rec for label, rec in wider_records.items()},
        "tensor": {"n16384": n16k_records["tensor"]},
        "ct_pt_dot": dot_records,
        "ks_accumulate": {"rotation": n16k_records["ks_accumulate_rotation"],
                          "lazy_route_n16384":
                          ks_tail_records["unfused_lazy_n16384"]}
        | {label: narrow_records[label] for label in
           ("ks_accumulate_int32", "ks_accumulate_int32_rotation")},
        "ks_tail": {label: rec for label, rec in ks_tail_records.items()
                    if label.startswith("ks_tail_")},
        "zq_mul": zq_records,
        "expand_fold": fold_records,
        "rq_pack": {},
        "rq_unpack": {},
        "tensor_intt": {f"strategy2_kp{kp}":
                        variant_records[f"tensor_intt_s2_kp{kp}"]
                        for kp in (1, 2)},
        "intt_scale": {"strategy2_kp2": variant_records["intt_scale_s2"],
                       "general": variant_records["intt_scale_general"]},
        "ntt32": {label: narrow_records[label] for label in
                  ("ntt32_rotation", "ntt32_512_forward", "ntt32_512_inverse")}
        | {label: rec for label, rec in lazy_records.items()
           if label.startswith("ntt32_")},
        "relin_tail": {label: tails[label] for label in
                       ("relin_tail_8x62", "relin_tail_n4096")},
        "rotate_tail": {"rotate_tail_n4096": tails["rotate_tail_n4096"]},
    }
    for tag, recs in (("object_api", api_records),
                      ("single_modulus", k1_records),
                      ("default128", d128_records)):
        for name, rec in recs.items():
            other_shapes[name][tag] = rec
    for tag, recs in (program_records | app_records).items():
        for name, rec in recs.items():
            other_shapes[name][tag] = rec
    for tag, routes in (("pir", pir_routes), ("mulpir", mulpir_routes)):
        other_shapes["tensor"][f"{tag}_second_dimension_a"] = routes["tensor"]
    tail_keys = ("unfused_ms", "lazy_unfused_ms", "canonical_ms", "lazy_ms",
                 "cluster", "blocks_per_sm", "clusters", "plan")
    out = []
    for name, (src, replaces) in kernels.KERNELS.items():
        r = records[name]
        program, launches = runs.get(name, ("mul+relin", mp.launches))
        entry = {
            "name": name, "route": "cuda",
            "source": f"tpufhe_torch/csrc/{src}", "replaces": replaces,
            "launches": launches.get(name, 0), "program": program,
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
                        ("ms", "plain_ms", "bound_ms", "bound_by", "split_ms",
                         "launches", "item_ms") + tail_keys if k in rec}
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
