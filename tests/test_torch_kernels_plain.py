"""The plain versions of kernels K3 (tensor + iNTT), K4 (relin tail) and K5
(rotate tail) against the XLA composition they replace in tpufhe's
pipeline, at N = 1024, word for word; and the host-side model of the
tails' design (launch plan, transform pass schedule, shared-memory
swizzle)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe import pipeline as jpl
from tpufhe.ops.rq import Context as JContext
from tpufhe.ops.rq import ntt_backward_any, ntt_forward_any

import tpufhe_torch.bfv as T
from tpufhe_torch import convert, kernels
from tpufhe_torch import pipeline as tpl
from tpufhe_torch.bfv.keys.key_switching_key import shoup_of
from tpufhe_torch.ops.ntt import forward_plain
from tpufhe_torch.ops.rq import Context as TContext

N = 1024
B = 2


@pytest.fixture(scope="module")
def params():
    jp = (J.BfvParametersBuilder().set_degree(N).set_plaintext_modulus(65537)
          .set_moduli_sizes([62, 62, 62]).build())
    tp = (T.BfvParametersBuilder().set_degree(N).set_plaintext_modulus(65537)
          .set_moduli_sizes([62, 62, 62]).set_device("cpu").build())
    return jp, tp


def _residues(moduli, lead, seed):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, p, lead + (N,), dtype=np.uint64)
                  for p in moduli], axis=-2)
    x.reshape((-1, len(moduli), N))[0] = np.array(moduli, dtype=np.uint64)[:, None] - 1
    return x.astype(np.int64)


def _random_key(tctx, seed):
    """A random (k, k, N) key with its Shoup constants, in the port's form
    and as tpufhe's lane-folded (value, Shoup) pairs per row."""
    k = tctx.k
    key = SimpleNamespace()
    key.c0 = torch.from_numpy(_residues(tctx.moduli, (k,), seed))
    key.c1 = torch.from_numpy(_residues(tctx.moduli, (k,), seed + 1))
    key.c0_shoup = shoup_of(key.c0, tctx.moduli)
    key.c1_shoup = shoup_of(key.c1, tctx.moduli)

    def lanes(t):
        return convert.words_to_lanes(t.numpy())

    ksk_c0 = [(lanes(key.c0[i]), lanes(key.c0_shoup[i])) for i in range(k)]
    ksk_c1 = [(lanes(key.c1[i]), lanes(key.c1_shoup[i])) for i in range(k)]
    return key, ksk_c0, ksk_c1


def test_tensor_intt_plain_matches_tpufhe(params):
    jp, tp = params
    jctx = jp.context_level_at(0).mul_params().to_ctx
    tctx = tp.context_level_at(0).mul_params().to_ctx
    ext = _residues(tctx.moduli, (4, B), 1)
    tensor = jpl._tensor_for(jctx)

    def ref(x):
        t = tensor(x[0], x[1], x[2], x[3])
        return ntt_backward_any(jctx, t, in_bits=62)

    want = jax.jit(ref)(convert.words_to_lanes(ext))
    got = tpl.tensor_intt_plain(tctx, torch.from_numpy(ext))
    np.testing.assert_array_equal(convert.lanes_to_words(np.asarray(want)),
                                  got.numpy())


def _contexts(k):
    """tpufhe's and the port's contexts over k 62-bit moduli at degree N."""
    moduli = T.BfvParametersBuilder.generate_moduli([62] * k, N)
    return JContext(moduli, N), TContext(moduli, N, "cpu")


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_relin_tail_plain_matches_tpufhe(k):
    """K4's plain version against tpufhe's stacked forward NTT, accumulate
    and adds (pipeline.py:559-569), at every k the card's K4 instance is
    held at and more."""
    jctx, tctx = _contexts(k)
    dsc = _residues(tctx.moduli, (3, B), 2)
    key, ksk_c0, ksk_c1 = _random_key(tctx, 3)
    _, add_c = jpl._ops_for(jctx)

    def ref(x):
        digits = jpl._ksk_digits(jctx, x[2])
        ntts = ntt_forward_any(jctx, jnp.concatenate([x[:2], digits]),
                               in_bits=62)
        ks0, ks1 = jpl._ksk_accumulate(jctx, ntts[2:], ksk_c0, ksk_c1)
        return jnp.stack([add_c(ntts[0], ks0), add_c(ntts[1], ks1)])

    want = jax.jit(ref)(convert.words_to_lanes(dsc))
    got0, got1 = tpl.relin_tail_plain(tctx, torch.from_numpy(dsc), key)
    want = convert.lanes_to_words(np.asarray(want))
    np.testing.assert_array_equal(want[0], got0.numpy())
    np.testing.assert_array_equal(want[1], got1.numpy())


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_rotate_tail_plain_matches_tpufhe(k):
    """K5's plain version against _key_switch_batched + the add of s0
    (tpufhe pipeline.py:778-779); k = 4 is BASELINE config 4's."""
    jctx, tctx = _contexts(k)
    s0 = _residues(tctx.moduli, (B,), 5)
    c2 = _residues(tctx.moduli, (B,), 6)
    key, ksk_c0, ksk_c1 = _random_key(tctx, 7)
    _, add_c = jpl._ops_for(jctx)

    def ref(s0, c2):
        ks0, ks1 = jpl._key_switch_batched(jctx, c2, ksk_c0, ksk_c1)
        return jnp.stack([add_c(ks0, s0), ks1])

    want = jax.jit(ref)(convert.words_to_lanes(s0), convert.words_to_lanes(c2))
    got0, got1 = tpl.rotate_tail_plain(tctx, torch.from_numpy(s0),
                                       torch.from_numpy(c2), key)
    want = convert.lanes_to_words(np.asarray(want))
    np.testing.assert_array_equal(want[0], got0.numpy())
    np.testing.assert_array_equal(want[1], got1.numpy())


def test_tail_plan_within_card_limits():
    """The tails' launch plan (kernels.tail_plan) for K4's k + 2 rows and
    K5's k, k = 1 .. 18, at every degree the builders produce up to 8192:
    one CTA per row up to the largest cluster the card runs (16), so one
    round wherever k + 2 <= 16; at most 512 threads; one row of shared
    memory a CTA, so three CTAs share an SM's 228 KB."""
    for k in range(1, 19):
        for n in (1 << e for e in range(3, 14)):
            for rows in (k + 2, k):
                cluster, threads, smem = kernels.tail_plan(rows, n)
                assert cluster == min(rows, 16)
                assert (-(-rows // cluster) == 1) == (rows <= 16)
                assert threads == min(n // 2, 512)
                assert smem == 8 * n and 3 * smem <= 228 * 1024


def _slot(i):
    """ntt_pass_device.cuh pass_slot."""
    return i ^ (((i >> 4) & 3) * 5)


def _unit_slots(first, ls, S):
    """The slots of a unit's words first + t 2^ls as ntt_pass computes
    them: one pass_slot call and an XOR where bits ls .. ls + S - 1 miss
    bits 4, 5 (the bits pass_slot reads), else one call a word."""
    if ls + S <= 4 or ls >= 6:
        return [_slot(first) ^ (t << ls) for t in range(1 << S)]
    return [_slot(first | (t << ls)) for t in range(1 << S)]


def _passes_forward(x, table, p):
    """forward_passes (the tails' transform) on one row, in exact arithmetic mod p, on words kept at
    their slots: unit q of pass (s0, S) is the 2^S words first + t 2^ls of
    stage-s0 group g; stage s0 + r pairs t with t + 2^(S-1-r) under the
    group's twiddle t // 2^(S-r) of that stage, read from the pass-ordered
    table at off + g (2^S - 1) + 2^r - 1 + t // 2^(S-r)."""
    n = len(x)
    logn = n.bit_length() - 1
    row = [0] * n
    for i, v in enumerate(x):
        row[_slot(i)] = int(v)
    off = 0
    for s0, S in kernels.ntt_passes(logn):
        ls = logn - s0 - S
        for q in range(n >> S):
            g, first = q >> ls, ((q >> ls) << (ls + S)) | (q & ((1 << ls) - 1))
            idx = _unit_slots(first, ls, S)
            v = [row[i] for i in idx]
            for r in range(S):
                half = (1 << S) >> (r + 1)
                for t in range(1 << S):
                    if t & half:
                        continue
                    w = int(table[off + g * ((1 << S) - 1) + (1 << r) - 1
                                  + (t >> (S - r))])
                    y = v[t + half] * w % p
                    v[t], v[t + half] = (v[t] + y) % p, (v[t] - y) % p
            for i, val in zip(idx, v):
                row[i] = val
        off += ((1 << S) - 1) << s0
    return [row[_slot(i)] for i in range(n)]


@pytest.mark.parametrize("n", [16, 32, 256, 1024, 4096, 8192])
def test_pass_schedule_matches_forward_plain(n):
    """The tails' transform schedule, on swizzled words, with its twiddles
    from NttTables.pass_twiddles, gives the port's forward NTT (ops/ntt.py
    forward_plain, held against tpufhe) word for word, at degrees with
    log2(n) odd and even, the fixed instances' 4096 and 8192 among them."""
    (p,) = T.BfvParametersBuilder.generate_moduli([62], n)
    tctx = TContext([p], n, "cpu")
    x = np.random.default_rng(n).integers(0, p, n, dtype=np.uint64)
    x[0] = p - 1
    x = x.astype(np.int64)
    want = forward_plain(torch.from_numpy(x)[None], tctx.tables.omegas,
                         tctx.tables.mod)[0].numpy()
    tw = tctx.tables.pass_twiddles(False)
    assert tw.shape == (1, n, 2) and tw.dtype == torch.int64
    order = kernels.forward_twiddle_order(n)
    np.testing.assert_array_equal(tw[0, :, 1].numpy(),
                                  tctx.tables.omegas_shoup[0, order].numpy())
    got = _passes_forward(x, tw[0, :, 0].tolist(), p)
    np.testing.assert_array_equal(np.array(got, dtype=np.int64), want)


def test_tail_twiddle_order_is_pass_ordered():
    """kernels.forward_twiddle_order lists every bit-reversed omega index
    1 .. n - 1 once (then the pad 0), each pass's twiddles in one block of
    2^s0 (2^S - 1) entries from its own stages, at every degree 8 .. 8192."""
    for logn in range(3, 14):
        n = 1 << logn
        order = kernels.forward_twiddle_order(n)
        assert len(order) == n and order[-1] == 0
        assert sorted(order[:-1]) == list(range(1, n))
        off = 0
        for s0, S in kernels.ntt_passes(logn):
            size = ((1 << S) - 1) << s0
            assert all(s0 <= i.bit_length() - 1 < s0 + S
                       for i in order[off:off + size])
            off += size
        assert off == n - 1


def test_slots_free_of_bank_conflicts():
    """pass_slot is a permutation of every row, and each pass's half-warp of
    sixteen 8-byte words (and the row's load and slice reads, sixteen
    consecutive words) lands in sixteen distinct bank pairs (slot mod 16)
    at n = 4096 and 8192, with the slots ntt_pass computes."""
    for logn in (12, 13):
        n = 1 << logn
        assert sorted(_slot(i) for i in range(n)) == list(range(n))
        for s0, S in kernels.ntt_passes(logn):
            ls = logn - s0 - S
            for q0 in range(0, n >> S, 16):
                units = [_unit_slots(((q >> ls) << (ls + S))
                                     | (q & ((1 << ls) - 1)), ls, S)
                         for q in range(q0, q0 + 16)]
                for t in range(1 << S):
                    assert len({u[t] % 16 for u in units}) == 16
        for e0 in range(0, n, 16):
            assert len({_slot(e) % 16 for e in range(e0, e0 + 16)}) == 16
