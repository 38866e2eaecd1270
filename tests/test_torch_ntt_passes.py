"""The host-side model of the Hopper transform passes
(tpufhe_torch/csrc/ntt_pass_device.cuh) behind K1 (ntt.cu), K3
(tensor_intt.cu), K8 (intt_scale.cu) and the narrow K9 (ntt32.cu): the pass
schedules and their pass-ordered tables (K9's of three stages a pass on
4-byte words), the N = 16384 row split across a two-CTA cluster, the
shared-memory slots of 8- and 4-byte words, the launch plans and the
clusters' coefficient shares. Each schedule runs on exact Python integers,
on words kept at their swizzled slots, and is held word for word against
the port's plain transforms (ops/ntt.py forward_plain / backward_plain and
forward32_plain / backward32_plain, themselves held against tpufhe), and
K3's cluster against tensor_intt_plain."""

import os
import re

import numpy as np
import pytest
import torch

import tpufhe_torch.bfv as T
from tpufhe_torch import kernels
from tpufhe_torch import pipeline as tpl
from tpufhe_torch.ops.intt_scale import intt_scale_fits
from tpufhe_torch.ops.ntt import (backward32_plain, backward_plain,
                                  forward32_plain, forward_plain)
from tpufhe_torch.ops.rq import Context as TContext

# 228 KB of shared memory an SM, 65,536 registers, at most 1,024 threads a
# CTA and 8 CTAs a portable cluster (sm_90)
SM_SMEM = 228 * 1024


def _slot(i):
    """ntt_pass_device.cuh pass_slot."""
    return i ^ (((i >> 4) & 3) * 5)


def _slot32(i):
    """ntt_pass_device.cuh pass_slot32, the slots of 4-byte words."""
    return i ^ (((i >> 5) & 1) * 5) ^ (((i >> 6) & 1) * 26) ^ (
        ((i >> 7) & 1) * 20)


def _unit(q, ls, s, narrow=False):
    """The words of unit q of a pass with stride 2^ls and s stages, and
    their slots as ntt_pass computes them: 8-byte words, one pass_slot call
    and an XOR where bits ls .. ls + s - 1 miss bits 4, 5, else one call a
    word; 4-byte words, pass_slot32 of the unit's first word XOR that of
    each word's offset."""
    first = ((q >> ls) << (ls + s)) | (q & ((1 << ls) - 1))
    words = [first | (t << ls) for t in range(1 << s)]
    if narrow:
        return words, [_slot32(first) ^ _slot32(t << ls)
                       for t in range(1 << s)]
    if ls + s <= 4 or ls >= 6:
        return words, [_slot(first) ^ (t << ls) for t in range(1 << s)]
    return words, [_slot(w) for w in words]


def _forward_unit(v, tw, p):
    """forward_unit on a list of 2^s exact words."""
    size = len(v)
    s = size.bit_length() - 1
    for r in range(s):
        half = size >> (r + 1)
        for t in range(size):
            if t & half:
                continue
            y = v[t + half] * tw[(1 << r) - 1 + (t >> (s - r))] % p
            v[t], v[t + half] = (v[t] + y) % p, (v[t] - y) % p


def _inverse_unit(v, tz, p):
    """inverse_unit (Gentleman-Sande) on a list of 2^s exact words."""
    size = len(v)
    for r in range(size.bit_length() - 1):
        half = 1 << r
        for t in range(size):
            if t & half:
                continue
            z = tz[size - (size >> r) + (t >> (r + 1))]
            x, y = v[t], v[t + half]
            v[t], v[t + half] = (x + y) % p, (x - y) * z % p


def _pass(smem, logn, s0, s, table, off, p, inverse, narrow=False):
    """ntt_pass (s0, s) over a row of 2^logn words held at their slots."""
    ls = logn - s0 - s
    for q in range(1 << (logn - s)):
        _, at = _unit(q, ls, s, narrow)
        v = [smem[i] for i in at]
        t = table[off + (q >> ls) * ((1 << s) - 1):]
        (_inverse_unit if inverse else _forward_unit)(v, t, p)
        for i, val in zip(at, v):
            smem[i] = val
    return off + (((1 << s) - 1) << s0)


def _forward_row(x, table, p, narrow=False):
    """forward_row: the passes of kernels.ntt_passes(logn) in order (narrow:
    NARROW_PASS_STAGES a pass on 4-byte slots)."""
    logn = len(x).bit_length() - 1
    slot = _slot32 if narrow else _slot
    per = kernels.NARROW_PASS_STAGES if narrow else kernels.PASS_STAGES
    smem = [0] * len(x)
    for i, v in enumerate(x):
        smem[slot(i)] = int(v)
    off = 0
    for s0, s in kernels.ntt_passes(logn, 0, per):
        off = _pass(smem, logn, s0, s, table, off, p, False, narrow)
    return [smem[slot(i)] for i in range(len(x))]


def _inverse_row(x, table, p, ninv, narrow=False):
    """inverse_row: the same passes in reverse, Gentleman-Sande, then the
    n^{-1} fold."""
    logn = len(x).bit_length() - 1
    slot = _slot32 if narrow else _slot
    per = kernels.NARROW_PASS_STAGES if narrow else kernels.PASS_STAGES
    smem = [0] * len(x)
    for i, v in enumerate(x):
        smem[slot(i)] = int(v)
    off = 0
    for s0, s in reversed(kernels.ntt_passes(logn, 0, per)):
        off = _pass(smem, logn, s0, s, table, off, p, True, narrow)
    return [smem[slot(i)] * ninv % p for i in range(len(x))]


def _split_forward(x, table, p):
    """split_forward_row for both ranks: each reads the whole row, applies
    stages 0 and 1 to its half's words i and i + n/4, then its own passes
    kernels.ntt_passes(logn - 2, 1) over the half with its part of the
    table. Returns the row the two halves write."""
    n = len(x)
    logn, quarter = n.bit_length() - 1, n // 4
    x = [int(v) for v in x]
    out = []
    for rank in (0, 1):
        rt = table[1 + rank * (n // 2 - 1):]
        smem = [0] * (n // 2)
        for i in range(quarter):
            y0, y1 = x[i + 2 * quarter] * table[0], x[i + 3 * quarter] * table[0]
            b0 = (x[i] - y0) if rank else (x[i] + y0)
            b1 = (x[i + quarter] - y1) if rank else (x[i + quarter] + y1)
            t = b1 * rt[0]
            smem[_slot(i)], smem[_slot(i + quarter)] = (b0 + t) % p, (b0 - t) % p
        off = 1
        for s0, s in kernels.ntt_passes(logn - 2, 1):
            off = _pass(smem, logn - 1, s0, s, rt, off, p, False)
        assert off == n // 2 - 1
        out += [smem[_slot(i)] for i in range(n // 2)]
    return out


def _split_inverse(x, table, p, ninv):
    """split_inverse_row for both ranks: each runs the reverse of its
    half's forward passes, then (after cluster.sync) reads both halves'
    words i and i + n/4, applies stage logn - 2 in each half and stage
    logn - 1 across them, keeps its side and folds n^{-1}."""
    n = len(x)
    logn, quarter = n.bit_length() - 1, n // 4
    halves = []
    for rank in (0, 1):
        rt = table[3 + rank * (n // 2 - 2):]
        smem = [0] * (n // 2)
        for i in range(n // 2):
            smem[_slot(i)] = int(x[rank * n // 2 + i])
        off = 0
        for s0, s in reversed(kernels.ntt_passes(logn - 2, 1)):
            off = _pass(smem, logn - 1, s0, s, rt, off, p, True)
        assert off == n // 2 - 2
        halves.append(smem)
    out = []
    for rank in (0, 1):
        mine = [0] * (n // 2)
        for i in range(quarter):
            lo, hi = _slot(i), _slot(i + quarter)
            v = [halves[0][lo], halves[0][hi], halves[1][lo], halves[1][hi]]
            v[0], v[1] = (v[0] + v[1]) % p, (v[0] - v[1]) * table[0] % p
            v[2], v[3] = (v[2] + v[3]) % p, (v[2] - v[3]) * table[1] % p
            if rank:
                o0, o1 = (v[0] - v[2]) * table[2], (v[1] - v[3]) * table[2]
            else:
                o0, o1 = v[0] + v[2], v[1] + v[3]
            mine[i], mine[i + quarter] = o0 * ninv % p, o1 * ninv % p
        out += mine
    return out


def _ring(n, seed, narrow=False):
    """A one-limb context of degree n (narrow: a 30-bit modulus, int32
    words) and a canonical row with a p - 1."""
    (p,) = T.BfvParametersBuilder.generate_moduli([30 if narrow else 62], n)
    tctx = TContext([p], n, "cpu", narrow=narrow)
    x = np.random.default_rng(seed).integers(0, p, n, dtype=np.uint64)
    x[0] = p - 1
    return p, tctx.tables, x.astype(np.int32 if narrow else np.int64)


def _plain(x, tables, inverse):
    row = torch.from_numpy(x)[None]
    if tables.narrow:
        if inverse:
            return backward32_plain(row, tables.zetas_inv, tables.ninv,
                                    tables.p)[0].numpy()
        return forward32_plain(row, tables.omegas, tables.p)[0].numpy()
    if inverse:
        return backward_plain(row, tables.zetas_inv, tables.ninv,
                              tables.mod)[0].numpy()
    return forward_plain(row, tables.omegas, tables.mod)[0].numpy()


def _table(tables, inverse, split):
    """The twiddles of one limb in pass order, from the limb's table."""
    per = kernels.NARROW_PASS_STAGES if tables.narrow else kernels.PASS_STAGES
    order = (kernels.inverse_twiddle_order if inverse
             else kernels.forward_twiddle_order)(tables.omegas.shape[-1],
                                                 split, per)
    base = tables.zetas_inv if inverse else tables.omegas
    return [int(v) for v in base[0, order]]


def _check_pass_table(tables, inverse):
    """NttTables.pass_twiddles of whole rows: (1, n, 2) pairs of the
    table's word type, the twiddles and their Shoup constants in the order
    of kernels.forward_twiddle_order / inverse_twiddle_order (narrow: of
    NARROW_PASS_STAGES a pass)."""
    n = tables.omegas.shape[-1]
    per = kernels.NARROW_PASS_STAGES if tables.narrow else kernels.PASS_STAGES
    tw = tables.pass_twiddles(inverse, split=False)
    assert tw.shape == (1, n, 2) and tw.dtype == tables.dtype
    order = (kernels.inverse_twiddle_order if inverse
             else kernels.forward_twiddle_order)(n, False, per)
    base, shoup = ((tables.zetas_inv, tables.zetas_inv_shoup) if inverse
                   else (tables.omegas, tables.omegas_shoup))
    assert torch.equal(tw[0, :, 0], base[0, order])
    assert torch.equal(tw[0, :, 1], shoup[0, order])


# (n, narrow): the wide rows of K1, K3 and K8, and K9's narrow ones (three
# stages a pass: one pass at n = 8, a lead pass of one stage at 16 and 8192,
# of two at 32, none at 512)
NARROW_ROWS = [(8, True), (16, True), (32, True), (512, True), (8192, True)]


@pytest.mark.parametrize(
    "n,narrow", [(n, False) for n in (16, 32, 256, 1024, 4096, 8192, 16384)]
    + NARROW_ROWS)
def test_inverse_pass_schedule_matches_backward_plain(n, narrow):
    """The inverse schedule (the forward's passes in reverse, Gentleman-
    Sande, on swizzled words, twiddles from NttTables.pass_twiddles of the
    whole row) gives backward_plain word for word, at log2(n) odd and even,
    the fixed instances' 4096 and 8192 among them; at 16384 the whole-row
    schedule (K8's), beside the split one K1 runs there. Narrow: K9's three
    stages a pass on 4-byte slots against backward32_plain."""
    p, tables, x = _ring(n, n, narrow)
    _check_pass_table(tables, True)
    got = _inverse_row(x, _table(tables, True, False), p,
                       int(tables.ninv[0]), narrow)
    np.testing.assert_array_equal(np.array(got, dtype=x.dtype),
                                  _plain(x, tables, True))


@pytest.mark.parametrize("n,narrow", [(16, False), (1024, False),
                                      (16384, False)] + NARROW_ROWS)
def test_forward_row_schedule_matches_forward_plain(n, narrow):
    """forward_row's schedule (the tails' forward passes) with the
    whole-row table, including at 16384, where K1 splits the row; narrow,
    K9's forward against forward32_plain."""
    p, tables, x = _ring(n, n + 1, narrow)
    _check_pass_table(tables, False)
    got = _forward_row(x, _table(tables, False, False), p, narrow)
    np.testing.assert_array_equal(np.array(got, dtype=x.dtype),
                                  _plain(x, tables, False))


@pytest.mark.parametrize("n", [16, 64, 1024, 16384])
@pytest.mark.parametrize("inverse", [False, True])
def test_split_schedule_matches_plain(n, inverse):
    """The row split across two CTAs, emulated per rank with the split
    tables (NttTables.pass_twiddles at 16384): the forward's stages 0 and 1
    at load, then each half's passes; the inverse's half passes, then its
    last two stages across the halves. Word for word forward_plain and
    backward_plain, at log2(n) even and odd (64: the halves' pass count
    odd)."""
    p, tables, x = _ring(n, 2 * n + inverse)
    table = _table(tables, inverse, True)
    if kernels.ntt_split(n):
        tw = tables.pass_twiddles(inverse)
        assert [int(v) for v in tw[0, :, 0]] == table
    if inverse:
        got = _split_inverse(x, table, p, int(tables.ninv[0]))
    else:
        got = _split_forward(x, table, p)
    np.testing.assert_array_equal(np.array(got, dtype=np.int64),
                                  _plain(x, tables, inverse))


@pytest.mark.parametrize("split,per", [(False, 2), (True, 2), (False, 3)])
def test_inverse_table_is_pass_ordered(split, per):
    """kernels.inverse_twiddle_order lists every bit-reversed zeta_inv index
    0 .. n - 2 once, then the pad n - 1 (a permutation of the table), each
    pass's twiddles in one block of its own stages' indices, in the
    reverse of the forward schedule, at every degree 8 (16 split) .. 16384;
    split, the three crossing twiddles first and each half's in its own
    block; per = 3, K9's passes of three stages."""
    for logn in range(4 if split else 3, 15):
        n = 1 << logn
        order = kernels.inverse_twiddle_order(n, split, per)
        assert len(order) == n and order[-1] == n - 1
        assert sorted(order) == list(range(n))

        def stage(i):  # the inverse stage whose twiddles hold index i
            return next(s for s in range(logn) if i < n - (n >> (s + 1)))

        if not split:
            off = 0
            for s0, s in reversed(kernels.ntt_passes(logn, 0, per)):
                size = ((1 << s) - 1) << s0
                ls = logn - s0 - s
                assert {stage(i) for i in order[off:off + size]} == set(
                    range(ls, ls + s))
                off += size
            assert off == n - 1
            continue
        assert [stage(i) for i in order[:3]] == [logn - 2] * 2 + [logn - 1]
        half = n // 2 - 2
        for rank in (0, 1):
            block = order[3 + rank * half:3 + (rank + 1) * half]
            assert {stage(i) for i in block} == set(range(logn - 2))
            # half `rank` holds the upper half of each stage's groups
            assert all((i - (n - 2 * (n >> (stage(i) + 1))))
                       // (n >> (stage(i) + 2)) == rank for i in block)


def test_forward_split_table_is_pass_ordered():
    """The split forward table: omega 1, then per half its stage-1 omega
    2 + r and its own stages' omegas, each from that half's groups; a
    permutation of 0 .. n - 1 with the pad 0 last, at 16 .. 16384."""
    for logn in range(4, 15):
        n = 1 << logn
        order = kernels.forward_twiddle_order(n, True)
        assert len(order) == n and order[0] == 1 and order[-1] == 0
        assert sorted(order) == list(range(n))
        half = n // 2 - 1
        for rank in (0, 1):
            block = order[1 + rank * half:1 + (rank + 1) * half]
            assert block[0] == 2 + rank
            # index i of stage s >= 1 (2^s <= i < 2^(s+1)) is group i - 2^s
            assert all((i - (1 << (i.bit_length() - 1)))
                       >> (i.bit_length() - 2) == rank for i in block)


def test_narrow_forward_table_is_pass_ordered():
    """K9's forward table (three stages a pass): omega indices 1 .. n - 1
    once, then the pad 0, each pass's in one block of its own stages'
    indices (stage s holds 2^s .. 2^(s+1) - 1), in the order of
    kernels.ntt_passes(logn, 0, 3), at 8 .. 16384."""
    per = kernels.NARROW_PASS_STAGES
    for logn in range(3, 15):
        n = 1 << logn
        order = kernels.forward_twiddle_order(n, False, per)
        assert len(order) == n and order[-1] == 0
        assert sorted(order) == list(range(n))
        off = 0
        for s0, s in kernels.ntt_passes(logn, 0, per):
            size = ((1 << s) - 1) << s0
            assert {i.bit_length() - 1 for i in order[off:off + size]} == set(
                range(s0, s0 + s))
            off += size
        assert off == n - 1


@pytest.mark.parametrize("per", [2, 3])
def test_narrow_slots_free_of_bank_conflicts(per):
    """pass_slot32: every pass of `per` stages a pass (K9 runs three; the
    map serves two as well) puts a warp's 32 accesses to word t of its 32
    units in 32 distinct 4-byte banks (slot mod 32) at n = 512 .. 32768,
    the slots a permutation of each row, and the map linear, so that a
    word's slot is the unit's XOR its offset's."""
    for logn in range(9, 16):
        size = 1 << logn
        assert sorted(_slot32(i) for i in range(size)) == list(range(size))
        for s0, s in kernels.ntt_passes(logn, 0, per):
            ls = logn - s0 - s
            for q0 in range(0, size >> s, 32):
                units = [_unit(q, ls, s, True) for q in range(q0, q0 + 32)]
                for words, slots in units:
                    assert slots == [_slot32(w) for w in words]
                for t in range(1 << s):
                    assert len({u[1][t] % 32 for u in units}) == 32


def test_inverse_slots_free_of_bank_conflicts():
    """Each inverse pass's half-warp of sixteen 8-byte words lands in
    sixteen distinct bank pairs (slot mod 16) at n = 4096 and 8192 (whole
    rows) and 16384 (each 8192-word half of the split, and its crossing
    stages' reads of words i and i + n/4), with the slots ntt_pass
    computes; every row's slots are a permutation."""
    for n in (4096, 8192, 16384):
        logn = n.bit_length() - 1
        if kernels.ntt_split(n):
            logn -= 1
            passes = reversed(kernels.ntt_passes(logn - 1, 1))
            quarter = n // 4
            for i0 in range(0, quarter, 16):
                for shift in (0, quarter):
                    assert len({_slot(i + shift) % 16
                                for i in range(i0, i0 + 16)}) == 16
        else:
            passes = reversed(kernels.ntt_passes(logn))
        size = 1 << logn
        assert sorted(_slot(i) for i in range(size)) == list(range(size))
        for s0, s in passes:
            ls = logn - s0 - s
            for q0 in range(0, size >> s, 16):
                units = [_unit(q, ls, s)[1] for q in range(q0, q0 + 16)]
                for t in range(1 << s):
                    assert len({u[t] % 16 for u in units}) == 16


def test_launch_plans_within_card_limits():
    """K1's plan (kernels.ntt_plan) at every degree 8 .. 16384 and K3's
    (kernels.tensor_intt_plan) up to 8192: at most 512 threads, enough for
    every pass (a thread a unit at most n / 4 units), one row (K1 at 16384:
    half a row) of at most 64 KB a CTA, so three CTAs share an SM, and
    three 512-thread CTAs leave at least 40 registers a thread; K1 splits
    only the 16384 row, into a cluster of two; K3 clusters three CTAs.
    K9's (kernels.ntt32_plan) at 8 .. 32768: one CTA a row of at most
    256 threads (at most n / 8, a thread a three-stage unit), the row's
    4 n bytes within one CTA's shared memory, and at n = 8192 six 32 KB
    CTAs an SM (each with its 1 KB of reserved shared memory) at 40
    registers a thread. K8's (kernels.intt_scale_plan) at every (k_in, n)
    that intt_scale_fits admits up to k_in = 64: at most 8 CTAs a cluster
    (portable), at most 256 threads, every limb in one CTA of the cluster,
    each CTA's limbs within its shared memory; at (3, 8192), split, a pair
    of 96 KB CTAs of 512 threads, half of every limb each, two an SM at up
    to 64 registers a thread."""
    for logn in range(3, 15):
        n = 1 << logn
        for cluster, threads, smem in [kernels.ntt_plan(n)] + (
                [kernels.tensor_intt_plan(n)] if n <= 8192 else []):
            assert 1 <= threads <= 512 and threads <= max(1, n // 4)
            assert smem <= 64 * 1024 and 3 * smem <= SM_SMEM
            assert 65536 // (3 * 512) >= 40
            assert cluster <= 8
        assert kernels.ntt_plan(n)[0] == (2 if n == 16384 else 1)
        if n <= 8192:
            assert kernels.tensor_intt_plan(n)[0] == 3
    with pytest.raises(ValueError):
        kernels.ntt_plan(32768)
    for logn in range(3, 16):
        n = 1 << logn
        cluster, threads, smem = kernels.ntt32_plan(n)
        assert cluster == 1 and smem == 4 * n <= kernels.SMEM_BYTES
        assert 1 <= threads <= min(256, max(1, n // 8))
    _, threads, smem = kernels.ntt32_plan(8192)
    assert 6 * (smem + 1024) <= SM_SMEM and 6 * threads <= 2048
    assert 65536 // (6 * threads) >= 40
    for logn in range(3, 15):
        n = 1 << logn
        for k_in in range(1, 65):
            if not intt_scale_fits(k_in, n):
                continue
            cluster, threads, smem = kernels.intt_scale_plan(k_in, n)
            if kernels.intt_scale_split(k_in, n):
                assert (cluster, smem) == (2, 4 * n * k_in)
                continue
            limbs = -(-k_in // cluster)
            assert 1 <= cluster <= 8 and cluster * limbs >= k_in
            assert 1 <= threads <= min(256, max(1, n // 4))
            assert smem == 8 * n * limbs <= kernels.SMEM_BYTES
    assert kernels.intt_scale_split(3, 8192)
    cluster, threads, smem = kernels.intt_scale_plan(3, 8192)
    assert (cluster, threads, smem) == (2, 512, 98304)
    assert 2 * (smem + 1024) <= SM_SMEM and 65536 // (2 * threads) >= 64


@pytest.mark.parametrize("source,define,const", [
    ("ntt_pass_device.cuh", "PASS_STAGES", "PASS_STAGES"),
    ("ntt.cu", "NTT_THREADS", "NTT_THREADS"),
    ("ntt.cu", "NTT_ROW_MAX", "NTT_ROW_MAX"),
    ("tensor_intt.cu", "K3_PARTS", "K3_PARTS"),
    ("ntt32.cu", "NTT32_STAGES", "NARROW_PASS_STAGES"),
    ("ntt32.cu", "NTT32_THREADS", "NTT32_THREADS"),
    ("intt_scale.cu", "K8_THREADS", "K8_THREADS"),
    ("intt_scale.cu", "K8_SPLIT_THREADS", "K8_SPLIT_THREADS"),
    ("intt_scale.cu", "K8_CLUSTER_MAX", "K8_CLUSTER_MAX"),
])
def test_plan_constants_match_sources(source, define, const):
    """The constants the Python plans and pass-ordered tables are built from
    equal the kernels' own: a table in another pass order than the kernel's
    stages a pass would give wrong words with no error."""
    with open(os.path.join(kernels.CSRC, source)) as f:
        found = re.findall(rf"^#define {define} (\d+)$", f.read(),
                           flags=re.MULTILINE)
    assert found == [str(getattr(kernels, const))]


def test_tensor_intt_thirds_cover_every_coefficient():
    """The coefficients the three CTAs of a K3 cluster form products for
    cover 0 .. n - 1 once, in order, each starting at a multiple of 32, at
    every degree 8 .. 8192."""
    for logn in range(3, 14):
        n = 1 << logn
        thirds = kernels.tensor_intt_thirds(n)
        assert len(thirds) == 3
        assert [e for lo, hi in thirds for e in range(lo, hi)] == list(range(n))
        assert all(lo % 32 == 0 or lo == n for lo, _ in thirds)


@pytest.mark.parametrize("k_in", [1, 3, 5, 8, 12])
def test_intt_scale_shares_cover_every_coefficient(k_in):
    """The coefficients the CTAs of a K8 cluster scale
    (kernels.coefficient_shares over its intt_scale_plan cluster: min(k_in,
    8) CTAs, or the pair's halves where it splits 3 limbs of 8192) cover
    0 .. n - 1 once, in order, each starting at a multiple of 32, at every
    degree 8 .. 8192; K3's thirds are the same shares over three CTAs."""
    for logn in range(3, 14):
        n = 1 << logn
        cluster = kernels.intt_scale_plan(k_in, n)[0]
        shares = kernels.coefficient_shares(n, cluster)
        split = kernels.intt_scale_split(k_in, n)
        assert len(shares) == cluster == (2 if split else min(k_in, 8))
        if split:
            assert shares == [(0, n // 2), (n // 2, n)]
        assert [e for lo, hi in shares for e in range(lo, hi)] == list(range(n))
        assert all(lo % 32 == 0 or lo == n for lo, _ in shares)
        assert kernels.tensor_intt_thirds(n) == kernels.coefficient_shares(n, 3)


@pytest.mark.parametrize("n", [16, 512])
def test_tensor_intt_cluster_matches_plain(n):
    """K3's cluster emulated over two limbs: CTA r forms the three products
    of its third of the coefficients into the three parts' rows at their
    slots, then each part's row runs the inverse passes with the limb's
    pass-ordered table. Word for word tensor_intt_plain."""
    moduli = T.BfvParametersBuilder.generate_moduli([62, 62], n)
    ctx = TContext(moduli, n, "cpu")
    rng = np.random.default_rng(n)
    ext = np.stack([rng.integers(0, p, (4, 2, n), dtype=np.uint64)
                    for p in moduli], axis=-2).astype(np.int64)
    want = tpl.tensor_intt_plain(ctx, torch.from_numpy(ext)).numpy()
    tz = ctx.tables.pass_twiddles(True)
    for b in range(2):
        for j, p in enumerate(moduli):
            rows = [[0] * n for _ in range(3)]
            for lo, hi in kernels.tensor_intt_thirds(n):
                for e in range(lo, hi):
                    a0, a1, b0, b1 = (int(ext[o, b, j, e]) for o in range(4))
                    for part, v in enumerate((a0 * b0, a0 * b1 + a1 * b0,
                                              a1 * b1)):
                        rows[part][_slot(e)] = v % p
            table = [int(v) for v in tz[j, :, 0]]
            for part in range(3):
                x = [rows[part][_slot(e)] for e in range(n)]
                got = _inverse_row(x, table, p, int(ctx.tables.ninv[j]))
                np.testing.assert_array_equal(
                    np.array(got, dtype=np.int64), want[part, b, j])
