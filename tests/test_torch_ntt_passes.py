"""The host-side model of the Hopper transform passes
(tpufhe_torch/csrc/ntt_pass_device.cuh) behind K1 (ntt.cu) and K3
(tensor_intt.cu): the inverse pass schedule and its pass-ordered table, the
N = 16384 row split across a two-CTA cluster, the shared-memory slots, the
launch plans and K3's coefficient thirds. Each schedule runs on exact
Python integers, on words kept at their swizzled slots, and is held word
for word against the port's plain transforms (ops/ntt.py forward_plain /
backward_plain, themselves held against tpufhe), and K3's cluster against
tensor_intt_plain."""

import numpy as np
import pytest
import torch

import tpufhe_torch.bfv as T
from tpufhe_torch import kernels
from tpufhe_torch import pipeline as tpl
from tpufhe_torch.ops.ntt import backward_plain, forward_plain
from tpufhe_torch.ops.rq import Context as TContext

# 228 KB of shared memory an SM, 65,536 registers, at most 1,024 threads a
# CTA and 8 CTAs a portable cluster (sm_90)
SM_SMEM = 228 * 1024


def _slot(i):
    """ntt_pass_device.cuh pass_slot."""
    return i ^ (((i >> 4) & 3) * 5)


def _unit(q, ls, s):
    """The words of unit q of a pass with stride 2^ls and s stages, and
    their slots as ntt_pass computes them: one pass_slot call and an XOR
    where bits ls .. ls + s - 1 miss bits 4, 5, else one call a word."""
    first = ((q >> ls) << (ls + s)) | (q & ((1 << ls) - 1))
    words = [first | (t << ls) for t in range(1 << s)]
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


def _pass(smem, logn, s0, s, table, off, p, inverse):
    """ntt_pass (s0, s) over a row of 2^logn words held at their slots."""
    ls = logn - s0 - s
    for q in range(1 << (logn - s)):
        _, at = _unit(q, ls, s)
        v = [smem[i] for i in at]
        t = table[off + (q >> ls) * ((1 << s) - 1):]
        (_inverse_unit if inverse else _forward_unit)(v, t, p)
        for i, val in zip(at, v):
            smem[i] = val
    return off + (((1 << s) - 1) << s0)


def _forward_row(x, table, p):
    """forward_row: the passes of kernels.ntt_passes(logn) in order."""
    logn = len(x).bit_length() - 1
    smem = [0] * len(x)
    for i, v in enumerate(x):
        smem[_slot(i)] = int(v)
    off = 0
    for s0, s in kernels.ntt_passes(logn):
        off = _pass(smem, logn, s0, s, table, off, p, False)
    return [smem[_slot(i)] for i in range(len(x))]


def _inverse_row(x, table, p, ninv):
    """inverse_row: the same passes in reverse, Gentleman-Sande, then the
    n^{-1} fold."""
    logn = len(x).bit_length() - 1
    smem = [0] * len(x)
    for i, v in enumerate(x):
        smem[_slot(i)] = int(v)
    off = 0
    for s0, s in reversed(kernels.ntt_passes(logn)):
        off = _pass(smem, logn, s0, s, table, off, p, True)
    return [smem[_slot(i)] * ninv % p for i in range(len(x))]


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


def _ring(n, seed):
    """A one-limb context of degree n and a canonical row with a p - 1."""
    (p,) = T.BfvParametersBuilder.generate_moduli([62], n)
    tctx = TContext([p], n, "cpu")
    x = np.random.default_rng(seed).integers(0, p, n, dtype=np.uint64)
    x[0] = p - 1
    return p, tctx.tables, x.astype(np.int64)


def _plain(x, tables, inverse):
    row = torch.from_numpy(x)[None]
    if inverse:
        return backward_plain(row, tables.zetas_inv, tables.ninv,
                              tables.mod)[0].numpy()
    return forward_plain(row, tables.omegas, tables.mod)[0].numpy()


def _table(tables, inverse, split):
    """The twiddles of one limb in pass order, from the limb's table."""
    order = (kernels.inverse_twiddle_order if inverse
             else kernels.forward_twiddle_order)(tables.omegas.shape[-1], split)
    base = tables.zetas_inv if inverse else tables.omegas
    return [int(v) for v in base[0, order]]


@pytest.mark.parametrize("n", [16, 32, 256, 1024, 4096, 8192, 16384])
def test_inverse_pass_schedule_matches_backward_plain(n):
    """The inverse schedule (the forward's passes in reverse, Gentleman-
    Sande, on swizzled words, twiddles from NttTables.pass_twiddles where
    the row is whole) gives backward_plain word for word, at log2(n) odd
    and even, the fixed instances' 4096 and 8192 among them; at 16384 the
    whole-row schedule, beside the split one K1 runs there."""
    p, tables, x = _ring(n, n)
    if not kernels.ntt_split(n):
        tz = tables.pass_twiddles(True)
        assert tz.shape == (1, n, 2) and tz.dtype == torch.int64
        order = kernels.inverse_twiddle_order(n)
        assert torch.equal(tz[0, :, 0], tables.zetas_inv[0, order])
        assert torch.equal(tz[0, :, 1], tables.zetas_inv_shoup[0, order])
    got = _inverse_row(x, _table(tables, True, False), p,
                       int(tables.ninv[0]))
    np.testing.assert_array_equal(np.array(got, dtype=np.int64),
                                  _plain(x, tables, True))


@pytest.mark.parametrize("n", [16, 1024, 16384])
def test_forward_row_schedule_matches_forward_plain(n):
    """forward_row's schedule (the tails' forward passes) with the
    whole-row table, including at 16384, where K1 splits the row."""
    p, tables, x = _ring(n, n + 1)
    got = _forward_row(x, _table(tables, False, False), p)
    np.testing.assert_array_equal(np.array(got, dtype=np.int64),
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


@pytest.mark.parametrize("split", [False, True])
def test_inverse_table_is_pass_ordered(split):
    """kernels.inverse_twiddle_order lists every bit-reversed zeta_inv index
    0 .. n - 2 once, then the pad n - 1 (a permutation of the table), each
    pass's twiddles in one block of its own stages' indices, in the
    reverse of the forward schedule, at every degree 8 (16 split) .. 16384;
    split, the three crossing twiddles first and each half's in its own
    block."""
    for logn in range(4 if split else 3, 15):
        n = 1 << logn
        order = kernels.inverse_twiddle_order(n, split)
        assert len(order) == n and order[-1] == n - 1
        assert sorted(order) == list(range(n))

        def stage(i):  # the inverse stage whose twiddles hold index i
            return next(s for s in range(logn) if i < n - (n >> (s + 1)))

        if not split:
            off = 0
            for s0, s in reversed(kernels.ntt_passes(logn)):
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
    only the 16384 row, into a cluster of two; K3 clusters three CTAs."""
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
