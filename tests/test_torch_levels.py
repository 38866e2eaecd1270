"""The port's levels against tpufhe, bit-exact (tolerance 0): the
switch-down (wide and narrow) against Poly.switch_down and the
exact-rounding oracle, the Switcher, Ciphertext.switch_to_level, keys
below the ciphertext's level (relinearization, Galois, evaluation), the
leveled make_expand, PublicKey encryption below the key's level,
Multiplicator with mod switching, and MulPIR's response on an expanded
query at level 1 (make_pir_response_db, the leveled form of
tests/test_pipeline.py's test_leveled_expand_and_pir_response_db), all on
keys and ciphertexts both packages make from one ChaCha8 seed, and
tpufhe's leveled keys carried across by convert. Degree 16, 3 x 62-bit
moduli (so levels 0, 1 and 2), where tpufhe's programs run eagerly as its
own tests run them.
"""

import jax
import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe.errors import InvalidLevel as JInvalidLevel
from tpufhe.ops.rq import POWER_BASIS, Poly
from tpufhe.ops.rq import Context as JContext
from tpufhe.ops.rq import Switcher as JSwitcher
from tpufhe.pipeline import make_expand as j_make_expand
from tpufhe.pipeline import make_pir_response_db as j_make_pir_response_db
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed

import tpufhe_torch.bfv as T
from tpufhe_torch import convert
from tpufhe_torch.errors import (
    InvalidLevel,
    NoMoreContext,
    UnsupportedOperation,
)
from tpufhe_torch.ops.rq import (
    Context,
    Switcher,
    ntt_backward,
    switch_down,
    switch_down_to,
)
from tpufhe_torch.pipeline import (
    encode_pir_database,
    make_expand,
    make_pir_response_db,
)
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

N = 16
DIM1, DIM2 = 4, 2
LEVELS = (DIM1 + DIM2 - 1).bit_length()


def _words(x):
    return convert.lanes_to_words(np.asarray(getattr(x, "coeffs", x)))


def _same(jct, tct):
    assert len(jct) == len(tct) and jct.level == tct.level
    for i in range(len(jct)):
        np.testing.assert_array_equal(_words(jct[i]), tct[i].numpy())


def _same_ksk(jk, tk):
    assert jk.seed == tk.seed and jk.log_base == tk.log_base
    assert (jk.ciphertext_level, jk.ksk_level) == (tk.ciphertext_level,
                                                   tk.ksk_level)
    for name in ("c0", "c1"):
        rows = getattr(jk, name)
        assert getattr(tk, name).shape[0] == len(rows)
        for i, poly in enumerate(rows):
            np.testing.assert_array_equal(_words(poly),
                                          getattr(tk, name)[i].numpy())
            np.testing.assert_array_equal(
                _words(poly.coeffs_shoup),
                getattr(tk, name + "_shoup")[i].numpy())


def _tables(ksk):
    """tpufhe's ksk rows as convert.key_switching_key takes them."""
    return [[np.asarray(getattr(p, a)) for p in getattr(ksk, c)]
            for c in ("c0", "c1") for a in ("coeffs", "coeffs_shoup")]


def _rows(moduli, seed, lead=()):
    """Canonical residues (*lead, k, N), each row's first word p - 1."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, p, lead + (N,), dtype=np.uint64)
                  for p in moduli], axis=-2)
    x[..., 0] = np.array(moduli, np.uint64) - 1
    return x


# ---------------------------------------------------------------------------
# switch-down and Switcher
# ---------------------------------------------------------------------------


# moduli sizes: 62-bit, MulPIR's (50, 55, 55) and narrow 30-bit
SIZES = [[62] * 3, [50, 55, 55], [30] * 3]


@pytest.mark.parametrize("sizes", SIZES, ids=["62", "mulpir", "narrow"])
def test_switch_down_matches_tpufhe_and_rounds_exactly(sizes):
    moduli = J.BfvParametersBuilder.generate_moduli(sizes, N)
    narrow = max(sizes) <= 30
    jctx, tctx = JContext(moduli, N, narrow), Context(moduli, N, "cpu", narrow)
    x = _rows(moduli, len(moduli) + sizes[0], (2,))
    got = switch_down(tctx, torch.from_numpy(x.astype(np.int64)).to(tctx.dtype))
    assert got.dtype == tctx.dtype and got.shape == (2, 2, N)
    assert tctx.next_context.moduli == tuple(moduli[:2])
    for b in range(2):
        jp = Poly.from_u64_matrix(x[b], jctx, POWER_BASIS)
        down = jp.switch_down()
        np.testing.assert_array_equal(_words(down), got[b].numpy())
        # the exact-rounding oracle of tests/test_rq.py
        q_last, q_new = moduli[-1], down.ctx.modulus()
        lift = tctx.next_context.rns.lift
        for X, j in zip(jp.lift_bigints(), range(N)):
            y = lift([int(v) for v in got[b, :, j]])
            assert y == ((X + q_last // 2) // q_last) % q_new
    two = switch_down_to(tctx, tctx.next_context.next_context,
                         torch.from_numpy(x.astype(np.int64)).to(tctx.dtype))
    want = Poly.from_u64_matrix(x[1], jctx, POWER_BASIS).switch_down_to(
        jctx.context_at_level(2))
    np.testing.assert_array_equal(_words(want), two[1].numpy())
    with pytest.raises(NoMoreContext):
        switch_down(tctx.next_context.next_context, two)


@pytest.mark.parametrize("ntt", [False, True])
def test_switcher_matches_tpufhe(ntt):
    """Up (factor q_0 q_1 q_2 / q_0 q_1 > 1, the key generation's use),
    down (a factor below 1, rounded) and across one context (a copy)."""
    moduli = J.BfvParametersBuilder.generate_moduli([62] * 3, N)
    big, small = moduli, moduli[:2]
    for a, b in ((small, big), (big, small), (big, big)):
        jf, jt = JContext(a, N), JContext(b, N)
        tf, tt = Context(a, N, "cpu"), Context(b, N, "cpu")
        x = _rows(a, len(a) + len(b))
        jp = Poly.from_u64_matrix(x, jf, POWER_BASIS)
        if ntt:
            jp = jp.into_ntt()
        want = JSwitcher(jf, jt).switch(jp)
        got = Switcher(tf, tt).switch(torch.from_numpy(_words(jp)), ntt=ntt)
        np.testing.assert_array_equal(_words(want), got.numpy())


# ---------------------------------------------------------------------------
# Both packages from one seed
# ---------------------------------------------------------------------------


class Pair:
    """Parameters, secret keys and rngs of both packages from one seed."""

    def __init__(self, seed, sizes=(62, 62, 62), t=1153):
        def build(builder):
            return (builder().set_degree(N).set_plaintext_modulus(t)
                    .set_moduli_sizes(list(sizes)))

        self.t = t
        self.jp = build(J.BfvParametersBuilder).build()
        self.tp = build(T.BfvParametersBuilder).set_device("cpu").build()
        self.jr, self.tr = JRng(j_seed(seed)), ChaCha8Rng(seed_from_u64(seed))
        self.jsk = J.SecretKey.random(self.jp, self.jr)
        self.tsk = T.SecretKey.random(self.tp, self.tr)
        self.vals = np.random.default_rng(seed)

    def encrypt(self, v, enc="simd", level=0):
        jpt = J.Plaintext.try_encode(v, getattr(J.Encoding, enc)(level),
                                     self.jp)
        tpt = T.Plaintext.try_encode(v, getattr(T.Encoding, enc)(level),
                                     self.tp)
        return (self.jsk.try_encrypt(jpt, self.jr),
                self.tsk.try_encrypt(tpt, self.tr))

    def random(self):
        return self.vals.integers(0, self.t, N, dtype=np.uint64)

    def slots(self, tct, enc="simd"):
        return self.tsk.try_decrypt(tct).try_decode(
            getattr(T.Encoding, enc)(tct.level))


@pytest.fixture(scope="module")
def pair():
    return Pair(71)


@pytest.fixture(scope="module")
def narrow_pair():
    return Pair(72, sizes=(30, 30, 30), t=257)


@pytest.mark.parametrize("mode", ["wide", "narrow"])
def test_switch_to_level_matches_tpufhe_and_decrypts(pair, narrow_pair, mode):
    p = pair if mode == "wide" else narrow_pair
    assert p.tp.context_at_level(0).narrow == (mode == "narrow")
    v = p.random()
    jc, tc = p.encrypt(v)
    assert tc.max_switchable_level() == 2
    for level in (1, 2):
        jc.switch_to_level(level)
        tc.switch_to_level(level)
        _same(jc, tc)
        assert tc.seed is None
        np.testing.assert_array_equal(p.slots(tc), v)
    tc.switch_down()  # a no-op at the last level, as in tpufhe
    assert tc.level == 2
    for bad in (1, 3):
        with pytest.raises(JInvalidLevel):
            jc.switch_to_level(bad)
        with pytest.raises(InvalidLevel):
            tc.switch_to_level(bad)


def test_leveled_relinearization_key_matches_tpufhe(pair):
    """A key for level-1 ciphertexts held at level 0: its tables, the key
    switch (in the key's context) and relinearizes (switched back down)."""
    p = pair
    jrk = J.RelinearizationKey.new(p.jsk, JRng(j_seed(5)), 1, 0)
    trk = T.RelinearizationKey.new(p.tsk, ChaCha8Rng(seed_from_u64(5)), 1, 0)
    _same_ksk(jrk.ksk, trk.ksk)
    assert trk.ksk.c0.shape == (2, 3, N)
    va, vb = p.random(), p.random()
    (ja, ta), (jb, tb) = p.encrypt(va, level=1), p.encrypt(vb, level=1)
    jc, tc = J.ct_mul(ja, jb), T.ct_mul(ta, tb)
    _same(jc, tc)
    ctx1 = p.tp.context_at_level(1)
    j2, t2 = jc[2].into_power_basis(), ntt_backward(ctx1, tc[2])
    for x, y in zip(jrk.relinearizes_poly(j2), trk.relinearizes_poly(t2)):
        assert y.shape == (3, N)
        np.testing.assert_array_equal(_words(x), y.numpy())
    jrk.relinearizes(jc)
    trk.relinearizes(tc)
    _same(jc, tc)
    want = (va.astype(object) * vb % p.t).astype(np.uint64)
    np.testing.assert_array_equal(p.slots(tc), want)
    # tpufhe's leveled key carried across relinearizes to the same words
    carried = convert.relinearization_key(p.tp, jrk.ksk.seed,
                                          *_tables(jrk.ksk), level=1,
                                          key_level=0)
    again = T.ct_mul(ta, tb)
    carried.relinearizes(again)
    assert all(torch.equal(x, y) for x, y in zip(again.c, tc.c))


def test_leveled_galois_key_matches_tpufhe(pair):
    p = pair
    for exponent, (ct_level, key_level) in ((3, (1, 0)), (2 * N - 1, (2, 0)),
                                            (3, (2, 1))):
        jg = J.GaloisKey.new(p.jsk, exponent, ct_level, key_level,
                             JRng(j_seed(exponent)))
        tg = T.GaloisKey.new(p.tsk, exponent, ct_level, key_level,
                             ChaCha8Rng(seed_from_u64(exponent)))
        _same_ksk(jg.ksk, tg.ksk)
        jc, tc = p.encrypt(p.random(), level=ct_level)
        _same(jg.relinearize(jc), tg.relinearize(tc))


def test_key_levels_refused(pair, narrow_pair):
    """An evaluation key above the ciphertexts' level is refused as by
    tpufhe; keys below it stay unported for narrow (w30) parameters."""
    p = pair
    with pytest.raises(JInvalidLevel):
        J.EvaluationKeyBuilder(p.jsk, 0, 1)
    with pytest.raises(InvalidLevel):
        T.EvaluationKeyBuilder(p.tsk, 0, 1)
    q = narrow_pair
    with pytest.raises(UnsupportedOperation, match="narrow"):
        T.GaloisKey.new(q.tsk, 3, 1, 0, ChaCha8Rng(seed_from_u64(1)))
    with pytest.raises(UnsupportedOperation, match="narrow"):
        T.RelinearizationKey.new(q.tsk, ChaCha8Rng(seed_from_u64(1)), 1, 0)


def test_public_key_below_its_level_matches_tpufhe(pair):
    p = pair
    jpk = J.PublicKey.new(p.jsk, JRng(j_seed(3)))
    tpk = T.PublicKey.new(p.tsk, ChaCha8Rng(seed_from_u64(3)))
    v = p.random()
    for level in (1, 2, 1):
        jpt = J.Plaintext.try_encode(v, J.Encoding.simd(level), p.jp)
        tpt = T.Plaintext.try_encode(v, T.Encoding.simd(level), p.tp)
        jc = jpk.try_encrypt(jpt, JRng(j_seed(level)))
        tc = tpk.try_encrypt(tpt, ChaCha8Rng(seed_from_u64(level)))
        _same(jc, tc)
        np.testing.assert_array_equal(p.slots(tc), v)
    assert tpk.c.level == 0


def test_multiplicator_with_mod_switching_matches_tpufhe(pair):
    p = pair
    jrk = J.RelinearizationKey.new(p.jsk, JRng(j_seed(6)))
    trk = T.RelinearizationKey.new(p.tsk, ChaCha8Rng(seed_from_u64(6)))
    jm, tm = J.Multiplicator.default(jrk), T.Multiplicator.default(trk)
    jm.enable_mod_switching()
    tm.enable_mod_switching()
    va, vb = p.random(), p.random()
    (ja, ta), (jb, tb) = p.encrypt(va), p.encrypt(vb)
    jc, tc = jm.multiply(ja, jb), tm.multiply(ta, tb)
    assert tc.level == 1
    _same(jc, tc)
    want = (va.astype(object) * vb % p.t).astype(np.uint64)
    np.testing.assert_array_equal(p.slots(tc), want)


# ---------------------------------------------------------------------------
# Leveled expansion and MulPIR's response at level 1
# ---------------------------------------------------------------------------


class Leveled:
    """MulPIR's structure at degree 16 (tests/test_pipeline.py:222-285):
    the query at level 1, expansion keys at level 0, the relinearization
    key at level 1; tpufhe's expansion and response computed once."""

    def __init__(self, seed=73):
        p = self.p = Pair(seed)
        self.jrk = J.RelinearizationKey.new(p.jsk, p.jr, 1, 1)
        self.trk = T.RelinearizationKey.new(p.tsk, p.tr, 1, 1)
        self.jek = (J.EvaluationKeyBuilder(p.jsk, 1, 0)
                    .enable_expansion(LEVELS).build(p.jr))
        self.tek = (T.EvaluationKeyBuilder(p.tsk, 1, 0)
                    .enable_expansion(LEVELS).build(p.tr))
        self.db_vals = p.vals.integers(0, p.t, (DIM1, DIM2, N), dtype=np.uint64)
        self.jdb = np.stack([np.stack([
            np.asarray(J.Plaintext.try_encode(
                self.db_vals[i, j], J.Encoding.simd(1), p.jp).poly_ntt.coeffs)
            for j in range(DIM2)]) for i in range(DIM1)])
        self.tdb = encode_pir_database(p.tp, self.db_vals, T.Encoding.simd(1))
        self.cell = (3, 1)
        q = np.zeros(N, dtype=np.uint64)
        inv2l = pow(1 << LEVELS, -1, p.t)
        q[self.cell[0]] = q[DIM1 + self.cell[1]] = inv2l
        self.jq, self.tq = p.encrypt(q, "poly", 1)
        with jax.disable_jit():
            self.je = j_make_expand(p.jp, self.jek, LEVELS, level=1)(
                self.jq[0].coeffs[None], self.jq[1].coeffs[None])
            self.jout = j_make_pir_response_db(p.jp, self.jrk, DIM1, DIM2,
                                               level=1)(*self.je, self.jdb)


@pytest.fixture(scope="module")
def leveled():
    return Leveled()


def test_leveled_evaluation_key_matches_tpufhe(leveled):
    L = leveled
    assert sorted(L.tek.gk) == sorted(L.jek.gk)
    assert (L.tek.ciphertext_level, L.tek.evaluation_key_level) == (1, 0)
    assert L.tek.supports_expansion(LEVELS)
    for e, jg in L.jek.gk.items():
        _same_ksk(jg.ksk, L.tek.gk[e].ksk)
    for j, m in enumerate(L.jek.monomials):
        np.testing.assert_array_equal(_words(m), L.tek.monomials[j][0].numpy())


def test_leveled_make_expand_matches_tpufhe(leveled):
    """The leveled program (each rotation: K1 inverse, digits over the
    key's moduli, K1 forward, ks_accumulate, K1 inverse, switch-down, K1
    forward) against tpufhe's, and the port's object API expands."""
    L = leveled
    e0, e1 = make_expand(L.p.tp, L.tek, LEVELS, level=1)(
        L.tq[0][None], L.tq[1][None])
    assert e0.shape == (1 << LEVELS, 1, 2, N)
    np.testing.assert_array_equal(_words(L.je[0]), e0.numpy())
    np.testing.assert_array_equal(_words(L.je[1]), e1.numpy())
    for i, ct in enumerate(L.tek.expands(L.tq, DIM1 + DIM2)):
        assert ct.level == 1
        assert torch.equal(ct[0], e0[i, 0]) and torch.equal(ct[1], e1[i, 0])


def test_make_pir_response_db_at_level_1_matches_tpufhe(leveled):
    L = leveled
    np.testing.assert_array_equal(_words(L.jdb), L.tdb.numpy())
    e0, e1 = make_expand(L.p.tp, L.tek, LEVELS, level=1)(
        L.tq[0][None], L.tq[1][None])
    out0, out1 = make_pir_response_db(L.p.tp, L.trk, DIM1, DIM2, level=1)(
        e0, e1, L.tdb)
    np.testing.assert_array_equal(_words(L.jout[0]), out0.numpy())
    np.testing.assert_array_equal(_words(L.jout[1]), out1.numpy())
    ans = T.Ciphertext(L.p.tp, [out0[0], out1[0]], 1)
    np.testing.assert_array_equal(L.p.slots(ans), L.db_vals[L.cell])
    ans.switch_to_level(ans.max_switchable_level())
    np.testing.assert_array_equal(L.p.slots(ans), L.db_vals[L.cell])


def test_leveled_keys_carried_across_expand_to_tpufhe_words(leveled):
    L = leveled
    ek = convert.evaluation_key(
        L.p.tp, {e: (g.ksk.seed, *_tables(g.ksk)) for e, g in L.jek.gk.items()},
        level=1, key_level=0)
    assert ek.evaluation_key_level == 0
    e0, e1 = make_expand(L.p.tp, ek, LEVELS, level=1)(
        L.tq[0][None], L.tq[1][None])
    np.testing.assert_array_equal(_words(L.je[0]), e0.numpy())
    np.testing.assert_array_equal(_words(L.je[1]), e1.numpy())


def test_make_pir_response_db_refuses_narrow_parameters():
    par = (T.BfvParametersBuilder().set_degree(N).set_plaintext_modulus(257)
           .set_moduli_sizes([30] * 3).set_device("cpu").build())
    jpar = (J.BfvParametersBuilder().set_degree(N).set_plaintext_modulus(257)
            .set_moduli_sizes([30] * 3).build())
    assert par.context_at_level(0).narrow
    sk = T.SecretKey.random(par, ChaCha8Rng(seed_from_u64(1)))
    jsk = J.SecretKey.random(jpar, JRng(j_seed(1)))
    rk = T.RelinearizationKey.new(sk, ChaCha8Rng(seed_from_u64(2)))
    jrk = J.RelinearizationKey.new(jsk, JRng(j_seed(2)))
    with pytest.raises(NotImplementedError):
        j_make_pir_response_db(jpar, jrk, DIM1, DIM2)
    with pytest.raises(NotImplementedError):
        make_pir_response_db(par, rk, DIM1, DIM2)
