"""The port's Galois path against tpufhe: substitution tables, Galois and
evaluation keys from the same ChaCha8 seed, the rotation, inner-sum and
expansion programs (degree 16 against tpufhe's programs run eagerly, as
tests/test_pipeline.py runs them; degree 256 against tpufhe's object API),
decryption under both packages' secret keys, keys carried across by
convert, and the refusals. Every comparison is bit-exact (tolerance 0).
Parameters are BASELINE config 4's moduli shape: 4 x 62 bits, t = 65537.
"""

import jax
import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe.errors import InvalidContext as JInvalidContext
from tpufhe.bfv.keys.evaluation_key import EvaluationKeyBuilder as JEkb
from tpufhe.bfv.keys.galois_key import GaloisKey as JGaloisKey
from tpufhe.ops.rq import NTT, POWER_BASIS, Poly
from tpufhe.ops.rq import Context as JContext
from tpufhe.ops.rq import SubstitutionExponent as JSub
from tpufhe.pipeline import make_expand as j_make_expand
from tpufhe.pipeline import make_inner_sum as j_make_inner_sum
from tpufhe.pipeline import make_rotate as j_make_rotate
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed

import tpufhe_torch.bfv as T
from tpufhe_torch import convert
from tpufhe_torch.bfv.keys.evaluation_key import EvaluationKeyBuilder
from tpufhe_torch.bfv.keys.galois_key import GaloisKey
from tpufhe_torch.errors import (
    InvalidContext,
    InvalidGaloisElement,
    InvalidRotationStep,
    UnsupportedOperation,
)
from tpufhe_torch.ops.rq import Context, SubstitutionExponent, substitute
from tpufhe_torch.pipeline import make_expand, make_inner_sum, make_rotate
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

SIZES = [62] * 4
T_PLAIN = 65537
EXPAND_LEVEL = 2


def _words(poly):
    return convert.lanes_to_words(np.asarray(poly.coeffs))


def _shoup_words(poly):
    return convert.lanes_to_words(np.asarray(poly.coeffs_shoup))


def _exponents(n):
    return [3, 2 * n - 1, n + 1, n // 4 + 1]


# ---------------------------------------------------------------------------
# Substitution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [16, 1024, 8192])
def test_substitution_tables(n):
    moduli = J.BfvParametersBuilder.generate_moduli([62], n)
    jctx, tctx = JContext(moduli, n), Context(moduli, n, device="cpu")
    for e in _exponents(n):
        a, b = JSub(jctx, e), SubstitutionExponent(tctx, e)
        assert a.exponent == b.exponent
        np.testing.assert_array_equal(a.perm_ntt, b.perm_ntt.numpy())
        np.testing.assert_array_equal(a.perm_power, b.perm_power.numpy())
        np.testing.assert_array_equal(a.sign_power, b.sign_power.numpy())


@pytest.mark.parametrize("n", [16, 1024])
def test_substitute_matches_poly_substitute(n):
    moduli = J.BfvParametersBuilder.generate_moduli(SIZES, n)
    jctx, tctx = JContext(moduli, n), Context(moduli, n, device="cpu")
    rng = np.random.default_rng(n)
    x = np.stack([rng.integers(0, p, n, dtype=np.uint64) for p in moduli])
    x[:, 0] = np.array(moduli, dtype=np.uint64) - 1
    x = x.astype(np.int64)
    for e in _exponents(n):
        a, b = JSub(jctx, e), SubstitutionExponent(tctx, e)
        for rep, ntt in ((NTT, True), (POWER_BASIS, False)):
            want = Poly(jctx, rep, convert.words_to_lanes(x)).substitute(a)
            got = substitute(torch.from_numpy(x), b, ntt=ntt)
            np.testing.assert_array_equal(_words(want), got.numpy())


def test_even_exponent_raises():
    ctx = Context(J.BfvParametersBuilder.generate_moduli([62], 16), 16,
                  device="cpu")
    for e in (2, 32, 34):
        with pytest.raises(InvalidGaloisElement):
            SubstitutionExponent(ctx, e)


# ---------------------------------------------------------------------------
# Both packages from one seed
# ---------------------------------------------------------------------------


class Pair:
    """Secret key, evaluation key (inner sum + expansion) and ciphertexts,
    made by both packages from one seed."""

    def __init__(self, degree: int, seed: int, batch: int = 2):
        self.n = degree
        self.jp = (J.BfvParametersBuilder().set_degree(degree)
                   .set_plaintext_modulus(T_PLAIN).set_moduli_sizes(SIZES)
                   .build())
        self.tp = (T.BfvParametersBuilder().set_degree(degree)
                   .set_plaintext_modulus(T_PLAIN).set_moduli_sizes(SIZES)
                   .set_device("cpu").build())
        self.jr, self.tr = JRng(j_seed(seed)), ChaCha8Rng(seed_from_u64(seed))
        self.jsk = J.SecretKey.random(self.jp, self.jr)
        self.tsk = T.SecretKey.random(self.tp, self.tr)
        self.jek = (JEkb(self.jsk).enable_inner_sum()
                    .enable_expansion(EXPAND_LEVEL).build(self.jr))
        self.tek = (EvaluationKeyBuilder(self.tsk).enable_inner_sum()
                    .enable_expansion(EXPAND_LEVEL).build(self.tr))
        vals = np.random.default_rng(seed)
        self.simd = vals.integers(0, T_PLAIN, (batch, degree), dtype=np.uint64)
        self.poly = np.zeros((batch, degree), dtype=np.uint64)
        self.poly[:, : 1 << EXPAND_LEVEL] = vals.integers(
            0, T_PLAIN, (batch, 1 << EXPAND_LEVEL), dtype=np.uint64)
        self.jsimd, self.tsimd = self.encrypt(self.simd, "simd")
        self.jpoly, self.tpoly = self.encrypt(self.poly, "poly")

    def encrypt(self, vals, enc):
        js, ts = [], []
        for v in vals:
            js.append(self.jsk.try_encrypt(J.Plaintext.try_encode(
                v, getattr(J.Encoding, enc)(), self.jp), self.jr))
            ts.append(self.tsk.try_encrypt(T.Plaintext.try_encode(
                v, getattr(T.Encoding, enc)(), self.tp), self.tr))
        return js, ts

    def col_gk(self):
        e = self.tek.rot_to_gk_exponent[1]
        return self.jek.gk[e], self.tek.gk[e]

    def tbatch(self, cts):
        return tuple(torch.stack([c[i] for c in cts]) for i in (0, 1))

    def jbatch(self, cts):
        return tuple(np.stack([np.asarray(c[i].coeffs) for c in cts])
                     for i in (0, 1))

    # expected plaintexts (tests/test_bfv.py:273-310)
    def want_rotated(self):
        h = self.n // 2
        return np.concatenate([np.roll(self.simd[:, :h], -1, axis=1),
                               np.roll(self.simd[:, h:], -1, axis=1)], axis=1)

    def want_inner_sum(self):
        sums = self.simd.astype(object).sum(axis=1) % T_PLAIN
        return np.repeat(sums.astype(np.uint64)[:, None], self.n, axis=1)

    def want_expanded(self, i, b):
        want = np.zeros(self.n, dtype=np.uint64)
        want[0] = (int(self.poly[b, i]) << EXPAND_LEVEL) % T_PLAIN
        return want

    def decrypt_both(self, c0, c1, enc):
        """Decode (c0, c1) under the port's and tpufhe's secret keys."""
        tct = T.Ciphertext(self.tp, [c0, c1], 0)
        ctx = self.jp.context_at_level(0)
        jct = J.Ciphertext(self.jp, [Poly(ctx, NTT, convert.from_tensor(c0)),
                                     Poly(ctx, NTT, convert.from_tensor(c1))], 0)
        got_t = self.tsk.try_decrypt(tct).try_decode(getattr(T.Encoding, enc)())
        got_j = np.asarray(self.jsk.try_decrypt(jct).try_decode(
            getattr(J.Encoding, enc)()))
        assert self.tsk.measure_noise(tct) == self.jsk.measure_noise(jct)
        return got_t, got_j


@pytest.fixture(scope="module")
def pair16():
    return Pair(16, 51)


@pytest.fixture(scope="module")
def pair256():
    return Pair(256, 53, batch=1)


def _assert_ksk_equal(jksk, tksk):
    assert jksk.seed == tksk.seed
    for name in ("c0", "c1"):
        for i, poly in enumerate(getattr(jksk, name)):
            np.testing.assert_array_equal(_words(poly),
                                          getattr(tksk, name)[i].numpy())
            np.testing.assert_array_equal(
                _shoup_words(poly), getattr(tksk, name + "_shoup")[i].numpy())


@pytest.mark.parametrize("degree", [16, 256])
def test_galois_key_matches_tpufhe(degree):
    jp = (J.BfvParametersBuilder().set_degree(degree)
          .set_plaintext_modulus(T_PLAIN).set_moduli_sizes(SIZES).build())
    tp = (T.BfvParametersBuilder().set_degree(degree)
          .set_plaintext_modulus(T_PLAIN).set_moduli_sizes(SIZES)
          .set_device("cpu").build())
    jr, tr = JRng(j_seed(degree)), ChaCha8Rng(seed_from_u64(degree))
    jsk, tsk = J.SecretKey.random(jp, jr), T.SecretKey.random(tp, tr)
    for e in (3, 2 * degree - 1):
        jgk = JGaloisKey.new(jsk, e, 0, 0, jr)
        tgk = GaloisKey.new(tsk, e, 0, 0, tr)
        assert jgk.element.exponent == tgk.element.exponent
        _assert_ksk_equal(jgk.ksk, tgk.ksk)


@pytest.mark.parametrize("fixture", ["pair16", "pair256"])
def test_evaluation_key_matches_tpufhe(fixture, request):
    p = request.getfixturevalue(fixture)
    assert p.jek.rot_to_gk_exponent == p.tek.rot_to_gk_exponent
    assert list(p.jek.gk) == list(p.tek.gk)
    for e, jgk in p.jek.gk.items():
        _assert_ksk_equal(jgk.ksk, p.tek.gk[e].ksk)
    assert len(p.jek.monomials) == len(p.tek.monomials)
    for jm, (mono, mono_shoup) in zip(p.jek.monomials, p.tek.monomials):
        np.testing.assert_array_equal(_words(jm), mono.numpy())
        np.testing.assert_array_equal(_shoup_words(jm), mono_shoup.numpy())
    for b in range(len(p.simd)):
        for i in (0, 1):
            np.testing.assert_array_equal(_words(p.jsimd[b][i]),
                                          p.tsimd[b][i].numpy())


# ---------------------------------------------------------------------------
# Programs at degree 16 against tpufhe's programs
# ---------------------------------------------------------------------------


def test_rotate_matches_tpufhe_program(pair16):
    p = pair16
    jgk, tgk = p.col_gk()
    with jax.disable_jit():
        w0, w1 = j_make_rotate(p.jp, jgk)(*p.jbatch(p.jsimd))
    c0, c1 = make_rotate(p.tp, tgk)(*p.tbatch(p.tsimd))
    np.testing.assert_array_equal(convert.lanes_to_words(np.asarray(w0)), c0)
    np.testing.assert_array_equal(convert.lanes_to_words(np.asarray(w1)), c1)
    for b in range(len(p.simd)):
        for got in p.decrypt_both(c0[b], c1[b], "simd"):
            np.testing.assert_array_equal(got, p.want_rotated()[b])


def test_inner_sum_matches_tpufhe_program(pair16):
    p = pair16
    with jax.disable_jit():
        w0, w1 = j_make_inner_sum(p.jp, p.jek)(*p.jbatch(p.jsimd))
    c0, c1 = make_inner_sum(p.tp, p.tek)(*p.tbatch(p.tsimd))
    np.testing.assert_array_equal(convert.lanes_to_words(np.asarray(w0)), c0)
    np.testing.assert_array_equal(convert.lanes_to_words(np.asarray(w1)), c1)
    for b in range(len(p.simd)):
        for got in p.decrypt_both(c0[b], c1[b], "simd"):
            np.testing.assert_array_equal(got, p.want_inner_sum()[b])


def test_expand_matches_tpufhe_program(pair16):
    p = pair16
    with jax.disable_jit():
        w0, w1 = j_make_expand(p.jp, p.jek, EXPAND_LEVEL)(*p.jbatch(p.jpoly))
    c0, c1 = make_expand(p.tp, p.tek, EXPAND_LEVEL)(*p.tbatch(p.tpoly))
    assert tuple(c0.shape) == (1 << EXPAND_LEVEL, len(p.poly), 4, p.n)
    np.testing.assert_array_equal(convert.lanes_to_words(np.asarray(w0)), c0)
    np.testing.assert_array_equal(convert.lanes_to_words(np.asarray(w1)), c1)
    for i in range(1 << EXPAND_LEVEL):
        for b in range(len(p.poly)):
            for got in p.decrypt_both(c0[i, b], c1[i, b], "poly"):
                np.testing.assert_array_equal(got, p.want_expanded(i, b))


# ---------------------------------------------------------------------------
# Programs at degree 256 against tpufhe's object API
# ---------------------------------------------------------------------------


def _assert_ct_equal(jct, c0, c1):
    np.testing.assert_array_equal(_words(jct[0]), c0.numpy())
    np.testing.assert_array_equal(_words(jct[1]), c1.numpy())


def test_programs_match_object_api_at_degree_256(pair256):
    p = pair256
    jct, tct = p.jsimd[0], p.tsimd[0]
    _, tgk = p.col_gk()

    want = p.jek.rotates_columns_by(jct, 1)
    c0, c1 = make_rotate(p.tp, tgk)(tct[0], tct[1])
    _assert_ct_equal(want, c0, c1)
    port = p.tek.rotates_columns_by(tct, 1)
    assert torch.equal(port[0], c0) and torch.equal(port[1], c1)
    for got in p.decrypt_both(c0, c1, "simd"):
        np.testing.assert_array_equal(got, p.want_rotated()[0])

    want = p.jek.rotates_rows(jct)
    port = p.tek.rotates_rows(tct)
    _assert_ct_equal(want, port[0], port[1])
    h = p.n // 2
    for got in p.decrypt_both(port[0], port[1], "simd"):
        np.testing.assert_array_equal(
            got, np.concatenate([p.simd[0, h:], p.simd[0, :h]]))

    want = p.jek.computes_inner_sum(jct)
    c0, c1 = make_inner_sum(p.tp, p.tek)(tct[0], tct[1])
    _assert_ct_equal(want, c0, c1)
    port = p.tek.computes_inner_sum(tct)
    assert torch.equal(port[0], c0) and torch.equal(port[1], c1)
    for got in p.decrypt_both(c0, c1, "simd"):
        np.testing.assert_array_equal(got, p.want_inner_sum()[0])

    size = 1 << EXPAND_LEVEL
    want = p.jek.expands(p.jpoly[0], size)
    c0, c1 = make_expand(p.tp, p.tek, EXPAND_LEVEL)(
        p.tpoly[0][0][None], p.tpoly[0][1][None])
    port = p.tek.expands(p.tpoly[0], size)
    for i in range(size):
        _assert_ct_equal(want[i], c0[i, 0], c1[i, 0])
        assert torch.equal(port[i][0], c0[i, 0])
        assert torch.equal(port[i][1], c1[i, 0])
        for got in p.decrypt_both(c0[i, 0], c1[i, 0], "poly"):
            np.testing.assert_array_equal(got, p.want_expanded(i, 0))


# ---------------------------------------------------------------------------
# Keys carried across, refusals
# ---------------------------------------------------------------------------


def _same_tables(jksk, tksk):
    """A tpufhe and a port key-switching key have the same seed and rows."""
    assert jksk.seed == tksk.seed
    for name in ("c0", "c0_shoup", "c1", "c1_shoup"):
        attr = "coeffs_shoup" if name.endswith("shoup") else "coeffs"
        rows = np.stack([np.asarray(getattr(q, attr))
                         for q in getattr(jksk, name[:2])])
        np.testing.assert_array_equal(convert.lanes_to_words(rows),
                                      getattr(tksk, name).numpy())


def _ksk_arrays(ksk):
    return (ksk.seed, [np.asarray(q.coeffs) for q in ksk.c0],
            [np.asarray(q.coeffs_shoup) for q in ksk.c0],
            [np.asarray(q.coeffs) for q in ksk.c1],
            [np.asarray(q.coeffs_shoup) for q in ksk.c1])


def test_keys_carried_across_by_convert(pair16):
    p = pair16
    jgk, tgk = p.col_gk()
    gk = convert.galois_key(p.tp, jgk.element.exponent, *_ksk_arrays(jgk.ksk))
    ek = convert.evaluation_key(
        p.tp, {e: _ksk_arrays(g.ksk) for e, g in p.jek.gk.items()})
    x = p.tbatch(p.tsimd)
    for got, want in (
            (make_rotate(p.tp, gk)(*x), make_rotate(p.tp, tgk)(*x)),
            (make_inner_sum(p.tp, ek)(*x), make_inner_sum(p.tp, p.tek)(*x)),
            (make_expand(p.tp, ek, EXPAND_LEVEL)(*p.tbatch(p.tpoly)),
             make_expand(p.tp, p.tek, EXPAND_LEVEL)(*p.tbatch(p.tpoly)))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    c0, c1 = make_rotate(p.tp, gk)(*x)
    sk = convert.secret_key(p.jsk.coeffs, p.tp)
    got = sk.try_decrypt(T.Ciphertext(p.tp, [c0[0], c1[0]], 0)).try_decode(
        T.Encoding.simd())
    np.testing.assert_array_equal(got, p.want_rotated()[0])


def test_refusals(pair16):
    p = pair16
    # keys at other levels than the ciphertexts', built as tpufhe builds
    # them: a Galois key in the smaller context of level 1 for level-0
    # ciphertexts (which its rotation refuses, as tpufhe's does), and an
    # evaluation key for level-1 ciphertexts held at level 0
    sk = T.SecretKey.random(p.tp, ChaCha8Rng(seed_from_u64(7)))
    jsk = J.SecretKey.random(p.jp, JRng(j_seed(7)))
    jgk = JGaloisKey.new(jsk, 3, 0, 1, JRng(j_seed(8)))
    gk = GaloisKey.new(sk, 3, 0, 1, ChaCha8Rng(seed_from_u64(8)))
    assert gk.ksk.c0.shape == (4, 3, p.n)
    _same_tables(jgk.ksk, gk.ksk)
    with pytest.raises(JInvalidContext):
        jgk.relinearize(p.jsimd[0])
    with pytest.raises(InvalidContext):
        gk.relinearize(p.tsimd[0])
    jek = JEkb(jsk, 1, 0).enable_expansion(1).build(JRng(j_seed(9)))
    tek = EvaluationKeyBuilder(sk, 1, 0).enable_expansion(1).build(
        ChaCha8Rng(seed_from_u64(9)))
    assert sorted(tek.gk) == sorted(jek.gk)
    for e, g in jek.gk.items():
        _same_tables(g.ksk, tek.gk[e].ksk)
    ek = EvaluationKeyBuilder(p.tsk).enable_expansion(1).build(
        ChaCha8Rng(seed_from_u64(9)))
    with pytest.raises(InvalidRotationStep):
        ek.rotates_columns_by(p.tsimd[0], 1)
    with pytest.raises(InvalidRotationStep):
        EvaluationKeyBuilder(p.tsk).enable_column_rotation(p.n)
    with pytest.raises(UnsupportedOperation):
        make_inner_sum(p.tp, ek)
    with pytest.raises(UnsupportedOperation):
        make_expand(p.tp, ek, 2)
