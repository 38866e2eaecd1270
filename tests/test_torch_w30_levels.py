"""The rest of the narrow (w30) mode against tpufhe, bit-exact (tolerance
0): the oblivious expansion of int32 ciphertexts and keys below the
ciphertext's level, on keys and ciphertexts both packages make from one
ChaCha8 seed, degree 16, 3 x 30-bit moduli (levels 0, 1 and 2), t = 257:

- the monomials x^{-2^l} with their shoup32 constants;
- EvaluationKey.expands at level 4 (all 16 coefficients) and
  pipeline.make_expand on a batch of two, against tpufhe's expands, each
  output decrypting to 2^4 m_j in its constant coefficient;
- the leveled expansion (keys at level 0, ciphertexts at level 1) against
  tpufhe's make_expand(level=1);
- the relinearization key and a Galois key at level 0 for level-1
  ciphertexts (the Switcher's scale-up on int32 rows): their rows, Shoup
  constants and bytes, relinearizes after ct_mul, GaloisKey.relinearize
  and make_rotate, each decrypted.
"""

import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe.pipeline import make_expand as j_make_expand
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed

import tpufhe_torch.bfv as T
from tpufhe_torch import convert
from tpufhe_torch.pipeline import make_expand, make_rotate
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

N = 16
LEVEL = 4  # all 16 coefficients
PLAIN = 257


def _words(x):
    return convert.lanes_to_words(np.asarray(getattr(x, "coeffs", x)))


def _same(jct, tct):
    assert len(jct) == len(tct) and jct.level == tct.level
    for i in range(len(jct)):
        assert tct[i].dtype == torch.int32
        np.testing.assert_array_equal(_words(jct[i]), tct[i].numpy())


def _same_ksk(jk, tk):
    assert jk.seed == tk.seed and jk.log_base == tk.log_base
    assert (jk.ciphertext_level, jk.ksk_level) == (tk.ciphertext_level,
                                                   tk.ksk_level)
    for name in ("c0", "c1"):
        for i, poly in enumerate(getattr(jk, name)):
            np.testing.assert_array_equal(_words(poly),
                                          getattr(tk, name)[i].numpy())
            np.testing.assert_array_equal(
                _words(poly.coeffs_shoup),
                getattr(tk, name + "_shoup")[i].numpy())


class Narrow:
    """Parameters, secret keys, expansion keys (at the ciphertexts' level
    and at level 0 for level-1 ciphertexts) and ciphertexts of both
    packages from one seed."""

    def __init__(self, seed=2042):
        def build(builder):
            return (builder().set_degree(N).set_plaintext_modulus(PLAIN)
                    .set_moduli_sizes([30] * 3))

        self.jp = build(J.BfvParametersBuilder).build()
        self.tp = build(T.BfvParametersBuilder).set_device("cpu").build()
        assert self.tp.context_at_level(0).narrow
        self.jr, self.tr = JRng(j_seed(seed)), ChaCha8Rng(seed_from_u64(seed))
        self.jsk = J.SecretKey.random(self.jp, self.jr)
        self.tsk = T.SecretKey.random(self.tp, self.tr)
        self.jek = J.EvaluationKeyBuilder(self.jsk).enable_expansion(
            LEVEL).build(self.jr)
        self.tek = T.EvaluationKeyBuilder(self.tsk).enable_expansion(
            LEVEL).build(self.tr)
        self.jek1 = J.EvaluationKeyBuilder(self.jsk, 1, 0).enable_expansion(
            LEVEL).build(self.jr)
        self.tek1 = T.EvaluationKeyBuilder(self.tsk, 1, 0).enable_expansion(
            LEVEL).build(self.tr)
        self.vals = np.random.default_rng(seed)

    def encrypt(self, v, enc="poly", level=0):
        jpt = J.Plaintext.try_encode(v, getattr(J.Encoding, enc)(level),
                                     self.jp)
        tpt = T.Plaintext.try_encode(v, getattr(T.Encoding, enc)(level),
                                     self.tp)
        return (self.jsk.try_encrypt(jpt, self.jr),
                self.tsk.try_encrypt(tpt, self.tr))

    def random(self):
        return self.vals.integers(0, PLAIN, N, dtype=np.uint64)

    def decode(self, tct, enc="poly"):
        return self.tsk.try_decrypt(tct).try_decode(
            getattr(T.Encoding, enc)(tct.level))


@pytest.fixture(scope="module")
def narrow():
    return Narrow()


def _check_expanded(n, outs, v, level):
    """Output j decrypts to 2^LEVEL v_j in its constant coefficient."""
    for j, ct in enumerate(outs):
        assert ct.level == level
        want = np.zeros(N, np.uint64)
        want[0] = (v[j] << LEVEL) % PLAIN
        np.testing.assert_array_equal(n.decode(ct), want)


def test_narrow_monomials_match_tpufhe(narrow):
    n = narrow
    assert len(n.tek.monomials) == len(n.jek.monomials) == 4
    for jm, (mono, shoup) in zip(n.jek.monomials, n.tek.monomials):
        assert mono.dtype == shoup.dtype == torch.int32
        np.testing.assert_array_equal(_words(jm), mono.numpy())
        np.testing.assert_array_equal(_words(jm.coeffs_shoup), shoup.numpy())


def test_narrow_expansion_matches_tpufhe(narrow):
    n = narrow
    for e, jg in n.jek.gk.items():
        _same_ksk(jg.ksk, n.tek.gk[e].ksk)
    v = n.random()
    jc, tc = n.encrypt(v)
    jout, tout = n.jek.expands(jc, N), n.tek.expands(tc, N)
    assert len(tout) == N
    for a, b in zip(jout, tout):
        _same(a, b)
    _check_expanded(n, tout, v, 0)


def test_narrow_make_expand_matches_expands(narrow):
    """The batched program (each doubling: ntt32 2, ks_accumulate 1 on the
    card; the fold's shoup32 product) equals the object API, row by row."""
    n = narrow
    vs = [n.random(), n.random()]
    cts = [n.encrypt(v)[1] for v in vs]
    c0, c1 = make_expand(n.tp, n.tek, LEVEL)(
        torch.stack([c[0] for c in cts]), torch.stack([c[1] for c in cts]))
    assert c0.shape == (N, 2, 3, N) and c0.dtype == torch.int32
    for b, (ct, v) in enumerate(zip(cts, vs)):
        for j, out in enumerate(n.tek.expands(ct, N)):
            assert torch.equal(c0[j, b], out[0]) and torch.equal(c1[j, b], out[1])
        _check_expanded(n, [T.Ciphertext(n.tp, [c0[j, b], c1[j, b]], 0)
                            for j in range(N)], v, 0)


def test_narrow_leveled_expansion_matches_tpufhe(narrow):
    """Keys at level 0 for level-1 ciphertexts: every doubling key-switches
    over the key's three moduli and switches down (ntt32 4 a doubling)."""
    n = narrow
    assert (n.tek1.ciphertext_level, n.tek1.evaluation_key_level) == (1, 0)
    for e, jg in n.jek1.gk.items():
        _same_ksk(jg.ksk, n.tek1.gk[e].ksk)
    v = n.random()
    jc, tc = n.encrypt(v, level=1)
    _same(jc, tc)
    je = j_make_expand(n.jp, n.jek1, LEVEL, level=1)(
        jc[0].coeffs[None], jc[1].coeffs[None])
    c0, c1 = make_expand(n.tp, n.tek1, LEVEL, level=1)(tc[0][None],
                                                       tc[1][None])
    np.testing.assert_array_equal(_words(je[0]), c0.numpy())
    np.testing.assert_array_equal(_words(je[1]), c1.numpy())
    outs = n.tek1.expands(tc, N)
    for j, ct in enumerate(outs):
        assert torch.equal(ct[0], c0[j, 0]) and torch.equal(ct[1], c1[j, 0])
    _check_expanded(n, outs, v, 1)


def test_narrow_leveled_relinearization_matches_tpufhe(narrow):
    n = narrow
    jrk = J.RelinearizationKey.new(n.jsk, JRng(j_seed(5)), 1, 0)
    trk = T.RelinearizationKey.new(n.tsk, ChaCha8Rng(seed_from_u64(5)), 1, 0)
    _same_ksk(jrk.ksk, trk.ksk)
    assert trk.ksk.c0.shape == (2, 3, N) and trk.ksk.c0.dtype == torch.int32
    assert trk.to_bytes() == jrk.to_bytes()
    va, vb = n.random(), n.random()
    (ja, ta), (jb, tb) = (n.encrypt(v, "simd", 1) for v in (va, vb))
    jc, tc = J.ct_mul(ja, jb), T.ct_mul(ta, tb)
    _same(jc, tc)
    jrk.relinearizes(jc)
    trk.relinearizes(tc)
    _same(jc, tc)
    np.testing.assert_array_equal(n.decode(tc, "simd"),
                                  (va.astype(object) * vb % PLAIN
                                   ).astype(np.uint64))


def test_narrow_leveled_rotation_matches_tpufhe(narrow):
    n = narrow
    jek = J.EvaluationKeyBuilder(n.jsk, 1, 0).enable_column_rotation(
        1).build(JRng(j_seed(6)))
    tek = T.EvaluationKeyBuilder(n.tsk, 1, 0).enable_column_rotation(
        1).build(ChaCha8Rng(seed_from_u64(6)))
    e = tek.rot_to_gk_exponent[1]
    _same_ksk(jek.gk[e].ksk, tek.gk[e].ksk)
    assert tek.to_bytes() == jek.to_bytes()
    v = n.random()
    jc, tc = n.encrypt(v, "simd", 1)
    jr, tr = jek.rotates_columns_by(jc, 1), tek.rotates_columns_by(tc, 1)
    _same(jr, tr)
    c0, c1 = make_rotate(n.tp, tek.gk[e], level=1)(tc[0][None], tc[1][None])
    assert torch.equal(c0[0], tr[0]) and torch.equal(c1[0], tr[1])
    h = N // 2
    np.testing.assert_array_equal(
        n.decode(tr, "simd"),
        np.concatenate([np.roll(v[:h], -1), np.roll(v[h:], -1)]))
