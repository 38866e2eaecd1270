"""The port's parameter and object API against tpufhe, bit-exact (tolerance
0): set_variance (the samplers at variance 1 and 16, the errors at 0 and
17), the large plaintext modulus t = 2^127 - 1 (the four cases of
tests/test_biguint.py), RGSW encryption and the external product (also
batched), the trait registrations of tests/test_traits.py, and the eight
error classes the port added. Degree 16; both packages draw from one
ChaCha8 seed; tpufhe runs on the CPU."""

import inspect

import jax  # noqa: F401  (tpufhe's backend, on the CPU here)
import numpy as np
import pytest
import torch

import tpufhe.bfv as J
import tpufhe.errors as JE
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed

import tpufhe_torch.bfv as T
import tpufhe_torch.errors as TE
from tpufhe_torch import convert, traits
from tpufhe_torch.ops.rq import Poly
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

N = 16
M127 = (1 << 127) - 1  # the reference's big-t choice (biguint.rs)


def _words(x):
    return convert.lanes_to_words(np.asarray(getattr(x, "coeffs", x)))


def _same(jct, tct):
    assert len(jct) == len(tct) and jct.level == tct.level
    for i in range(len(jct)):
        np.testing.assert_array_equal(_words(jct[i]), tct[i].numpy())


def _both(t, sizes, variance=None, seed=99):
    """Parameters, secret keys and rngs of both packages from one seed."""
    out = []
    for m, rng in ((J, JRng(j_seed(seed))), (T, ChaCha8Rng(seed_from_u64(seed)))):
        b = (m.BfvParametersBuilder().set_degree(N).set_plaintext_modulus(t)
             .set_moduli_sizes(sizes))
        if variance is not None:
            b = b.set_variance(variance)
        if m is T:
            b = b.set_device("cpu")
        par = b.build()
        out.append((m, par, m.SecretKey.random(par, rng), rng))
    return out


def _encrypt(side, values, encoding="poly", level=0):
    m, par, sk, rng = side
    enc = getattr(m.Encoding, encoding)(level)
    return sk.try_encrypt(m.Plaintext.try_encode(values, enc, par), rng)


# ---------------------------------------------------------------------------
# set_variance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variance", [1, 16])
def test_set_variance_samples_as_tpufhe(variance):
    (_, jpar, jsk, jr), (_, tpar, tsk, tr) = j, t = _both(65537, [62, 62],
                                                         variance)
    assert tpar.variance == jpar.variance == variance
    np.testing.assert_array_equal(jsk.coeffs, tsk.coeffs)
    assert np.abs(tsk.coeffs).max() <= 2 * variance  # CBD over 4v coins
    vals = list(range(N))
    _same(_encrypt(j, vals, "simd"), _encrypt(t, vals, "simd"))
    jpk, tpk = J.PublicKey.new(jsk, jr), T.PublicKey.new(tsk, tr)
    _same(jpk.c, tpk.c)
    jpt = J.Plaintext.try_encode(vals, J.Encoding.simd(), jpar)
    tpt = T.Plaintext.try_encode(vals, T.Encoding.simd(), tpar)
    _same(jpk.try_encrypt(jpt, jr), tpk.try_encrypt(tpt, tr))
    jrk, trk = J.RelinearizationKey.new(jsk, jr), T.RelinearizationKey.new(
        tsk, tr)
    assert jrk.to_bytes() == trk.to_bytes()


@pytest.mark.parametrize("variance", [0, 17])
def test_set_variance_out_of_range_raises_as_tpufhe(variance):
    msgs = []
    for m, err in ((J, JE.ParametersError), (T, TE.ParametersError)):
        b = (m.BfvParametersBuilder().set_degree(N).set_plaintext_modulus(
            1153).set_moduli_sizes([62]).set_variance(variance))
        if m is T:
            b = b.set_device("cpu")
        with pytest.raises(err) as info:
            b.build()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] == "Parameters error: invalid variance"


# ---------------------------------------------------------------------------
# the large plaintext modulus (tests/test_biguint.py)
# ---------------------------------------------------------------------------


def _decoded(side, ct):
    m, _, sk, _ = side
    return [int(v) for v in sk.try_decrypt(ct).try_decode(m.Encoding.poly())]


def test_biguint_plaintext_encryption_decryption():
    j, t = _both(M127, [60] * 5)
    assert not t[1].plaintext.is_small and t[1].ntt_operator is None
    values = [0] * N
    values[0], values[1], values[2] = 123456789, M127 - 1, M127 // 2
    jct, tct = _encrypt(j, values), _encrypt(t, values)
    _same(jct, tct)
    assert _decoded(t, tct) == _decoded(j, jct) == values
    tpt = T.Plaintext.try_encode(values, T.Encoding.poly(), t[1])
    assert tpt.value == values
    small = T.Plaintext.try_encode(values[:2], T.Encoding.poly(), t[1])
    assert small.try_decode_i64()[:3].tolist() == [123456789, -1, 0]
    with pytest.raises(TE.SimdNotSupported):
        T.Plaintext.try_encode(values, T.Encoding.simd(), t[1])


def test_biguint_homomorphic_addition():
    j, t = _both(M127, [60] * 5)
    v1, v2 = [0] * N, [0] * N
    v1[0], v2[0] = 10, M127 - 50
    js = J.ct_add(_encrypt(j, v1), _encrypt(j, v2))
    ts = T.ct_add(_encrypt(t, v1), _encrypt(t, v2))
    _same(js, ts)
    assert _decoded(t, ts)[0] == _decoded(j, js)[0] == M127 - 40


def test_biguint_multiplication_without_relin():
    j, t = _both(M127, [60] * 5)
    v1, v2 = [0] * N, [0] * N
    v1[0], v2[0] = 10, M127 - 20
    jp = J.ct_mul(_encrypt(j, v1), _encrypt(j, v2))
    tp = T.ct_mul(_encrypt(t, v1), _encrypt(t, v2))
    assert len(tp) == 3
    _same(jp, tp)
    assert _decoded(t, tp)[0] == _decoded(j, jp)[0] == M127 - 200
    assert t[2].measure_noise(tp) == j[2].measure_noise(jp)


def test_small_modulus_with_biguint_input():
    j, t = _both(1153, [62])
    values = [0] * N
    values[0] = 1153 + 5
    jct, tct = (s[2].try_encrypt(s[0].Plaintext.try_encode_i64(
        values, s[0].Encoding.poly(), s[1]), s[3]) for s in (j, t))
    _same(jct, tct)
    assert _decoded(t, tct)[0] == _decoded(j, jct)[0] == 5


# ---------------------------------------------------------------------------
# RGSW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", [0, 1])
def test_rgsw_encrypt_and_external_product_match_tpufhe(level):
    j, t = _both(65537, [62, 62, 62], seed=6)
    vals = [3, 1, 4, 1, 5]
    (jm, jpar, jsk, jr), (tm, tpar, tsk, tr) = j, t
    jg = J.RGSWCiphertext.encrypt(jsk, J.Plaintext.try_encode(
        [2, 7], J.Encoding.simd(level), jpar), jr)
    tg = T.RGSWCiphertext.encrypt(tsk, T.Plaintext.try_encode(
        [2, 7], T.Encoding.simd(level), tpar), tr)
    for a, b in ((jg.ksk0, tg.ksk0), (jg.ksk1, tg.ksk1)):
        assert a.seed == b.seed and a.ksk_level == b.ksk_level == level
        for name in ("c0", "c1"):
            for i, poly in enumerate(getattr(a, name)):
                np.testing.assert_array_equal(_words(poly),
                                              getattr(b, name)[i].numpy())
    jc = [_encrypt(j, vals, "simd", level), _encrypt(j, vals[::-1], "simd", level)]
    tc = [_encrypt(t, vals, "simd", level), _encrypt(t, vals[::-1], "simd", level)]
    jx = [jg.external_product(c) for c in jc]
    tx = [tg.external_product(c) for c in tc]
    for a, b in zip(jx, tx):
        _same(a, b)
    got = tsk.try_decrypt(tx[0]).try_decode(T.Encoding.simd(level))
    np.testing.assert_array_equal(got[:2], [6, 7])
    # a batch of both ciphertexts in one call: the rows' products
    batch = T.Ciphertext(tpar, [torch.stack([c[i] for c in tc])
                                for i in (0, 1)], level)
    out = tg.external_product(batch)
    for r in range(2):
        assert all(torch.equal(out[i][r], tx[r][i]) for i in (0, 1))
    with pytest.raises(TE.InvalidLevel):
        tg.external_product(_encrypt(t, vals, "simd", 1 - level))


# ---------------------------------------------------------------------------
# traits (tests/test_traits.py)
# ---------------------------------------------------------------------------


def test_trait_registrations():
    _, (_, par, sk, rng) = _both(1153, [62, 62], seed=7)
    pk = T.PublicKey.new(sk, rng)
    pt = T.Plaintext.try_encode([1, 2, 3], T.Encoding.poly(), par)
    ct = sk.try_encrypt(pt, rng)
    assert isinstance(par, traits.FheParameters)
    assert isinstance(par, traits.Serialize)
    assert isinstance(par, traits.Deserialize)
    assert isinstance(T.Encoding.poly(), traits.FhePlaintextEncoding)
    assert isinstance(pt, traits.FhePlaintext)
    assert isinstance(pt, traits.FheDecoder)
    assert isinstance(pt, traits.FheEncoder)
    assert isinstance(ct, traits.FheCiphertext)
    assert isinstance(ct, traits.Serialize)
    assert isinstance(ct, traits.DeserializeParametrized)
    assert isinstance(sk, traits.FheEncrypter)
    assert isinstance(sk, traits.FheDecrypter)
    assert isinstance(pk, traits.FheEncrypter)
    poly = Poly.zero(par.context_at_level(0))
    assert isinstance(poly, traits.DeserializeWithContext)
    assert not isinstance(poly, traits.DeserializeParametrized)
    for cls in (T.Ciphertext, T.PublicKey, T.SecretKey, T.KeySwitchingKey,
                T.RelinearizationKey, T.GaloisKey, T.EvaluationKey,
                T.RGSWCiphertext):
        assert issubclass(cls, traits.FheParametrized)
        assert issubclass(cls, traits.Serialize)
        assert issubclass(cls, traits.DeserializeParametrized)
        assert callable(cls.from_bytes) and callable(cls.to_bytes)


def test_trait_method_roundtrips():
    _, (_, par, sk, rng) = _both(1153, [62, 62], seed=7)
    ct = sk.try_encrypt(T.Plaintext.try_encode([5, 6], T.Encoding.poly(), par),
                        rng)
    assert T.BfvParameters.try_deserialize(par.to_bytes(), "cpu") == par
    ct2 = T.Ciphertext.from_bytes(ct.to_bytes(), par)
    got = sk.try_decrypt(ct2).try_decode(T.Encoding.poly())
    np.testing.assert_array_equal(got[:2], [5, 6])
    sk2 = T.SecretKey.from_bytes(sk.to_bytes(), par)
    np.testing.assert_array_equal(sk2.coeffs, sk.coeffs)
    for key in (T.RelinearizationKey.new(sk, rng),
                T.GaloisKey.new(sk, 3, 0, 0, rng),
                T.EvaluationKeyBuilder(sk).enable_inner_sum().build(rng)):
        again = type(key).from_bytes(key.to_bytes(), par)
        assert isinstance(again, type(key))
        assert again.to_bytes() == key.to_bytes()
    p = Poly(par.context_at_level(0), "ntt", sk.try_encrypt(
        T.Plaintext.try_encode([1], T.Encoding.poly(), par), rng)[0])
    assert torch.equal(Poly.from_bytes(p.to_bytes(), p.ctx).coeffs, p.coeffs)


# ---------------------------------------------------------------------------
# the error classes
# ---------------------------------------------------------------------------

NEW_ERRORS = [
    ("IncorrectRepresentation", ("ntt", "power")),
    ("InvalidSeedSize", (31, 32)),
    ("EncodingNotSupported", ("simd at this t",)),
    ("DataExceedsModulus", (70000, 65537)),
    ("InvalidPlaintext", ("wrong level",)),
    ("InvalidSecretKey", ("wrong degree",)),
    ("SerializationError", ("Invalid degree",)),
    ("UnexpectedError", ("something",)),
]


@pytest.mark.parametrize("name, args", NEW_ERRORS,
                         ids=[n for n, _ in NEW_ERRORS])
def test_new_error_classes_match_tpufhe(name, args):
    tcls, jcls = getattr(TE, name), getattr(JE, name)
    assert [c.__name__ for c in tcls.__mro__] == [c.__name__
                                                  for c in jcls.__mro__]
    assert str(tcls(*args)) == str(jcls(*args))
    assert issubclass(tcls, TE.FheError) and issubclass(tcls, ValueError)


def test_every_tpufhe_error_class_is_ported():
    def classes(mod):
        return {n for n, c in vars(mod).items()
                if inspect.isclass(c) and issubclass(c, Exception)}

    assert classes(TE) == classes(JE)
    for n in classes(JE):
        assert getattr(TE, n).__bases__[0].__name__ == \
            getattr(JE, n).__bases__[0].__name__
