"""The port's wire format against tpufhe's, byte for byte: every object
kind serialized by the port equals tpufhe's bytes for the same object
(both packages make it from one ChaCha8 seed), tpufhe's bytes decode in
the port to tensors equal to the port's own object, and the port's bytes
decode in tpufhe and serialize again to the same bytes. Also every
SerializationError case with tpufhe's message, and the transcode against
tpufhe's at every width 1-64 and on the literal fixtures of
tests/test_byte_fixtures.py (copied). Degree 16 (the rk in log_base mode
at one 62-bit modulus); tpufhe runs on the CPU."""

import jax  # noqa: F401  (tpufhe's backend, on the CPU here)
import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe.errors import SerializationError as JSerializationError
from tpufhe.ops.rq import Poly as JPoly
from tpufhe.ops.zq import Modulus as JModulus
from tpufhe.utils import transcode as jtranscode
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed

import tpufhe_torch.bfv as T
from tpufhe_torch import convert
from tpufhe_torch.errors import SerializationError
from tpufhe_torch.ops.rq import NTT, NTT_SHOUP, POWER_BASIS, Poly, ntt_backward
from tpufhe_torch.ops.zq import Modulus
from tpufhe_torch.serialize.proto import (
    emit_bytes_field,
    emit_varint_field,
)
from tpufhe_torch.utils import transcode
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

N = 16


def _words(x):
    return convert.lanes_to_words(np.asarray(getattr(x, "coeffs", x)))


class Pair:
    """Parameters, secret keys and rngs of both packages from one seed."""

    def __init__(self, seed, sizes=(62, 62, 62), t=1153):
        self.jpar = (J.BfvParametersBuilder().set_degree(N)
                     .set_plaintext_modulus(t).set_moduli_sizes(list(sizes))
                     .build())
        self.tpar = T.BfvParameters.try_deserialize(self.jpar.to_bytes(),
                                                    "cpu")
        self.jr, self.tr = JRng(j_seed(seed)), ChaCha8Rng(seed_from_u64(seed))
        self.jsk = J.SecretKey.random(self.jpar, self.jr)
        self.tsk = T.SecretKey.random(self.tpar, self.tr)

    def encrypt(self, values, encoding="simd", level=0):
        jpt = J.Plaintext.try_encode(values, getattr(J.Encoding, encoding)(
            level), self.jpar)
        tpt = T.Plaintext.try_encode(values, getattr(T.Encoding, encoding)(
            level), self.tpar)
        return self.jsk.try_encrypt(jpt, self.jr), self.tsk.try_encrypt(
            tpt, self.tr)


@pytest.fixture(scope="module")
def pair():
    return Pair(31)


def _roundtrip(jobj, tobj, jcls, tcls, jpar, tpar):
    """Equal bytes both ways; returns the port's decoding of tpufhe's
    bytes."""
    data = tobj.to_bytes()
    assert data == jobj.to_bytes()
    assert jcls.from_bytes(data, jpar).to_bytes() == data
    back = tcls.from_bytes(jobj.to_bytes(), tpar)
    assert back.to_bytes() == data
    return back


def _same_ct(a, b):
    assert a.level == b.level and len(a) == len(b) and a.seed == b.seed
    for x, y in zip(a.c, b.c):
        assert torch.equal(x, y)


def _same_ksk(a, b):
    assert (a.seed, a.log_base, a.ciphertext_level, a.ksk_level) == (
        b.seed, b.log_base, b.ciphertext_level, b.ksk_level)
    for name in ("c0", "c0_shoup", "c1", "c1_shoup"):
        assert torch.equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("rep", [POWER_BASIS, NTT, NTT_SHOUP])
def test_poly_bytes(pair, rep):
    jct, tct = pair.encrypt(list(range(N)))
    jp = jct[0].with_representation(NTT)
    tp = Poly(pair.tpar.context_at_level(0), NTT, tct[0])
    if rep == POWER_BASIS:
        jp, tp = jp.into_power_basis(), tp.into_power_basis()
    elif rep == NTT_SHOUP:
        jp, tp = jp.into_ntt_shoup(), tp.into_ntt_shoup()
    data = tp.to_bytes()
    assert data == jp.to_bytes()
    back = Poly.from_bytes(jp.to_bytes(), tp.ctx, rep)
    assert back.representation == rep and torch.equal(back.coeffs, tp.coeffs)
    if rep == NTT_SHOUP:
        assert torch.equal(back.coeffs_shoup, tp.coeffs_shoup)
    np.testing.assert_array_equal(
        _words(type(jp).from_bytes(data, jp.ctx)), tp.coeffs.numpy())


@pytest.mark.parametrize("case", ["seeded", "unseeded", "level1_seeded",
                                  "level1_switched", "product", "empty"])
def test_ciphertext_bytes(pair, case):
    j0, t0 = pair.encrypt(list(range(N)))
    if case == "seeded":
        jct, tct = j0, t0
    elif case == "unseeded":
        jct, tct = J.ct_add(j0, j0), T.ct_add(t0, t0)
        assert tct.seed is None
    elif case == "level1_seeded":
        jct, tct = pair.encrypt([1, 2, 3], "poly", 1)
        assert tct.seed is not None and tct.level == 1
    elif case == "level1_switched":
        jct, tct = j0.clone(), t0.clone()
        jct.switch_to_level(1)
        tct.switch_to_level(1)
        assert tct.seed is None
    elif case == "product":
        jct, tct = J.ct_mul(j0, j0), T.ct_mul(t0, t0)
        assert len(tct) == 3
    else:
        jct, tct = J.Ciphertext.zero(pair.jpar), T.Ciphertext.zero(pair.tpar)
    data = tct.to_bytes()
    assert data == jct.to_bytes()
    if case == "empty":
        for cls, par, err in ((T.Ciphertext, pair.tpar, SerializationError),
                              (J.Ciphertext, pair.jpar, JSerializationError)):
            with pytest.raises(err, match="Not enough polynomials"):
                cls.from_bytes(data, par)
        return
    back = _roundtrip(jct, tct, J.Ciphertext, T.Ciphertext, pair.jpar,
                      pair.tpar)
    _same_ct(back, tct)
    if case == "seeded":
        got = pair.tsk.try_decrypt(back).try_decode(T.Encoding.simd())
        np.testing.assert_array_equal(got, np.arange(N))


def test_batched_ciphertext_raises_until_indexed(pair):
    _, t0 = pair.encrypt(list(range(N)))
    batch = T.Ciphertext(pair.tpar, [torch.stack([x, x]) for x in t0.c], 0)
    with pytest.raises(SerializationError):
        batch.to_bytes()
    one = T.Ciphertext(pair.tpar, [x[1] for x in batch.c], 0)
    assert one.to_bytes() == T.Ciphertext(pair.tpar, list(t0.c), 0).to_bytes()


def test_secret_and_public_key_bytes(pair):
    back = _roundtrip(pair.jsk, pair.tsk, J.SecretKey, T.SecretKey,
                      pair.jpar, pair.tpar)
    np.testing.assert_array_equal(back.coeffs, pair.tsk.coeffs)
    jpk, tpk = J.PublicKey.new(pair.jsk, pair.jr), T.PublicKey.new(
        pair.tsk, pair.tr)
    back = _roundtrip(jpk, tpk, J.PublicKey, T.PublicKey, pair.jpar, pair.tpar)
    _same_ct(back.c, tpk.c)


def _log_base_keys(p):
    """A relinearization key of one 62-bit modulus: RelinearizationKey.new
    refuses k == 1 in both packages, so the key of s^2 is made by
    KeySwitchingKey.new (log_base 31, two digit rows)."""
    jctx, tctx = p.jpar.context_at_level(0), p.tpar.context_at_level(0)
    js = JPoly.from_i64_coeffs(p.jsk.coeffs, jctx).into_ntt()
    s = p.tsk.s_ntt(tctx)
    jk = J.KeySwitchingKey.new(p.jsk, (js * js).into_power_basis(), 0, 0, p.jr)
    tk = T.KeySwitchingKey.new(p.tsk, ntt_backward(tctx, tctx.mul(s, s)), 0,
                               0, p.tr)
    return J.RelinearizationKey(jk), T.RelinearizationKey(tk)


@pytest.mark.parametrize("mode", ["garner", "log_base", "leveled"])
def test_relinearization_key_bytes(mode):
    p = Pair(32, (62,) if mode == "log_base" else (62, 62, 62))
    levels = (1, 0) if mode == "leveled" else (0, 0)
    if mode == "log_base":
        jrk, trk = _log_base_keys(p)
    else:
        jrk = J.RelinearizationKey.new(p.jsk, p.jr, *levels)
        trk = T.RelinearizationKey.new(p.tsk, p.tr, *levels)
    assert (trk.ksk.log_base != 0) == (mode == "log_base")
    back = _roundtrip(jrk, trk, J.RelinearizationKey, T.RelinearizationKey,
                      p.jpar, p.tpar)
    _same_ksk(back.ksk, trk.ksk)
    # a key whose c1 is written out, not seeded
    trk.ksk.seed = jrk.ksk.seed = None
    back = _roundtrip(jrk, trk, J.RelinearizationKey, T.RelinearizationKey,
                      p.jpar, p.tpar)
    _same_ksk(back.ksk, trk.ksk)


def test_galois_key_bytes(pair):
    jgk = J.GaloisKey.new(pair.jsk, 3, 0, 0, pair.jr)
    tgk = T.GaloisKey.new(pair.tsk, 3, 0, 0, pair.tr)
    back = _roundtrip(jgk, tgk, J.GaloisKey, T.GaloisKey, pair.jpar,
                      pair.tpar)
    assert back.element.exponent == 3
    _same_ksk(back.ksk, tgk.ksk)


@pytest.mark.parametrize("use", ["inner_sum", "leveled_expansion"])
def test_evaluation_key_bytes(pair, use):
    def build(m, sk, rng):
        if use == "inner_sum":
            return m.EvaluationKeyBuilder(sk).enable_inner_sum().build(rng)
        return m.EvaluationKeyBuilder(sk, 1, 0).enable_expansion(3).build(rng)

    jek, tek = build(J, pair.jsk, pair.jr), build(T, pair.tsk, pair.tr)
    back = _roundtrip(jek, tek, J.EvaluationKey, T.EvaluationKey, pair.jpar,
                      pair.tpar)
    assert list(back.gk) == list(tek.gk)
    for e in tek.gk:
        _same_ksk(back.gk[e].ksk, tek.gk[e].ksk)
    for (m, s), (m2, s2) in zip(back.monomials, tek.monomials):
        assert torch.equal(m, m2) and torch.equal(s, s2)


def test_rgsw_bytes(pair):
    jpt = J.Plaintext.try_encode([1, 2], J.Encoding.simd(), pair.jpar)
    tpt = T.Plaintext.try_encode([1, 2], T.Encoding.simd(), pair.tpar)
    jg = J.RGSWCiphertext.encrypt(pair.jsk, jpt, pair.jr)
    tg = T.RGSWCiphertext.encrypt(pair.tsk, tpt, pair.tr)
    back = _roundtrip(jg, tg, J.RGSWCiphertext, T.RGSWCiphertext, pair.jpar,
                      pair.tpar)
    _same_ksk(back.ksk0, tg.ksk0)
    _same_ksk(back.ksk1, tg.ksk1)


@pytest.mark.parametrize("case", ["small_t", "large_t", "variance",
                                  "narrow"])
def test_parameters_bytes(case):
    b = J.BfvParametersBuilder().set_degree(N).set_plaintext_modulus(1153)
    b = b.set_moduli_sizes([62, 62])
    if case == "large_t":
        b = b.set_plaintext_modulus((1 << 127) - 1).set_moduli_sizes([60] * 5)
    elif case == "variance":
        b = b.set_variance(3)
    elif case == "narrow":
        b = b.set_moduli_sizes([30, 30, 30])
    jpar = b.build()
    data = jpar.to_bytes()
    tpar = T.BfvParameters.try_deserialize(data, "cpu")
    assert tpar.to_bytes() == data
    assert J.BfvParameters.try_deserialize(tpar.to_bytes()) == jpar
    assert (tpar.moduli, tpar.variance, tpar.plaintext.value) == (
        jpar.moduli, jpar.variance, jpar.plaintext.value)
    assert tpar.context_at_level(0).narrow == (case == "narrow")
    assert tpar.device == torch.device("cpu")


def _both_raise(fn, match):
    """fn(module, par) raises each package's SerializationError with
    tpufhe's message."""
    msgs = []
    for m, err in ((J, JSerializationError), (T, SerializationError)):
        with pytest.raises(err, match=match) as info:
            fn(m)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_serialization_errors(pair):
    par = {J: pair.jpar, T: pair.tpar}
    jct, tct = pair.encrypt(list(range(N)))
    good = tct.to_bytes()
    poly_msg = Poly(pair.tpar.context_at_level(0), NTT, tct[0]).to_bytes()
    payload_len = sum(Modulus(p).serialization_length(N)
                      for p in pair.tpar.moduli)

    def rq(rep, degree, payload):
        return (emit_varint_field(1, rep) + emit_varint_field(2, degree)
                + emit_bytes_field(3, payload))

    def ct_of(poly_bytes):
        return (emit_bytes_field(1, poly_bytes, always=True)
                + emit_bytes_field(1, poly_bytes, always=True))

    cases = [
        (lambda m: m.Ciphertext.from_bytes(ct_of(rq(7, N, b"\0" * payload_len)),
                                           par[m]), "Invalid representation"),
        (lambda m: m.Ciphertext.from_bytes(ct_of(rq(2, 32, b"\0" * payload_len)),
                                           par[m]), "Invalid degree"),
        (lambda m: m.Ciphertext.from_bytes(ct_of(rq(2, N, b"\0" * 3)), par[m]),
         "Invalid coefficients"),
        (lambda m: m.Ciphertext.from_bytes(
            ct_of(rq(2, N, b"\xff" * payload_len)), par[m]),
         "Coefficient out of range"),
        (lambda m: m.Ciphertext.from_bytes(ct_of(rq(1, N, b"\0" * payload_len)),
                                           par[m]), "Representation mismatch"),
        (lambda m: m.Ciphertext.from_bytes(
            emit_bytes_field(1, poly_msg, always=True)
            + emit_bytes_field(2, b"s" * 31), par[m]), "Invalid seed size"),
        (lambda m: m.Ciphertext.from_bytes(good + emit_varint_field(3, 9),
                                           par[m]), "Invalid level"),
        (lambda m: m.PublicKey.from_bytes(b"", par[m]), "Missing field c"),
        (lambda m: m.RelinearizationKey.from_bytes(b"", par[m]),
         "Invalid serialization"),
        (lambda m: m.GaloisKey.from_bytes(b"", par[m]),
         "Invalid serialization"),
        (lambda m: m.RGSWCiphertext.from_bytes(b"", par[m]), "Missing ksk"),
        (lambda m: m.SecretKey.from_bytes(b"", par[m]),
         "SecretKey length mismatch"),
        (lambda m: m.BfvParameters.try_deserialize(emit_varint_field(1, N)),
         "Missing plaintext modulus"),
    ]
    for fn, match in cases:
        _both_raise(fn, match)
    # a public key not at level 0
    _, t1 = pair.encrypt([1], "poly", 1)
    pk1 = emit_bytes_field(1, t1.to_bytes(), always=True)
    _both_raise(lambda m: m.PublicKey.from_bytes(pk1, par[m]),
                "ciphertext level must be 0")
    # an RGSW ciphertext whose two keys are at different levels
    tpts = [T.Plaintext.try_encode([1], T.Encoding.poly(lv), pair.tpar)
            for lv in (0, 1)]
    g0, g1 = (T.RGSWCiphertext.encrypt(pair.tsk, pt, pair.tr) for pt in tpts)
    mixed = T.RGSWCiphertext(g0.ksk0, g1.ksk1).to_bytes()
    _both_raise(lambda m: m.RGSWCiphertext.from_bytes(mixed, par[m]),
                "Inconsistent key switching levels")
    # Galois keys of an evaluation key at another level than it says
    tek = T.EvaluationKeyBuilder(pair.tsk).enable_inner_sum().build(pair.tr)
    wrong = tek.to_bytes() + emit_varint_field(3, 1)
    _both_raise(lambda m: m.EvaluationKey.from_bytes(wrong, par[m]),
                "Galois key has incorrect ciphertext level")


# ---------------------------------------------------------------------------
# the transcode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbits", range(1, 65))
def test_transcode_matches_tpufhe(nbits):
    rng = np.random.default_rng(nbits)
    for n in (0, 1, 8, 13, 100):
        v = rng.integers(0, 1 << min(nbits, 63), n, dtype=np.uint64)
        if nbits == 64:
            v = v * np.uint64(2) + np.uint64(1)
        if n:
            v[-1] = np.uint64((1 << nbits) - 1)
        data = transcode.transcode_to_bytes(v, nbits)
        assert data == jtranscode.transcode_to_bytes(v, nbits)
        np.testing.assert_array_equal(
            transcode.transcode_from_bytes(data, nbits),
            jtranscode.transcode_from_bytes(data, nbits))
        for out in (1, 7, 20, 50, 64):
            np.testing.assert_array_equal(
                transcode.transcode_bidirectional(v, nbits, out),
                jtranscode.transcode_bidirectional(v, nbits, out))
    if nbits < 64:
        for fn in (transcode.transcode_to_bytes,
                   jtranscode.transcode_to_bytes):
            with pytest.raises(AssertionError):
                fn([1 << nbits], nbits)
        with pytest.raises(AssertionError):
            transcode.transcode_bidirectional([1 << nbits], nbits, 8)


def test_transcode_rows_match_one_at_a_time():
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 1 << 20, (5, 33), dtype=np.uint64)
    packed = transcode.transcode_to_bytes(rows, 20)
    for r, b in zip(rows, packed):
        assert b.tobytes() == jtranscode.transcode_to_bytes(r, 20)
    np.testing.assert_array_equal(transcode.transcode_from_bytes(packed, 20)
                                  [:, :33], rows)


# the literal fixtures of tests/test_byte_fixtures.py: the little-endian
# expansion of sum_i c_i << (nbits i), derived independently of any code
FIX_13_ASC = bytes([
    0, 32, 0, 8, 128, 1, 64, 0, 10, 128, 1, 56, 0,
    8, 32, 1, 40, 128, 5, 192, 0, 26, 128, 3, 120, 0,
])
FIX_13_HI = bytes([
    0, 48, 0, 10, 192, 1, 72, 0, 11, 160, 1, 60, 128,
    8, 48, 1, 42, 192, 5, 200, 0, 27, 160, 3, 124, 128,
])
FIX_30_HI = bytes([
    0, 0, 0, 96, 0, 0, 0, 40, 0, 0, 0, 14, 0, 0, 128,
    4, 0, 0, 96, 1, 0, 0, 104, 0, 0, 0, 30, 0, 0, 128,
])


@pytest.mark.parametrize("vals, nbits, fixture", [
    (list(range(16)), 13, FIX_13_ASC),
    ([4096 + i for i in range(16)], 13, FIX_13_HI),
    ([(1 << 29) + i for i in range(8)], 30, FIX_30_HI),
], ids=["13_ascending", "13_high_bit", "30_high_bit"])
def test_transcode_fixtures(vals, nbits, fixture):
    assert transcode.transcode_to_bytes(vals, nbits) == fixture
    np.testing.assert_array_equal(transcode.transcode_from_bytes(fixture, nbits),
                                  np.array(vals, dtype=np.uint64))


def test_modulus_serialize_vec_uses_p_minus_1_bits():
    q, jq = Modulus(8161), JModulus(8161)
    assert q.nbits == jq.nbits == 13
    assert q.serialization_length(16) == jq.serialization_length(16) == 26
    assert q.serialize_vec(np.arange(16, dtype=np.uint64)) == FIX_13_ASC
    np.testing.assert_array_equal(q.deserialize_vec(FIX_13_ASC),
                                  np.arange(16, dtype=np.uint64))
    assert Modulus(1 << 13).nbits == 13 and Modulus((1 << 13) + 1).nbits == 14
