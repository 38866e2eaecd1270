"""The port's BFV operation layer against tpufhe's, bit-exact (tolerance 0):

- the empty ciphertext (Ciphertext.zero) as the identity of ct_add and
  ct_sub, and Ciphertext.new's size check;
- ct_neg, ct_add_pt, ct_sub_pt, ct_mul_pt and the operators, on ciphertexts
  and plaintexts made by both packages from one ChaCha8 seed;
- ct_mul and ct_square to three parts, and on a three-part operand (four
  and five parts), decrypted by both packages;
- Multiplicator (default, strategy 2 with kP = 1 and 2) against tpufhe's
  Multiplicator.multiply and the port's make_mul_relin;
- dot_product_scalar, rq.dot_product and make_ct_pt_dot at n in {1, 14,
  15, 29} terms (14 is the 62-bit window, so 15 and 29 cross a reduction)
  and m in {1, 3} columns; the plain ct_pt_dot at N = 8192 across a window;
- make_add, Scaler.scale in both forms, Plaintext.poly_ntt, zero, the i64
  codecs and PlaintextVec, default_parameters_128 and the level accessors.

Program-level parity runs at degree 16 (tpufhe's object API compiles per
shape on the CPU).
"""

import jax
import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe.errors import ParametersError as JParametersError
from tpufhe.ops.rns import ScalingFactor as JScalingFactor
from tpufhe.ops.rq import NTT, POWER_BASIS, Poly
from tpufhe.ops.rq import Context as JContext
from tpufhe.ops.rq import Scaler as JScaler
from tpufhe.ops.rq import dot_product as j_dot_product
from tpufhe.pipeline import make_add as j_make_add
from tpufhe.pipeline import make_ct_pt_dot as j_make_ct_pt_dot
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed

import tpufhe_torch.bfv as T
from tpufhe_torch import convert
from tpufhe_torch.errors import (
    InvalidCiphertext,
    NoMoreContext,
    ParametersError,
    TooFewValues,
    UnsupportedOperation,
)
from tpufhe_torch.ops import rq
from tpufhe_torch.ops.dot import ct_pt_dot_plain, dot_window
from tpufhe_torch.ops.rns import ScalingFactor
from tpufhe_torch.ops.rq import Context, Scaler
from tpufhe_torch.pipeline import make_add, make_ct_pt_dot, make_mul_relin
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

SIMD = (J.Encoding.simd(), T.Encoding.simd())


def _words(x):
    return convert.lanes_to_words(np.asarray(getattr(x, "coeffs", x)))


def _same(jct, tct):
    """Both ciphertexts have the same parts, word for word."""
    assert len(jct) == len(tct) and jct.level == tct.level
    for i in range(len(jct)):
        np.testing.assert_array_equal(_words(jct[i]), tct[i].numpy())


class Pair:
    """Parameters, keys, ciphertexts and plaintexts made by both packages
    from one seed (N = degree, 3 x 62-bit, t = 65537)."""

    def __init__(self, degree: int, seed: int, sizes=(62, 62, 62), t=65537):
        self.t = t
        self.jp = (J.BfvParametersBuilder().set_degree(degree)
                   .set_plaintext_modulus(t).set_moduli_sizes(list(sizes))
                   .build())
        self.tp = (T.BfvParametersBuilder().set_degree(degree)
                   .set_plaintext_modulus(t).set_moduli_sizes(list(sizes))
                   .set_device("cpu").build())
        self.jr, self.tr = JRng(j_seed(seed)), ChaCha8Rng(seed_from_u64(seed))
        self.jsk = J.SecretKey.random(self.jp, self.jr)
        self.tsk = T.SecretKey.random(self.tp, self.tr)
        self.jrk = J.RelinearizationKey.new(self.jsk, self.jr)
        self.trk = T.RelinearizationKey.new(self.tsk, self.tr)
        self.vals = np.random.default_rng(seed)
        self.va, self.vb = self.values(), self.values()
        self.ca = self.encrypt(self.va)
        self.cb = self.encrypt(self.vb)
        self.pb = self.encode(self.vb)

    def values(self):
        return self.vals.integers(0, self.t, self.tp.degree(), dtype=np.uint64)

    def encode(self, v, enc=SIMD):
        return (J.Plaintext.try_encode(v, enc[0], self.jp),
                T.Plaintext.try_encode(v, enc[1], self.tp))

    def encrypt(self, v):
        jpt, tpt = self.encode(v)
        return (self.jsk.try_encrypt(jpt, self.jr),
                self.tsk.try_encrypt(tpt, self.tr))

    def decrypt(self, jct, tct):
        """Both decryptions, checked equal; returns the slots."""
        got = self.tsk.try_decrypt(tct).try_decode(T.Encoding.simd())
        np.testing.assert_array_equal(
            np.asarray(self.jsk.try_decrypt(jct).try_decode(J.Encoding.simd())),
            got)
        return got

    def mod(self, x):
        return (x % self.t).astype(np.uint64)


@pytest.fixture(scope="module")
def pair():
    return Pair(16, 51)


def test_empty_ciphertext_is_the_identity_of_add_and_sub(pair):
    """Ciphertext.zero(par) + b is b, b + zero is b, zero - b is -b and
    b - zero is b, as tpufhe's ops.py:28-46; Ciphertext.new keeps the size
    check that the constructor used to make."""
    p = pair
    jz, tz = J.Ciphertext.zero(p.jp), T.Ciphertext.zero(p.tp)
    assert len(tz) == 0 and tz.level == 0
    (ja, ta), (jb, tb) = p.ca, p.cb
    _same(J.ct_add(jz, jb), T.ct_add(tz, tb))
    _same(J.ct_add(ja, jz), T.ct_add(ta, tz))
    _same(J.ct_sub(jz, jb), T.ct_sub(tz, tb))
    _same(J.ct_sub(ja, jz), T.ct_sub(ta, tz))
    assert all(torch.equal(x, y) for x, y in zip(T.ct_add(tz, tb).c, tb.c))
    assert all(torch.equal(x, y)
               for x, y in zip(T.ct_sub(tz, tb).c, T.ct_neg(tb).c))
    assert len(T.ct_add(tz, tz)) == 0 and len(tz + tz) == 0
    # a running sum from the empty ciphertext, as tpufhe's models start one
    acc = tz
    for c in (ta, tb):
        acc = acc + c
    np.testing.assert_array_equal(
        p.tsk.try_decrypt(acc).try_decode(T.Encoding.simd()),
        p.mod(p.va + p.vb))
    with pytest.raises(TooFewValues):
        T.Ciphertext.new([ta[0]], p.tp)
    with pytest.raises(InvalidCiphertext):
        T.Ciphertext.new([ta[0], ta[1][:1]], p.tp)
    ct = T.Ciphertext.new(list(ta.c), p.tp)
    assert len(ct) == 2 and ct.seed is None and ct.level == 0
    lower = [x[:2] for x in ta.c]  # the limbs of level 1's context
    assert T.Ciphertext.new(lower, p.tp).level == 1
    with pytest.raises(InvalidCiphertext):
        T.ct_add(ta, T.Ciphertext(p.tp, ta.c[:1], 0))


def test_clone_setitem_truncate(pair):
    ta = pair.ca[1]
    assert ta.seed is not None
    c = ta.clone()
    assert c.seed == ta.seed and c.c is not ta.c
    c[0] = ta[1]
    assert c.seed is None and ta.seed is not None
    c.truncate(1)
    assert len(c) == 1 and len(ta) == 2


@pytest.mark.parametrize("op", ["neg", "add", "sub", "add_pt", "sub_pt",
                                "mul_pt"])
def test_elementwise_ops_match_tpufhe(pair, op):
    p = pair
    (ja, ta), (jb, tb), (jpb, tpb) = p.ca, p.cb, p.pb
    va, vb = p.va.astype(object), p.vb.astype(object)
    j_op, t_op, want = {
        "neg": (lambda: J.ct_neg(ja), lambda: -ta, -va),
        "add": (lambda: J.ct_add(ja, jb), lambda: ta + tb, va + vb),
        "sub": (lambda: J.ct_sub(ja, jb), lambda: ta - tb, va - vb),
        "add_pt": (lambda: J.ct_add_pt(ja, jpb), lambda: ta + tpb, va + vb),
        "sub_pt": (lambda: J.ct_sub_pt(ja, jpb), lambda: ta - tpb, va - vb),
        "mul_pt": (lambda: J.ct_mul_pt(ja, jpb), lambda: ta * tpb, va * vb),
    }[op]
    jc, tc = j_op(), t_op()
    _same(jc, tc)
    np.testing.assert_array_equal(p.decrypt(jc, tc), p.mod(want))
    assert p.tsk.measure_noise(tc) == p.jsk.measure_noise(jc)


@pytest.mark.parametrize("kind", ["mul", "square", "3x2", "3x3"])
def test_ct_mul_matches_tpufhe(pair, kind):
    """Products to three parts (ct_mul, ct_square), and of a three-part
    operand (four parts, and the square branch to five), word for word and
    decrypted by both packages."""
    p = pair
    (ja, ta), (jb, tb) = p.ca, p.cb
    va, vb = p.va.astype(object), p.vb.astype(object)
    if kind == "mul":
        jc, tc, want = J.ct_mul(ja, jb), ta * tb, va * vb
    elif kind == "square":
        jc, tc, want = J.ct_square(ja), T.ct_square(ta), va * va
    else:
        j3, t3 = J.ct_mul(ja, jb), T.ct_mul(ta, tb)
        if kind == "3x2":
            jc, tc, want = J.ct_mul(j3, jb), T.ct_mul(t3, tb), va * vb * vb
        else:
            jc, tc = J.ct_mul(j3, j3), T.ct_mul(t3, t3.clone())
            want = (va * vb) ** 2
    assert len(tc) == {"mul": 3, "square": 3, "3x2": 4, "3x3": 5}[kind]
    _same(jc, tc)
    np.testing.assert_array_equal(p.decrypt(jc, tc), p.mod(want))
    assert p.tsk.measure_noise(tc) == p.jsk.measure_noise(jc)


def test_narrow_ops_match_tpufhe():
    """On a narrow (w30) set, 3 x 30-bit, t = 257: ct_mul to three parts
    (tensor32 and K9 on the card), relinearizes (K9 forward and
    ks_accumulate on int32 words), ct_mul_pt and ct_add_pt."""
    p = Pair(16, 52, sizes=(30, 30, 30), t=257)
    assert p.tp.context_at_level(0).narrow
    (ja, ta), (jb, tb), (jpb, tpb) = p.ca, p.cb, p.pb
    jc, tc = J.ct_mul(ja, jb), T.ct_mul(ta, tb)
    assert tc[0].dtype == torch.int32
    _same(jc, tc)
    p.jrk.relinearizes(jc)
    p.trk.relinearizes(tc)
    _same(jc, tc)
    va, vb = p.va.astype(object), p.vb.astype(object)
    np.testing.assert_array_equal(p.decrypt(jc, tc), p.mod(va * vb))
    _same(J.ct_mul_pt(ja, jpb), ta * tpb)
    _same(J.ct_add_pt(ja, jpb), ta + tpb)


@pytest.mark.parametrize("kp", [None, 1, 2])
def test_multiplicator_matches_tpufhe_and_make_mul_relin(pair, kp):
    p = pair
    (ja, ta), (jb, tb) = p.ca, p.cb
    if kp is None:
        jm, tm = J.Multiplicator.default(p.jrk), T.Multiplicator.default(p.trk)
    else:
        jm = J.Multiplicator.strategy2(p.jrk, kp)
        tm = T.Multiplicator.strategy2(p.trk, kp)
    assert tm.mul_ctx.moduli == tuple(jm.mul_ctx.moduli)
    jc, tc = jm.multiply(ja, jb), tm.multiply(ta, tb)
    assert len(tc) == 2
    _same(jc, tc)
    w0, w1 = make_mul_relin(p.tp, p.trk, strategy2_primes=kp)(
        ta[0], ta[1], tb[0], tb[1])
    assert torch.equal(tc[0], w0) and torch.equal(tc[1], w1)
    np.testing.assert_array_equal(p.decrypt(jc, tc),
                                  p.mod(p.va.astype(object) * p.vb))


def test_multiplicator_refusals(pair):
    p = pair
    m = T.Multiplicator.default(p.trk)
    jm = J.Multiplicator.default(p.jrk)
    # mod switching: the product is switched one level down, as tpufhe's
    jm.enable_mod_switching()
    m.enable_mod_switching()
    (ja, ta), (jb, tb) = p.ca, p.cb
    switched = m.multiply(ta, tb)
    assert switched.level == 1
    _same(jm.multiply(ja, jb), switched)
    np.testing.assert_array_equal(p.decrypt(jm.multiply(ja, jb), switched),
                                  p.mod(p.va.astype(object) * p.vb))
    one = T.BfvParametersBuilder().set_degree(16).set_plaintext_modulus(
        65537).set_moduli_sizes([62]).set_device("cpu").build()
    m1 = T.Multiplicator(ScalingFactor.one(), ScalingFactor.one(),
                         list(one.moduli) + [p.tp.moduli[1]],
                         ScalingFactor(65537, one.moduli[0]), one)
    with pytest.raises(NoMoreContext):
        m1.enable_mod_switching()
    with pytest.raises(InvalidCiphertext):
        m.multiply(T.ct_mul(p.ca[1], p.cb[1]), p.cb[1])
    narrow = T.BfvParametersBuilder().set_degree(16).set_plaintext_modulus(
        257).set_moduli_sizes([30, 30]).set_device("cpu").build()
    with pytest.raises(UnsupportedOperation, match="narrow"):
        T.Multiplicator(ScalingFactor.one(), ScalingFactor.one(),
                        [1 << 62], ScalingFactor.one(), narrow)


@pytest.fixture(scope="module")
def dots(pair):
    """29 ciphertexts and 29 x 3 SIMD plaintexts of both packages."""
    p = pair
    cts = [p.encrypt(p.values()) for _ in range(29)]
    vals = [p.tsk.try_decrypt(c[1]).try_decode(T.Encoding.simd())
            for c in cts]
    ws = [[p.values() for _ in range(3)] for _ in range(29)]
    pts = [[p.encode(w) for w in row] for row in ws]
    return cts, vals, ws, pts


@pytest.mark.parametrize("n", [1, 14, 15, 29])
def test_dot_product_scalar_matches_tpufhe(pair, dots, n):
    p = pair
    cts, vals, ws, pts = dots
    jd = J.dot_product_scalar([c[0] for c in cts[:n]],
                              [row[0][0] for row in pts[:n]])
    td = T.dot_product_scalar([c[1] for c in cts[:n]],
                              [row[0][1] for row in pts[:n]])
    _same(jd, td)
    want = sum(vals[i].astype(object) * ws[i][0] for i in range(n))
    np.testing.assert_array_equal(p.decrypt(jd, td), p.mod(want))


def test_dot_product_scalar_three_parts_and_refusals(pair, dots):
    p = pair
    cts, vals, ws, pts = dots
    j3 = [J.ct_mul(c[0], c[0]) for c in cts[:3]]
    t3 = [T.ct_mul(c[1], c[1]) for c in cts[:3]]
    _same(J.dot_product_scalar(j3, [row[1][0] for row in pts[:3]]),
          T.dot_product_scalar(t3, [row[1][1] for row in pts[:3]]))
    with pytest.raises(TooFewValues):
        T.dot_product_scalar([], [])
    narrow = T.BfvParametersBuilder().set_degree(16).set_plaintext_modulus(
        257).set_moduli_sizes([30, 30]).set_device("cpu").build()
    ctx = narrow.context_at_level(0)
    z = torch.zeros((ctx.k, 16), dtype=torch.int32)
    with pytest.raises(UnsupportedOperation, match="narrow"):
        rq.dot_product(ctx, [z], [z])


@pytest.mark.parametrize("n", [1, 14, 15, 29])
def test_rq_dot_product_matches_tpufhe(pair, dots, n):
    """Poly-level: ciphertext parts against plaintext polynomials (one
    (k, N) each), and batched rows of the same shape on both sides."""
    p = pair
    cts, _, _, pts = dots
    ps = [c[0][0] for c in cts[:n]]
    qs = [row[0][0].poly_ntt for row in pts[:n]]
    want = _words(j_dot_product(ps, qs))
    got = rq.dot_product(p.tp.context_at_level(0), [c[1][0] for c in cts[:n]],
                         [row[0][1].poly_ntt for row in pts[:n]])
    np.testing.assert_array_equal(want, got.numpy())
    ctx = p.tp.context_at_level(0)
    jctx = p.jp.context_at_level(0)
    jb = [Poly(jctx, NTT, np.stack([np.asarray(c[0][0].coeffs),
                                    np.asarray(c[0][1].coeffs)]))
          for c in cts[:n]]
    tb = [torch.stack([c[1][0], c[1][1]]) for c in cts[:n]]
    want = _words(j_dot_product(jb, jb[::-1]))
    np.testing.assert_array_equal(want,
                                  rq.dot_product(ctx, tb, tb[::-1]).numpy())


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("n", [1, 14, 15, 29])
def test_make_ct_pt_dot_matches_tpufhe(pair, dots, n, m):
    """(e0, e1) of 29 rows and batch 1 against (n, m) plaintexts: the
    port's program equals tpufhe's, run eagerly, and each column
    decrypts to its dot product."""
    p = pair
    cts, vals, ws, pts = dots
    je = [np.stack([np.asarray(c[0][i].coeffs)[None] for c in cts])
          for i in (0, 1)]
    jdb = np.stack([np.stack([np.asarray(pts[i][j][0].poly_ntt.coeffs)
                              for j in range(m)]) for i in range(n)])
    with jax.disable_jit():
        w0, w1 = j_make_ct_pt_dot(p.jp, n, m)(*je, jdb)
    te = [torch.stack([c[1][i] for c in cts])[:, None] for i in (0, 1)]
    tdb = torch.stack([torch.stack([pts[i][j][1].poly_ntt for j in range(m)])
                       for i in range(n)])
    r0, r1 = make_ct_pt_dot(p.tp, n, m)(*te, tdb)
    assert r0.shape == (m, 1, 3, 16)
    np.testing.assert_array_equal(_words(w0), r0.numpy())
    np.testing.assert_array_equal(_words(w1), r1.numpy())
    for j in range(m):
        ct = T.Ciphertext(p.tp, [r0[j, 0], r1[j, 0]], 0)
        want = sum(vals[i].astype(object) * ws[i][j] for i in range(n))
        np.testing.assert_array_equal(
            p.tsk.try_decrypt(ct).try_decode(T.Encoding.simd()), p.mod(want))


def test_make_ct_pt_dot_refuses_narrow_parameters():
    narrow = T.BfvParametersBuilder().set_degree(16).set_plaintext_modulus(
        257).set_moduli_sizes([30, 30]).set_device("cpu").build()
    with pytest.raises(NotImplementedError):
        make_ct_pt_dot(narrow, 2, 1)


@pytest.mark.parametrize("n", [15, 29])
def test_plain_ct_pt_dot_at_n8192_matches_tpufhe(n):
    """The plain version at the dot bench's degree over 3 limbs of 62 bits
    (a window of 14 terms, so 15 and 29 cross one and two reductions),
    every row p - 1 in its first term, against tpufhe's program."""
    moduli = T.BfvParametersBuilder.generate_moduli([62] * 3, 8192)
    jp = (J.BfvParametersBuilder().set_degree(8192).set_plaintext_modulus(65537)
          .set_moduli(moduli).build())
    tp = (T.BfvParametersBuilder().set_degree(8192).set_plaintext_modulus(65537)
          .set_moduli(moduli).set_device("cpu").build())
    ctx = tp.context_at_level(0)
    assert dot_window(ctx) == 14
    rng = np.random.default_rng(n)

    def residues(shape):
        x = np.stack([rng.integers(0, q, shape + (8192,), dtype=np.uint64)
                      for q in moduli], axis=-2)
        x[0] = np.array(moduli, np.uint64)[:, None] - 1
        return x.astype(np.int64)

    e0, e1 = residues((n, 1)), residues((n, 1))
    db = residues((n, 1))
    with jax.disable_jit():
        w0, w1 = j_make_ct_pt_dot(jp, n, 1)(
            convert.words_to_lanes(e0), convert.words_to_lanes(e1),
            convert.words_to_lanes(db))
    got = ct_pt_dot_plain(ctx, [torch.from_numpy(e0), torch.from_numpy(e1)],
                          torch.from_numpy(db))
    np.testing.assert_array_equal(_words(w0), got[0].numpy())
    np.testing.assert_array_equal(_words(w1), got[1].numpy())


def test_make_add_matches_tpufhe(pair):
    p = pair
    (ja, ta), (jb, tb) = p.ca, p.cb
    w = j_make_add(p.jp)(ja[0].coeffs, ja[1].coeffs, jb[0].coeffs, jb[1].coeffs)
    got = make_add(p.tp)(ta[0], ta[1], tb[0], tb[1])
    for x, y in zip(w, got):
        np.testing.assert_array_equal(_words(x), y.numpy())


@pytest.mark.parametrize("ntt", [False, True])
@pytest.mark.parametrize("kind", ["extend", "rhs", "down"])
def test_scaler_scale_matches_tpufhe(kind, ntt):
    """Scaler.scale on (2, k, N) rows in either form: the default extend
    (three common moduli copied), strategy 2's P/q into every limb and the
    t/q down-scale, against tpufhe's Scaler.scale on the same rows."""
    n = 64
    basis = T.BfvParametersBuilder.generate_moduli([62] * 5, n)
    small, big = basis[:3], basis
    frm, to = (big, small) if kind == "down" else (small, big)
    p_prod = basis[3] * basis[4]
    q = small[0] * small[1] * small[2]
    factor = {"extend": (1, 1), "rhs": (p_prod, q), "down": (65537, q)}[kind]
    jsc = JScaler(JContext(tuple(frm), n), JContext(tuple(to), n),
                  JScalingFactor(*factor))
    tsc = Scaler(Context(frm, n, "cpu"), Context(to, n, "cpu"),
                 ScalingFactor(*factor))
    assert tsc.number_common_moduli == jsc.number_common_moduli
    rng = np.random.default_rng(7)
    x = np.stack([rng.integers(0, m, (2, n), dtype=np.uint64) for m in frm],
                 axis=-2).astype(np.int64)
    jx = Poly(jsc.from_ctx, NTT if ntt else POWER_BASIS,
              convert.words_to_lanes(x))
    want = _words(jsc.scale(jx))
    got = tsc.scale(torch.from_numpy(x), ntt=ntt)
    assert got.shape == (2, len(to), n)
    np.testing.assert_array_equal(want, got.numpy())


def test_plaintext_poly_ntt_zero_and_codecs(pair):
    p = pair
    jpt, tpt = p.pb
    np.testing.assert_array_equal(_words(jpt.poly_ntt), tpt.poly_ntt.numpy())
    for enc in SIMD, (J.Encoding.poly(), T.Encoding.poly()):
        jz, tz = J.Plaintext.zero(enc[0], p.jp), T.Plaintext.zero(enc[1], p.tp)
        np.testing.assert_array_equal(_words(jz.poly_ntt), tz.poly_ntt.numpy())
        assert tz == T.Plaintext(p.tp, np.zeros(16, np.uint64), enc[1], 0)
    signed = np.arange(-8, 8, dtype=np.int64) * 1000
    jpt = J.Plaintext.try_encode_i64(signed, J.Encoding.simd(), p.jp)
    tpt = T.Plaintext.try_encode_i64(signed, T.Encoding.simd(), p.tp)
    np.testing.assert_array_equal(np.asarray(jpt.value), tpt.value)
    np.testing.assert_array_equal(tpt.try_decode_i64(), signed)
    np.testing.assert_array_equal(jpt.try_decode_i64(), tpt.try_decode_i64())
    # a plaintext built from its value alone forms the same poly_ntt
    bare = convert.plaintext(p.tp, jpt.value, jpt.encoding, jpt.level)
    assert bare == tpt
    np.testing.assert_array_equal(_words(jpt.poly_ntt), bare.poly_ntt.numpy())


@pytest.mark.parametrize("encoding", ["poly", "simd"])
def test_plaintext_vec_matches_tpufhe(pair, encoding):
    p = pair
    values = p.vals.integers(0, p.t, 40).tolist()
    jv = J.PlaintextVec.try_encode(values, getattr(J.Encoding, encoding)(),
                                   p.jp)
    tv = T.PlaintextVec.try_encode(values, getattr(T.Encoding, encoding)(),
                                   p.tp)
    assert len(tv) == len(jv) == 3
    for jpt, tpt in zip(jv, tv):
        np.testing.assert_array_equal(np.asarray(jpt.value), tpt.value)
        np.testing.assert_array_equal(_words(jpt.poly_ntt),
                                      tpt.poly_ntt.numpy())
    assert len(T.PlaintextVec.try_encode([], T.Encoding.poly(), p.tp)) == 1


@pytest.mark.parametrize("nbits", [20, 30])
def test_default_parameters_128_match_tpufhe(nbits):
    jsets = J.BfvParameters.default_parameters_128(nbits)
    tsets = T.BfvParameters.default_parameters_128(nbits, device="cpu")
    assert [(p.degree(), p.moduli, p.plaintext_value(),
             p.context_at_level(0).narrow) for p in tsets] == [
        (p.degree(), tuple(p.moduli), p.plaintext_value(),
         p.context_at_level(0).narrow) for p in jsets]
    # N = 1024 (one 27-bit modulus, narrow) holds 20-bit plaintexts only
    assert [p.degree() for p in tsets][:2] == ([1024, 2048] if nbits == 20
                                              else [2048, 4096])
    assert tsets[0].context_at_level(0).narrow == (nbits == 20)
    # no set holds a 63-bit plaintext modulus: both raise ParametersError
    with pytest.raises(JParametersError) as j_err:
        J.BfvParameters.default_parameters_128(63)
    with pytest.raises(ParametersError) as t_err:
        T.BfvParameters.default_parameters_128(63, device="cpu")
    assert str(t_err.value) == str(j_err.value)


def test_level_of_context(pair):
    tp = pair.tp
    for level in range(tp.max_level() + 1):
        assert tp.level_of_context(tp.context_at_level(level)) == level
    assert tp.plaintext_value() == 65537
