"""The port's keygen -> encrypt -> mul+relin -> decrypt path against tpufhe.

Given the same ChaCha8 seed both packages must produce the same secret key,
relinearization key (values and Shoup constants) and ciphertext integers;
the port's make_mul_relin must equal tpufhe's fused pipeline (degree 16,
eager, as tests/test_pipeline.py runs it) and tpufhe's object API
(ct_mul + relinearizes) at degree 256; the product must decrypt to
va * vb mod t under both packages' secret keys, and measure_noise agree.
"""

import jax
import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe.ops.rq import NTT, Poly
from tpufhe.pipeline import make_mul_relin as j_make_mul_relin
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed

import tpufhe_torch.bfv as T
from tpufhe_torch import convert
from tpufhe_torch.pipeline import make_mul_relin
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64


def _words(poly):
    return convert.lanes_to_words(np.asarray(poly.coeffs))


class Pair:
    """The same keys and ciphertexts, made by both packages from one seed."""

    def __init__(self, degree: int, seed: int):
        self.jp = (J.BfvParametersBuilder().set_degree(degree)
                   .set_plaintext_modulus(65537).set_moduli_sizes([62] * 3)
                   .build())
        self.tp = (T.BfvParametersBuilder().set_degree(degree)
                   .set_plaintext_modulus(65537).set_moduli_sizes([62] * 3)
                   .set_device("cpu").build())
        self.jr, self.tr = JRng(j_seed(seed)), ChaCha8Rng(seed_from_u64(seed))
        self.jsk = J.SecretKey.random(self.jp, self.jr)
        self.tsk = T.SecretKey.random(self.tp, self.tr)
        self.jrk = J.RelinearizationKey.new(self.jsk, self.jr)
        self.trk = T.RelinearizationKey.new(self.tsk, self.tr)
        t = self.jp.plaintext.value
        vals = np.random.default_rng(seed)
        self.va = vals.integers(0, t, degree, dtype=np.uint64)
        self.vb = vals.integers(0, t, degree, dtype=np.uint64)
        self.jca, self.tca = self.encrypt(self.va)
        self.jcb, self.tcb = self.encrypt(self.vb)
        self.want = ((self.va.astype(object) * self.vb.astype(object)) % t
                     ).astype(np.uint64)

    def encrypt(self, v):
        jc = self.jsk.try_encrypt(
            J.Plaintext.try_encode(v, J.Encoding.simd(), self.jp), self.jr)
        tc = self.tsk.try_encrypt(
            T.Plaintext.try_encode(v, T.Encoding.simd(), self.tp), self.tr)
        return jc, tc

    def port_product(self):
        fn = make_mul_relin(self.tp, self.trk)
        return fn(self.tca[0], self.tca[1], self.tcb[0], self.tcb[1])


@pytest.fixture(scope="module")
def pair16():
    return Pair(16, 41)


def test_same_seed_same_keys_and_ciphertexts(pair16):
    p = pair16
    np.testing.assert_array_equal(p.jsk.coeffs, p.tsk.coeffs)
    assert p.jrk.ksk.seed == p.trk.ksk.seed
    for name in ("c0", "c1"):
        for i, poly in enumerate(getattr(p.jrk.ksk, name)):
            np.testing.assert_array_equal(
                _words(poly), getattr(p.trk.ksk, name)[i].numpy())
            np.testing.assert_array_equal(
                convert.lanes_to_words(np.asarray(poly.coeffs_shoup)),
                getattr(p.trk.ksk, name + "_shoup")[i].numpy())
    for jc, tc in ((p.jca, p.tca), (p.jcb, p.tcb)):
        assert jc.seed == tc.seed
        for i in range(2):
            np.testing.assert_array_equal(_words(jc[i]), tc[i].numpy())


def test_mul_relin_matches_tpufhe_pipeline(pair16):
    p = pair16
    fn = j_make_mul_relin(p.jp, p.jrk)
    with jax.disable_jit():
        w0, w1 = fn(p.jca[0].coeffs, p.jca[1].coeffs,
                    p.jcb[0].coeffs, p.jcb[1].coeffs)
    c0, c1 = p.port_product()
    np.testing.assert_array_equal(convert.lanes_to_words(np.asarray(w0)),
                                  c0.numpy())
    np.testing.assert_array_equal(convert.lanes_to_words(np.asarray(w1)),
                                  c1.numpy())


def test_product_decrypts_under_both_keys(pair16):
    p = pair16
    c0, c1 = p.port_product()
    tct = T.Ciphertext(p.tp, [c0, c1], 0)
    got = p.tsk.try_decrypt(tct).try_decode(T.Encoding.simd())
    np.testing.assert_array_equal(got, p.want)
    ctx = p.jp.context_at_level(0)
    jct = J.Ciphertext(p.jp, [Poly(ctx, NTT, convert.from_tensor(c0)),
                              Poly(ctx, NTT, convert.from_tensor(c1))], 0)
    got = np.asarray(p.jsk.try_decrypt(jct).try_decode(J.Encoding.simd()))
    np.testing.assert_array_equal(got, p.want)
    assert p.tsk.measure_noise(p.tca) == p.jsk.measure_noise(p.jca)
    assert p.tsk.measure_noise(tct) == p.jsk.measure_noise(jct)


def test_keys_carried_across_by_convert(pair16):
    """tpufhe's keys and ciphertexts, converted, drive the port's path to
    the same product as the port's own keys."""
    p = pair16
    sk = convert.secret_key(p.jsk.coeffs, p.tp)
    ksk = p.jrk.ksk
    rk = convert.relinearization_key(
        p.tp, ksk.seed,
        [np.asarray(poly.coeffs) for poly in ksk.c0],
        [np.asarray(poly.coeffs_shoup) for poly in ksk.c0],
        [np.asarray(poly.coeffs) for poly in ksk.c1],
        [np.asarray(poly.coeffs_shoup) for poly in ksk.c1])
    ca, cb = (convert.ciphertext(p.tp, [np.asarray(jc[i].coeffs) for i in (0, 1)],
                                 seed=jc.seed) for jc in (p.jca, p.jcb))
    for a, b in ((ca, p.tca), (cb, p.tcb)):
        assert a.seed == b.seed
        assert all(torch.equal(a[i], b[i]) for i in (0, 1))
    c0, c1 = make_mul_relin(p.tp, rk)(ca[0], ca[1], cb[0], cb[1])
    w0, w1 = p.port_product()
    assert torch.equal(c0, w0) and torch.equal(c1, w1)
    got = sk.try_decrypt(T.Ciphertext(p.tp, [c0, c1], 0)).try_decode(
        T.Encoding.simd())
    np.testing.assert_array_equal(got, p.want)


def test_mul_relin_matches_object_api_at_degree_256():
    p = Pair(256, 43)
    want = J.ct_mul(p.jca, p.jcb)
    p.jrk.relinearizes(want)
    c0, c1 = p.port_product()
    np.testing.assert_array_equal(_words(want[0]), c0.numpy())
    np.testing.assert_array_equal(_words(want[1]), c1.numpy())
    got = p.tsk.try_decrypt(T.Ciphertext(p.tp, [c0, c1], 0)).try_decode(
        T.Encoding.simd())
    np.testing.assert_array_equal(got, p.want)
