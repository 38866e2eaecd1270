"""The port's remaining key operations against tpufhe, bit-exact (tolerance
0), on keys and ciphertexts made by both packages from one ChaCha8 seed:

- decryption and measure_noise of ciphertexts of 1, 3 and 4 parts;
- PublicKey.new and PublicKey.try_encrypt (the u, e1, e2 draws and the
  make_pk_encrypt program), and a key carried across by convert;
- the single-modulus (k == 1) key-switching key: its log_base, rows, seed
  and Shoup constants, key_switch, RelinearizationKey.relinearizes and a
  Galois key on it, on a 62-bit modulus and on a narrow 27-bit one (the
  default N = 1024 set's modulus), and the key carried across by convert;
- the Garner key's key_switch and relinearizes_poly, and relinearizes on
  the fused route (K5 and one add) and the unfused one (forced with
  kernels.tail_fits, K1 + ks_accumulate), both equal to tpufhe's.

At degree 16, where tpufhe's object API compiles quickly on the CPU.
"""

import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe.ops.rq import Poly
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed

import tpufhe_torch.bfv as T
from tpufhe_torch import convert, kernels
from tpufhe_torch.errors import (
    InvalidCiphertext,
    InvalidLevel,
    TooFewValues,
    UnsupportedOperation,
)
from tpufhe_torch.ops.rq import from_i64_coeffs, ntt_backward
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64


def _words(x):
    return convert.lanes_to_words(np.asarray(getattr(x, "coeffs", x)))


def _same(jct, tct):
    assert len(jct) == len(tct) and jct.level == tct.level
    for i in range(len(jct)):
        np.testing.assert_array_equal(_words(jct[i]), tct[i].numpy())


def _same_ksk(jk, tk):
    assert jk.seed == tk.seed and jk.log_base == tk.log_base
    for name in ("c0", "c1"):
        rows = getattr(jk, name)
        assert getattr(tk, name).shape[0] == len(rows)
        for i, poly in enumerate(rows):
            np.testing.assert_array_equal(_words(poly),
                                          getattr(tk, name)[i].numpy())
            np.testing.assert_array_equal(
                _words(poly.coeffs_shoup),
                getattr(tk, name + "_shoup")[i].numpy())


class Keys:
    """Secret keys, values and ciphertexts of both packages from one seed."""

    def __init__(self, seed, t=65537, sizes=None, moduli=None, degree=16):
        def build(builder):
            b = builder().set_degree(degree).set_plaintext_modulus(t)
            return b.set_moduli(moduli) if moduli else b.set_moduli_sizes(sizes)

        self.t = t
        self.jp = build(J.BfvParametersBuilder).build()
        self.tp = build(T.BfvParametersBuilder).set_device("cpu").build()
        self.jr, self.tr = JRng(j_seed(seed)), ChaCha8Rng(seed_from_u64(seed))
        self.jsk = J.SecretKey.random(self.jp, self.jr)
        self.tsk = T.SecretKey.random(self.tp, self.tr)
        vals = np.random.default_rng(seed)
        self.va = vals.integers(0, t, degree, dtype=np.uint64)
        self.vb = vals.integers(0, t, degree, dtype=np.uint64)
        self.ca, self.cb = self.encrypt(self.va), self.encrypt(self.vb)

    def encode(self, v):
        return (J.Plaintext.try_encode(v, J.Encoding.simd(), self.jp),
                T.Plaintext.try_encode(v, T.Encoding.simd(), self.tp))

    def encrypt(self, v):
        jpt, tpt = self.encode(v)
        return (self.jsk.try_encrypt(jpt, self.jr),
                self.tsk.try_encrypt(tpt, self.tr))

    def slots(self, tct):
        return self.tsk.try_decrypt(tct).try_decode(T.Encoding.simd())

    def product(self):
        return (self.va.astype(object) * self.vb % self.t).astype(np.uint64)

    def s2_key(self):
        """Key-switching keys from s^2 at level 0 of both packages."""
        jctx, tctx = self.jp.context_at_level(0), self.tp.context_at_level(0)
        js = Poly.from_i64_coeffs(self.jsk.coeffs, jctx).into_ntt()
        ts = self.tsk.s_ntt(tctx)
        return (J.KeySwitchingKey.new(self.jsk, (js * js).into_power_basis(),
                                      0, 0, self.jr),
                T.KeySwitchingKey.new(self.tsk,
                                      ntt_backward(tctx, tctx.mul(ts, ts)),
                                      0, 0, self.tr))


@pytest.fixture(scope="module")
def keys():
    return Keys(61, sizes=[62] * 3)


@pytest.mark.parametrize("parts", [1, 3, 4])
def test_decrypt_any_size_matches_tpufhe(keys, parts):
    """Decryption of 1, 3 and 4 parts (c0 + sum c_i s^i, then the t/q
    scaler) and the noise meter, against tpufhe's."""
    k = keys
    (ja, ta), (jb, tb) = k.ca, k.cb
    if parts == 1:
        jc = J.Ciphertext(k.jp, ja.c[:1], 0)
        tc = T.Ciphertext(k.tp, ta.c[:1], 0)
    else:
        jc, tc = J.ct_mul(ja, jb), T.ct_mul(ta, tb)
        if parts == 4:
            jc, tc = J.ct_mul(jc, jb), T.ct_mul(tc, tb)
    assert len(tc) == parts
    jpt, tpt = k.jsk.try_decrypt(jc), k.tsk.try_decrypt(tc)
    np.testing.assert_array_equal(np.asarray(jpt.value), tpt.value)
    np.testing.assert_array_equal(_words(jpt.poly_ntt), tpt.poly_ntt.numpy())
    assert k.tsk.measure_noise(tc) == k.jsk.measure_noise(jc)
    if parts == 3:
        np.testing.assert_array_equal(k.slots(tc), k.product())
    with pytest.raises(TooFewValues):
        k.tsk.try_decrypt(T.Ciphertext.zero(k.tp))


def test_public_key_matches_tpufhe(keys):
    k = keys
    jpk, tpk = J.PublicKey.new(k.jsk, k.jr), T.PublicKey.new(k.tsk, k.tr)
    _same(jpk.c, tpk.c)
    for v in (k.va, k.vb):
        jpt, tpt = k.encode(v)
        jc, tc = jpk.try_encrypt(jpt, k.jr), tpk.try_encrypt(tpt, k.tr)
        _same(jc, tc)
        np.testing.assert_array_equal(k.slots(tc), v)
        assert k.tsk.measure_noise(tc) == k.jsk.measure_noise(jc)
    # tpufhe's key carried across encrypts to the same words
    carried = convert.public_key(k.tp, [np.asarray(p.coeffs) for p in jpk.c])
    jpt, tpt = k.encode(k.va)
    state = ChaCha8Rng(seed_from_u64(7)), JRng(j_seed(7))
    _same(jpk.try_encrypt(jpt, state[1]), carried.try_encrypt(tpt, state[0]))
    pt1 = T.Plaintext.try_encode(k.va, T.Encoding.simd(1), k.tp)
    with pytest.raises(UnsupportedOperation, match="switch"):
        tpk.try_encrypt(pt1, k.tr)


# (label, t, moduli sizes or moduli): a 62-bit modulus (log_base 31, two
# digit rows) and the default N = 1024 set's 27-bit one, narrow (log_base
# 13, three rows)
SINGLE = [("62-bit", 65537, {"sizes": [62]}),
          ("narrow 27-bit", 257, {"moduli": [0x7E00001]})]


@pytest.mark.parametrize("label,t,mod", SINGLE)
def test_single_modulus_key_matches_tpufhe(label, t, mod):
    k = Keys(62, t=t, **mod)
    tctx = k.tp.context_at_level(0)
    assert tctx.k == 1 and tctx.narrow == (label != "62-bit")
    jk, tk = k.s2_key()
    assert tk.log_base == {"62-bit": 31, "narrow 27-bit": 13}[label]
    _same_ksk(jk, tk)
    # key_switch of a power-basis row, and the relinearization of a product
    (ja, ta), (jb, tb) = k.ca, k.cb
    jc, tc = J.ct_mul(ja, jb), T.ct_mul(ta, tb)
    _same(jc, tc)
    j2 = jc[2].into_power_basis()
    t2 = ntt_backward(tctx, tc[2])
    for x, y in zip(jk.key_switch(j2), tk.key_switch(t2)):
        np.testing.assert_array_equal(_words(x), y.numpy())
    J.RelinearizationKey(jk).relinearizes(jc)
    T.RelinearizationKey(tk).relinearizes(tc)
    _same(jc, tc)
    np.testing.assert_array_equal(k.slots(tc), k.product())
    with pytest.raises(UnsupportedOperation):
        T.RelinearizationKey.new(k.tsk, k.tr)
    # tpufhe's key carried across relinearizes to the same words
    tables = [[np.asarray(getattr(p, a)) for p in getattr(jk, c)]
              for c in ("c0", "c1") for a in ("coeffs", "coeffs_shoup")]
    carried = convert.key_switching_key(k.tp, jk.seed, *tables,
                                        log_base=jk.log_base)
    again = T.ct_mul(ta, tb)
    T.RelinearizationKey(carried).relinearizes(again)
    assert all(torch.equal(x, y) for x, y in zip(again.c, tc.c))


def test_single_modulus_galois_key_matches_tpufhe():
    """A column rotation on a k == 1 Galois key: the unfused tail on the
    key's base-2^31 digits."""
    k = Keys(63, sizes=[62])
    jg = J.GaloisKey.new(k.jsk, 3, 0, 0, k.jr)
    tg = T.GaloisKey.new(k.tsk, 3, 0, 0, k.tr)
    _same_ksk(jg.ksk, tg.ksk)
    _same(jg.relinearize(k.ca[0]), tg.relinearize(k.ca[1]))


@pytest.mark.parametrize("fused", [True, False])
def test_garner_relinearization_matches_tpufhe(keys, fused, monkeypatch):
    """relinearizes on K5's route (a Garner key where the tails fit) and on
    the unfused one (K1 forward + ks_accumulate), and key_switch /
    relinearizes_poly, against tpufhe's RelinearizationKey."""
    k = keys
    jrk, trk = (J.RelinearizationKey.new(k.jsk, JRng(j_seed(5))),
                T.RelinearizationKey.new(k.tsk, ChaCha8Rng(seed_from_u64(5))))
    _same_ksk(jrk.ksk, trk.ksk)
    if not fused:
        monkeypatch.setattr(kernels, "tail_fits", lambda n, word_bytes=8: False)
    (ja, ta), (jb, tb) = k.ca, k.cb
    jc, tc = J.ct_mul(ja, jb), T.ct_mul(ta, tb)
    tctx = k.tp.context_at_level(0)
    j2, t2 = jc[2].into_power_basis(), ntt_backward(tctx, tc[2])
    for x, y in zip(jrk.relinearizes_poly(j2), trk.relinearizes_poly(t2)):
        np.testing.assert_array_equal(_words(x), y.numpy())
    jrk.relinearizes(jc)
    trk.relinearizes(tc)
    _same(jc, tc)
    assert tc.seed is None
    np.testing.assert_array_equal(k.slots(tc), k.product())
    with pytest.raises(InvalidCiphertext):
        trk.relinearizes(tc)
    with pytest.raises(InvalidLevel):
        trk.relinearizes(T.Ciphertext(k.tp, list(T.ct_mul(ta, tb).c), 1))


def test_key_switch_refuses_other_contexts(keys):
    k = keys
    rk = T.RelinearizationKey.new(k.tsk, ChaCha8Rng(seed_from_u64(6)))
    wrong = from_i64_coeffs(k.tsk.coeffs, k.tp.context_at_level(1))
    with pytest.raises(ValueError):
        rk.ksk.key_switch(wrong)


def test_key_switch_refuses_a_key_below_the_ciphertext_level(keys):
    """A key at level 1 for level-0 ciphertexts needs the switch-down:
    key_switch and relinearizes_poly raise UnsupportedOperation, not a
    shape error."""
    k = keys
    ctx1 = k.tp.context_at_level(1)
    s = k.tsk.s_ntt(ctx1)
    ksk = T.KeySwitchingKey.new(k.tsk, ntt_backward(ctx1, ctx1.mul(s, s)),
                                0, 1, ChaCha8Rng(seed_from_u64(8)))
    c2 = from_i64_coeffs(k.tsk.coeffs, k.tp.context_at_level(0))
    with pytest.raises(UnsupportedOperation, match="switch-down"):
        ksk.key_switch(c2)
    with pytest.raises(UnsupportedOperation, match="switch-down"):
        T.RelinearizationKey(ksk).relinearizes_poly(c2)
