"""Host-side parity of tpufhe_torch with tpufhe: moduli, NTT tables, primes,
the ChaCha8 / seed / CBD streams, the HPS scaler tables and the BFV
parameter chain; plus the plain int64 modular ops against Python ints."""

import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe.ops.ntt import NttOperator as JNtt
from tpufhe.ops.zq import Modulus as JModulus
from tpufhe.utils import primes as jprimes
from tpufhe.utils import rngs as jrngs
from tpufhe.utils.sampling import sample_vec_cbd as j_cbd

import tpufhe_torch.bfv as T
from tpufhe_torch.ops import zq
from tpufhe_torch.ops.ntt import NttOperator
from tpufhe_torch.ops.zq import ModTable, Modulus
from tpufhe_torch.utils import primes, rngs
from tpufhe_torch.utils.sampling import sample_vec_cbd

SIZES = [62, 62, 62]


def _moduli(n):
    return J.BfvParametersBuilder.generate_moduli(SIZES, n)


def test_modulus_constants():
    for p in _moduli(8192) + [65537, 1153, 0x7E00001, 3]:
        a, b = JModulus(p), Modulus(p)
        assert (a.p, a.barrett_hi, a.barrett_lo, a.leading_zeros,
                a.supports_opt) == (b.p, b.barrett_hi, b.barrett_lo,
                                    b.leading_zeros, b.supports_opt)
        assert a.inv(5 % p or 1) == b.inv(5 % p or 1)
        assert a.shoup(p - 1) == b.shoup(p - 1)


@pytest.mark.parametrize("n", [16, 1024, 8192, 16384])
def test_ntt_tables(n):
    for p in _moduli(n):
        a, b = JNtt.new(JModulus(p), n), NttOperator.new(Modulus(p), n)
        for name in ("omegas", "omegas_shoup", "zetas_inv", "zetas_inv_shoup"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert (a.size_inv, a.size_inv_shoup) == (b.size_inv, b.size_inv_shoup)


def test_primes():
    for bits, mod, upper in [(62, 16384, 1 << 62), (30, 2048, 1 << 30),
                             (17, 2 * 8192, 1 << 17), (40, 64, (1 << 40) - 5)]:
        assert primes.generate_prime(bits, mod, upper) == \
            jprimes.generate_prime(bits, mod, upper)
    for x in [2, 65537, (1 << 61) - 1, (1 << 62) - 57, 1 << 40, 561]:
        assert primes.is_prime(x) == jprimes.is_prime(x)
        assert primes.supports_opt(x) == jprimes.supports_opt(x)


def test_chacha_streams():
    for seed in [0, 1, 2026, (1 << 64) - 1]:
        assert rngs.seed_from_u64(seed) == jrngs.seed_from_u64(seed)
        a = jrngs.ChaCha8Rng(jrngs.seed_from_u64(seed))
        b = rngs.ChaCha8Rng(rngs.seed_from_u64(seed))
        assert a.fill_bytes(37) == b.fill_bytes(37)
        assert [a.next_u64() for _ in range(50)] == [b.next_u64() for _ in range(50)]
        assert a.fill_bytes(200) == b.fill_bytes(200)
        p = (1 << 62) - 57
        np.testing.assert_array_equal(jrngs.uniform_u64_below(a, p, 300),
                                      rngs.uniform_u64_below(b, p, 300))
        assert [jrngs.random_range_u64(a, p) for _ in range(20)] == \
            [rngs.random_range_u64(b, p) for _ in range(20)]
        np.testing.assert_array_equal(j_cbd(1000, 10, a), sample_vec_cbd(1000, 10, b))
        np.testing.assert_array_equal(j_cbd(77, 3, a), sample_vec_cbd(77, 3, b))
        assert a.fill_bytes(64) == b.fill_bytes(64)
        assert jrngs.expand_seed(b"x" * 32).fill_bytes(48) == \
            rngs.expand_seed(b"x" * 32).fill_bytes(48)


@pytest.fixture(scope="module")
def params():
    jp = (J.BfvParametersBuilder().set_degree(8192).set_plaintext_modulus(65537)
          .set_moduli_sizes(SIZES).build())
    tp = (T.BfvParametersBuilder().set_degree(8192).set_plaintext_modulus(65537)
          .set_moduli_sizes(SIZES).set_device("cpu").build())
    return jp, tp


def test_parameters(params):
    jp, tp = params
    assert tp.moduli == jp.moduli
    assert tp.moduli_sizes == jp.moduli_sizes
    assert (T.BfvParametersBuilder().set_degree(8192).set_plaintext_modulus(65537)
            .set_moduli(jp.moduli).set_device("cpu").build()) == tp
    np.testing.assert_array_equal(tp.matrix_reps_index_map,
                                  jp.matrix_reps_index_map)
    assert tp.ntt_operator.moduli == jp.ntt_operator.moduli
    for lvl in range(3):
        a, b = jp.context_level_at(lvl), tp.context_level_at(lvl)
        assert a.poly_context.moduli == b.poly_context.moduli
        ca, cb = a.cipher_plain_context, b.cipher_plain_context
        assert ca.q_mod_t == cb.q_mod_t
        assert ca.plain_threshold == cb.plain_threshold
        assert ca.plaintext_context.moduli == cb.plaintext_context.moduli
        # delta is the constant polynomial: its NTT form is one value a limb
        d = np.asarray(ca.delta.coeffs)[:, :, 0, 0].astype(np.uint64)
        want = d[:, 0] | (d[:, 1] << np.uint64(32))
        np.testing.assert_array_equal(want.astype(np.int64),
                                      cb.delta[:, 0].numpy())
    mj, mt = jp.context_level_at(0).mul_params(), tp.context_level_at(0).mul_params()
    assert len(mt.to_ctx.moduli) == 7
    assert mt.to_ctx.moduli == mj.to_ctx.moduli
    assert mt.extender.number_common_moduli == mj.extender.number_common_moduli


def _same_scaler(a, b):
    for name in ("gamma", "gamma_shoup", "theta_gamma", "theta_gamma_sign",
                 "theta_omega", "theta_omega_sign", "omega", "omega_shoup",
                 "theta_garner", "theta_garner_shift"):
        assert getattr(a, name) == getattr(b, name), name


def test_scaler_tables(params):
    jp, tp = params
    mj, mt = jp.context_level_at(0).mul_params(), tp.context_level_at(0).mul_params()
    _same_scaler(mj.extender.rns_scaler, mt.extender.rns_scaler)
    _same_scaler(mj.down_scaler.rns_scaler, mt.down_scaler.rns_scaler)
    _same_scaler(jp.context_level_at(0).cipher_plain_context.scaler.rns_scaler,
                 tp.context_level_at(0).cipher_plain_context.scaler.rns_scaler)


@pytest.mark.parametrize("p", [2, 3, 65537, 1153, (1 << 61) - 1,
                               (1 << 62) - 57, 0x7E00001])
def test_plain_modular_ops(p):
    rng = np.random.default_rng(p % 1000)
    a = rng.integers(0, p, 4000, dtype=np.uint64)
    b = rng.integers(0, p, 4000, dtype=np.uint64)
    a[:4] = [0, p - 1, p - 1, 1]
    b[:4] = [p - 1, p - 1, 0, p - 1]
    m = ModTable([p], "cpu", (1,))
    ta, tb = (torch.from_numpy(x.astype(np.int64)) for x in (a, b))
    ai, bi = [int(x) for x in a], [int(x) for x in b]

    def check(got, want):
        np.testing.assert_array_equal(got.numpy(), np.array(want, dtype=np.int64))

    check(zq.add(ta, tb, m), [(x + y) % p for x, y in zip(ai, bi)])
    check(zq.sub(ta, tb, m), [(x - y) % p for x, y in zip(ai, bi)])
    check(zq.neg(ta, m), [(-x) % p for x in ai])
    check(zq.mul(ta, tb, m), [(x * y) % p for x, y in zip(ai, bi)])
    bs = torch.from_numpy(zq.as_int64(np.array(
        [(y << 64) // p for y in bi], dtype=np.uint64)))
    check(zq.mul_shoup(ta, tb, bs, m), [(x * y) % p for x, y in zip(ai, bi)])
    digits = [torch.from_numpy(rng.integers(0, 1 << 31, 4000)) for _ in range(5)]
    want = [sum(int(d[i]) << (31 * j) for j, d in enumerate(digits)) % p
            for i in range(4000)]
    check(zq.mod_of_digits(digits, m), want)


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = (T.BfvParametersBuilder().set_degree(16).set_plaintext_modulus(1153)
            .set_moduli_sizes([62, 62]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spec.build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.BfvParameters.default(2, 16)
    assert spec.set_device("cpu").build().device.type == "cpu"
