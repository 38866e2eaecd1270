"""The plain HPS scaler of tpufhe_torch (the CPU side of kernel K2) against
the exact Python-int scale_host at N = 1024 on random and adversarial
residues (the port's own, which tests/test_torch_names.py holds to
tpufhe's), and against tpufhe's jitted RnsScaler.scale at N = 8192, in the
three shapes of the main path (extend, t/q down-scale, decryption)."""

import jax
import numpy as np
import pytest
import torch

import tpufhe.bfv as J

import tpufhe_torch.bfv as T
from tpufhe_torch import convert

SIZES = [62, 62, 62]


def _params(n):
    jp = (J.BfvParametersBuilder().set_degree(n).set_plaintext_modulus(65537)
          .set_moduli_sizes(SIZES).build())
    tp = (T.BfvParametersBuilder().set_degree(n).set_plaintext_modulus(65537)
          .set_moduli_sizes(SIZES).set_device("cpu").build())
    return jp, tp


@pytest.fixture(scope="module")
def params_1024():
    return _params(1024)


@pytest.fixture(scope="module")
def params_8192():
    return _params(8192)


def _scalers(par):
    lvl = par.context_level_at(0)
    mp = lvl.mul_params()
    k, k_mul = lvl.poly_context.k, mp.to_ctx.k
    return {
        "extend": (mp.extender.rns_scaler, k, k_mul - k),
        "down": (mp.down_scaler.rns_scaler, 0, k),
        "decrypt": (lvl.cipher_plain_context.scaler.rns_scaler, 0,
                    lvl.cipher_plain_context.plaintext_context.k),
    }


def _inputs(scaler, rows, n, seed, adversarial):
    """(rows, k_in, n) residues; with `adversarial`, row 0 is all (p - 1)
    and row 1 holds values at and around 0, +-q/2 and q - 1."""
    moduli = scaler.from_ctx.moduli_u64
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, p, (rows, n), dtype=np.uint64)
                  for p in moduli], axis=1)
    if adversarial:
        q = scaler.from_ctx.product
        x[0] = np.array(moduli, dtype=np.uint64)[:, None] - 1
        specials = [0, 1, q - 1, q // 2 - 1, q // 2, q // 2 + 1, (q + 1) // 2,
                    q // 2 + 2, q // 4, 3 * q // 4, q // 3, 2 * q // 3]
        for c, v in enumerate(specials):
            x[1, :, c] = [v % p for p in moduli]
    return x.astype(np.int64)


@pytest.mark.parametrize("shape", ["extend", "down", "decrypt"])
def test_plain_scaler_matches_scale_host(params_1024, shape):
    _, tp = params_1024
    tsc, start, size = _scalers(tp)[shape]
    n = 1024
    x = _inputs(tsc, 3, n, 7, adversarial=True)
    got = tsc.scale(torch.from_numpy(x), start, size).numpy()
    assert got.shape == (3, size, n)
    for r in range(3):
        # every coefficient of the adversarial rows, a sample of the other
        cols = range(n) if r < 2 else range(0, n, 7)
        for c in cols:
            want = tsc.scale_host([int(v) for v in x[r, :, c]], size=size,
                                  starting_index=start)
            assert [int(v) for v in got[r, :, c]] == want, (shape, r, c)


@pytest.mark.parametrize("sizes,k_in", [([62] * 8, 17), ([30] * 8, 18)])
def test_plain_down_scale_above_16_limbs_matches_scale_host(sizes, k_in):
    """The t/q down-scales whose multiplication basis has more than 16
    limbs (8 x 62-bit, and the narrow 8 x 30-bit on int32 rows), which the
    card runs on K2's general instance."""
    n = 1024
    jp = (J.BfvParametersBuilder().set_degree(n).set_plaintext_modulus(65537)
          .set_moduli_sizes(sizes).build())
    tp = (T.BfvParametersBuilder().set_degree(n).set_plaintext_modulus(65537)
          .set_moduli_sizes(sizes).set_device("cpu").build())
    jsc, start, size = _scalers(jp)["down"]
    tsc, _, _ = _scalers(tp)["down"]
    assert tsc._k_in == k_in and tsc.theta_garner_shift == jsc.theta_garner_shift
    dtype = tp.context_at_level(0).dtype
    x = _inputs(tsc, 3, n, 13, adversarial=True)
    got = tsc.scale(torch.from_numpy(x).to(dtype), start, size)
    assert got.dtype == dtype and got.shape == (3, size, n)
    got = got.numpy()
    for r in range(3):
        for c in (range(n) if r < 2 else range(0, n, 7)):
            want = tsc.scale_host([int(v) for v in x[r, :, c]], size=size,
                                  starting_index=start)
            assert [int(v) for v in got[r, :, c]] == want, (r, c)


@pytest.mark.parametrize("shape", ["extend", "down", "decrypt"])
def test_plain_scaler_matches_tpufhe_scale(params_8192, shape):
    jp, tp = params_8192
    jsc, start, size = _scalers(jp)[shape]
    tsc, _, _ = _scalers(tp)[shape]
    x = _inputs(tsc, 2, 8192, 11, adversarial=True)
    want = jax.jit(lambda a: jsc.scale(a, starting_index=start, size=size))(
        convert.words_to_lanes(x))
    got = tsc.scale(torch.from_numpy(x), start, size)
    np.testing.assert_array_equal(convert.lanes_to_words(np.asarray(want)),
                                  got.numpy())
