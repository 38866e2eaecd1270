"""The plain versions of kernels K3 (tensor + iNTT), K4 (relin tail) and K5
(rotate tail) against the XLA composition they replace in tpufhe's
pipeline, at N = 1024, word for word."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe import pipeline as jpl
from tpufhe.ops.rq import ntt_backward_any, ntt_forward_any

import tpufhe_torch.bfv as T
from tpufhe_torch import convert
from tpufhe_torch import pipeline as tpl
from tpufhe_torch.bfv.keys.key_switching_key import shoup_of

N = 1024
B = 2


@pytest.fixture(scope="module")
def params():
    jp = (J.BfvParametersBuilder().set_degree(N).set_plaintext_modulus(65537)
          .set_moduli_sizes([62, 62, 62]).build())
    tp = (T.BfvParametersBuilder().set_degree(N).set_plaintext_modulus(65537)
          .set_moduli_sizes([62, 62, 62]).set_device("cpu").build())
    return jp, tp


@pytest.fixture(scope="module")
def params4():
    """BASELINE config 4's moduli shape (4 x 62 bits), for the rotation."""
    jp = (J.BfvParametersBuilder().set_degree(N).set_plaintext_modulus(65537)
          .set_moduli_sizes([62] * 4).build())
    tp = (T.BfvParametersBuilder().set_degree(N).set_plaintext_modulus(65537)
          .set_moduli_sizes([62] * 4).set_device("cpu").build())
    return jp, tp


def _residues(moduli, lead, seed):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, p, lead + (N,), dtype=np.uint64)
                  for p in moduli], axis=-2)
    x.reshape((-1, len(moduli), N))[0] = np.array(moduli, dtype=np.uint64)[:, None] - 1
    return x.astype(np.int64)


def _random_key(tctx, seed):
    """A random (k, k, N) key with its Shoup constants, in the port's form
    and as tpufhe's lane-folded (value, Shoup) pairs per row."""
    k = tctx.k
    key = SimpleNamespace()
    key.c0 = torch.from_numpy(_residues(tctx.moduli, (k,), seed))
    key.c1 = torch.from_numpy(_residues(tctx.moduli, (k,), seed + 1))
    key.c0_shoup = shoup_of(key.c0, tctx.moduli)
    key.c1_shoup = shoup_of(key.c1, tctx.moduli)

    def lanes(t):
        return convert.words_to_lanes(t.numpy())

    ksk_c0 = [(lanes(key.c0[i]), lanes(key.c0_shoup[i])) for i in range(k)]
    ksk_c1 = [(lanes(key.c1[i]), lanes(key.c1_shoup[i])) for i in range(k)]
    return key, ksk_c0, ksk_c1


def test_tensor_intt_plain_matches_tpufhe(params):
    jp, tp = params
    jctx = jp.context_level_at(0).mul_params().to_ctx
    tctx = tp.context_level_at(0).mul_params().to_ctx
    ext = _residues(tctx.moduli, (4, B), 1)
    tensor = jpl._tensor_for(jctx)

    def ref(x):
        t = tensor(x[0], x[1], x[2], x[3])
        return ntt_backward_any(jctx, t, in_bits=62)

    want = jax.jit(ref)(convert.words_to_lanes(ext))
    got = tpl.tensor_intt_plain(tctx, torch.from_numpy(ext))
    np.testing.assert_array_equal(convert.lanes_to_words(np.asarray(want)),
                                  got.numpy())


def test_relin_tail_plain_matches_tpufhe(params):
    jp, tp = params
    jctx, tctx = jp.context_at_level(0), tp.context_at_level(0)
    dsc = _residues(tctx.moduli, (3, B), 2)
    key, ksk_c0, ksk_c1 = _random_key(tctx, 3)
    _, add_c = jpl._ops_for(jctx)

    def ref(x):
        digits = jpl._ksk_digits(jctx, x[2])
        ntts = ntt_forward_any(jctx, jnp.concatenate([x[:2], digits]),
                               in_bits=62)
        ks0, ks1 = jpl._ksk_accumulate(jctx, ntts[2:], ksk_c0, ksk_c1)
        return jnp.stack([add_c(ntts[0], ks0), add_c(ntts[1], ks1)])

    want = jax.jit(ref)(convert.words_to_lanes(dsc))
    got0, got1 = tpl.relin_tail_plain(tctx, torch.from_numpy(dsc), key)
    want = convert.lanes_to_words(np.asarray(want))
    np.testing.assert_array_equal(want[0], got0.numpy())
    np.testing.assert_array_equal(want[1], got1.numpy())


def test_rotate_tail_plain_matches_tpufhe(params4):
    """K5's plain version against _key_switch_batched + the add of s0
    (tpufhe pipeline.py:778-779), at k = 4."""
    jp, tp = params4
    jctx, tctx = jp.context_at_level(0), tp.context_at_level(0)
    s0 = _residues(tctx.moduli, (B,), 5)
    c2 = _residues(tctx.moduli, (B,), 6)
    key, ksk_c0, ksk_c1 = _random_key(tctx, 7)
    _, add_c = jpl._ops_for(jctx)

    def ref(s0, c2):
        ks0, ks1 = jpl._key_switch_batched(jctx, c2, ksk_c0, ksk_c1)
        return jnp.stack([add_c(ks0, s0), ks1])

    want = jax.jit(ref)(convert.words_to_lanes(s0), convert.words_to_lanes(c2))
    got0, got1 = tpl.rotate_tail_plain(tctx, torch.from_numpy(s0),
                                       torch.from_numpy(c2), key)
    want = convert.lanes_to_words(np.asarray(want))
    np.testing.assert_array_equal(want[0], got0.numpy())
    np.testing.assert_array_equal(want[1], got1.numpy())
