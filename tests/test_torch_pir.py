"""The port's MulPIR server response at level 0 against tpufhe, bit-exact
(tolerance 0): make_pir_response (expansion, the first dimension on
ct_pt_dot, the extend, the second dimension summed in the multiplication
basis, one down-scale and relinearization) on a batch of two queries, each
selecting its own cell, against tpufhe's program run eagerly as
tests/test_pipeline.py runs it (degree 16, 4 x 62-bit, dims (4, 2)); the
batched database build against Plaintext.try_encode; the second dimension
against the K7 + adds composition on the plain versions, across
ct_pt_dot's 14-term window.
"""

import jax
import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe.pipeline import make_pir_response as j_make_pir_response
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed

import tpufhe_torch.bfv as T
from tpufhe_torch import convert
from tpufhe_torch.pipeline import (
    _second_dimension,
    encode_pir_database,
    make_pir_response,
    mul_basis,
    tensor_plain,
)
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

N = 16
DIM1, DIM2 = 4, 2
LEVELS = (DIM1 + DIM2 - 1).bit_length()
CELLS = [(2, 1), (0, 0)]


def _words(x):
    return convert.lanes_to_words(np.asarray(getattr(x, "coeffs", x)))


def _params(sizes, t=1153):
    return ((J.BfvParametersBuilder().set_degree(N).set_plaintext_modulus(t)
             .set_moduli_sizes(sizes).build()),
            (T.BfvParametersBuilder().set_degree(N).set_plaintext_modulus(t)
             .set_moduli_sizes(sizes).set_device("cpu").build()))


class Pir:
    """Keys, database and a batch of queries of both packages from one
    seed (tests/test_pipeline.py:169-220); tpufhe's response computed
    once."""

    def __init__(self, seed=81):
        self.jp, self.tp = _params([62] * 4)
        t = self.t = self.tp.plaintext.value
        jr, tr = JRng(j_seed(seed)), ChaCha8Rng(seed_from_u64(seed))
        self.jsk = J.SecretKey.random(self.jp, jr)
        self.tsk = T.SecretKey.random(self.tp, tr)
        jrk, self.trk = (J.RelinearizationKey.new(self.jsk, jr),
                         T.RelinearizationKey.new(self.tsk, tr))
        jek = J.EvaluationKeyBuilder(self.jsk).enable_expansion(LEVELS).build(jr)
        self.tek = (T.EvaluationKeyBuilder(self.tsk).enable_expansion(LEVELS)
                    .build(tr))
        vals = np.random.default_rng(seed)
        self.db_vals = vals.integers(0, t, (DIM1, DIM2, N), dtype=np.uint64)
        jdb = np.stack([np.stack([
            np.asarray(J.Plaintext.try_encode(
                self.db_vals[i, j], J.Encoding.simd(), self.jp).poly_ntt.coeffs)
            for j in range(DIM2)]) for i in range(DIM1)])
        self.tdb = encode_pir_database(self.tp, self.db_vals, T.Encoding.simd())
        np.testing.assert_array_equal(_words(jdb), self.tdb.numpy())
        inv2l = pow(1 << LEVELS, -1, t)
        jq, tq = [], []
        for i, j in CELLS:
            q = np.zeros(N, dtype=np.uint64)
            q[i] = q[DIM1 + j] = inv2l
            jq.append(self.jsk.try_encrypt(J.Plaintext.try_encode(
                q, J.Encoding.poly(), self.jp), jr))
            tq.append(self.tsk.try_encrypt(T.Plaintext.try_encode(
                q, T.Encoding.poly(), self.tp), tr))
        self.tq = [torch.stack([c[i] for c in tq]) for i in range(2)]
        jq0 = np.stack([np.asarray(c[0].coeffs) for c in jq])
        jq1 = np.stack([np.asarray(c[1].coeffs) for c in jq])
        np.testing.assert_array_equal(_words(jq0), self.tq[0].numpy())
        with jax.disable_jit():
            self.jout = j_make_pir_response(self.jp, jek, jrk, jdb, DIM1,
                                            DIM2)(jq0, jq1)


@pytest.fixture(scope="module")
def pir():
    return Pir()


def test_make_pir_response_matches_tpufhe_and_decrypts(pir):
    p = pir
    out0, out1 = make_pir_response(p.tp, p.tek, p.trk, p.tdb, DIM1, DIM2)(
        *p.tq)
    assert out0.shape == (len(CELLS), 4, N)
    np.testing.assert_array_equal(_words(p.jout[0]), out0.numpy())
    np.testing.assert_array_equal(_words(p.jout[1]), out1.numpy())
    for b, cell in enumerate(CELLS):
        ans = T.Ciphertext(p.tp, [out0[b], out1[b]], 0)
        got = p.tsk.try_decrypt(ans).try_decode(T.Encoding.simd())
        np.testing.assert_array_equal(got, p.db_vals[cell])


# (encoding, level, moduli sizes, t): MulPIR's poly rows at level 1 of
# (50, 55, 55) under its t, SIMD rows at level 0 and 1, narrow poly rows
ENCODE_CASES = [("poly", 1, [50, 55, 55], 1785857),
                ("simd", 0, [62] * 3, 1153), ("simd", 1, [62] * 3, 65537),
                ("poly", 0, [30] * 3, 257)]


@pytest.mark.parametrize("enc,level,sizes,t", ENCODE_CASES)
def test_encode_pir_database_matches_try_encode(enc, level, sizes, t):
    _, tp = _params(sizes, t)
    vals = np.random.default_rng(level + t).integers(0, t, (3, 2, N),
                                                     dtype=np.uint64)
    got = encode_pir_database(tp, vals, getattr(T.Encoding, enc)(level))
    ctx = tp.context_at_level(level)
    assert got.shape == (3, 2, ctx.k, N) and got.dtype == ctx.dtype
    for i in range(3):
        for j in range(2):
            pt = T.Plaintext.try_encode(vals[i, j],
                                        getattr(T.Encoding, enc)(level), tp)
            assert torch.equal(got[i, j], pt.poly_ntt)


@pytest.mark.parametrize("dim2,batch", [(2, 1), (8, 2), (9, 1)])
def test_second_dimension_matches_the_tensor_sum(dim2, batch):
    """Three ct_pt_dot launches (rows 0 and 2 over dim2 terms, row 1 over
    2 dim2: 16 and 18 terms cross the 14-term window of 62-bit moduli)
    against K7 per j and modular adds, on the plain versions."""
    _, tp = _params([62] * 3)
    ctx_mul = mul_basis(tp).ctx_mul
    rng = np.random.default_rng(dim2)
    ext = torch.from_numpy(np.stack([
        rng.integers(0, p, (4, dim2, batch, N), dtype=np.uint64)
        for p in ctx_mul.moduli], axis=-2).astype(np.int64))
    ext[..., 0] = torch.tensor(ctx_mul.moduli) - 1
    s1, s0, r0, r1 = ext
    want = None
    for j in range(dim2):
        t = tensor_plain(ctx_mul, s0[j], s1[j], r0[j], r1[j])
        want = t if want is None else ctx_mul.add(want, t)
    assert torch.equal(_second_dimension(ctx_mul, ext), want)
