"""The port's Poly against tpufhe's Poly, bit-exact (tolerance 0): every
constructor, conversion, operator, the Galois substitution, the
switch-down, the negacyclic shift, the host accessors and the wire format,
in each representation, on wide (3 x 62-bit) and narrow (3 x 30-bit)
contexts at degree 16, and the conversions also at N = 8192. Both
packages draw from one ChaCha8 seed; tpufhe runs on the CPU."""

import jax  # noqa: F401  (tpufhe's backend, on the CPU here)
import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe.ops.rq import Context as JContext
from tpufhe.ops.rq import Poly as JPoly
from tpufhe.ops.rq import SubstitutionExponent as JSub
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed

from tpufhe_torch import convert
from tpufhe_torch.errors import (
    ContextMismatch,
    IncorrectRepresentation,
    NoMoreContext,
    UnsupportedOperation,
)
from tpufhe_torch.ops.rq import NTT, NTT_SHOUP, POWER_BASIS, Context, Poly
from tpufhe_torch.ops.rq import SubstitutionExponent
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

N = 16
REPS = [POWER_BASIS, NTT, NTT_SHOUP]
KINDS = {"wide": [62] * 3, "narrow": [30] * 3}


def _contexts(kind, n=N):
    moduli = J.BfvParametersBuilder.generate_moduli(KINDS[kind], n)
    narrow = kind == "narrow"
    return JContext(moduli, n, narrow), Context(moduli, n, "cpu", narrow)


def _words(x):
    return convert.lanes_to_words(np.asarray(getattr(x, "coeffs", x)))


def _same(jp, tp):
    """Same representation, coefficients and (in NTT_SHOUP) Shoup words."""
    assert jp.representation == tp.representation
    np.testing.assert_array_equal(_words(jp), tp.coeffs.numpy())
    if jp.representation == NTT_SHOUP:
        np.testing.assert_array_equal(_words(jp.coeffs_shoup),
                                      tp.coeffs_shoup.numpy())


def _pair(kind, rep, seed, n=N):
    """A random poly of both packages in `rep` from one seed."""
    jctx, tctx = _contexts(kind, n)
    jp = JPoly.random(jctx, JRng(j_seed(seed)), rep)
    tp = Poly.random(tctx, ChaCha8Rng(seed_from_u64(seed)), rep)
    _same(jp, tp)
    return jp, tp


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rep", REPS)
def test_constructors_match_tpufhe(kind, rep):
    jctx, tctx = _contexts(kind)
    _same(JPoly.zero(jctx, rep), Poly.zero(tctx, rep))
    assert Poly.zero(tctx, rep, batch=(2,)).batch_shape == (2,)
    mat = np.stack([np.arange(N, dtype=np.uint64) * 7 % p
                    for p in tctx.moduli])
    _same(JPoly.from_u64_matrix(mat, jctx, rep),
          Poly.from_u64_matrix(mat, tctx, rep))
    _same(JPoly.random_from_seed(jctx, bytes(range(32)), rep),
          Poly.random_from_seed(tctx, bytes(range(32)), rep))
    for variance in (10, 3):
        _same(JPoly.small(jctx, variance, JRng(j_seed(variance)), rep),
              Poly.small(tctx, variance, ChaCha8Rng(seed_from_u64(variance)),
                         rep))
    _pair(kind, rep, 11)


@pytest.mark.parametrize("kind", KINDS)
def test_coefficient_constructors_match_tpufhe(kind):
    jctx, tctx = _contexts(kind)
    signed = [-5, 3, -(1 << 40), (1 << 50) + 7, 0, -1]
    _same(JPoly.from_i64_coeffs(signed, jctx),
          Poly.from_i64_coeffs(signed, tctx))
    unsigned = np.array([(1 << 64) - 1, 1 << 63, 12345, 0, (1 << 62) + 9],
                        dtype=np.uint64)
    _same(JPoly.from_u64_coeffs(unsigned, jctx),
          Poly.from_u64_coeffs(unsigned, tctx))
    big = [(1 << 127) - 1, -(1 << 90) - 3, 42, 0, 1 << 200]
    _same(JPoly.from_bigint_coeffs(big, jctx),
          Poly.from_bigint_coeffs(big, tctx))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [N, 8192])
def test_conversions_match_tpufhe(kind, n):
    jp, tp = _pair(kind, POWER_BASIS, 12, n)
    jn, tn = jp.into_ntt(), tp.into_ntt()
    _same(jn, tn)
    _same(jn.into_power_basis(), tn.into_power_basis())
    _same(jp.into_ntt_shoup(), tp.into_ntt_shoup())
    _same(jn.into_ntt_shoup(), tn.into_ntt_shoup())
    _same(jn.into_ntt_shoup().into_ntt_from_shoup(),
          tn.into_ntt_shoup().into_ntt_from_shoup())
    _same(jn.into_ntt_shoup().into_power_basis(),
          tn.into_ntt_shoup().into_power_basis())
    assert tp.into_power_basis() is tp


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rep", [POWER_BASIS, NTT])
def test_ring_operations_match_tpufhe(kind, rep):
    ja, ta = _pair(kind, rep, 13)
    jb, tb = _pair(kind, rep, 14)
    _same(ja + jb, ta + tb)
    _same(ja - jb, ta - tb)
    _same(-ja, -ta)
    for scalar in (0, 5, (1 << 100) + 17, -3):
        _same(ja.scalar_mul(scalar), ta.scalar_mul(scalar))
    if rep == NTT:
        _same(ja * jb, ta * tb)
        _same(ja * jb.into_ntt_shoup(), ta * tb.into_ntt_shoup())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("exponent", [3, 5, 2 * N - 1])
def test_substitute_matches_tpufhe(kind, rep, exponent):
    jp, tp = _pair(kind, rep, 15)
    _same(jp.substitute(JSub(jp.ctx, exponent)),
          tp.substitute(SubstitutionExponent(tp.ctx, exponent)))


@pytest.mark.parametrize("kind", KINDS)
def test_switch_down_matches_tpufhe(kind):
    jp, tp = _pair(kind, POWER_BASIS, 16)
    _same(jp.switch_down(), tp.switch_down())
    last_j = jp.ctx.next_context.next_context
    last_t = tp.ctx.next_context.next_context
    jd, td = jp.switch_down_to(last_j), tp.switch_down_to(last_t)
    _same(jd, td)
    assert td.ctx is last_t
    with pytest.raises(NoMoreContext):
        td.switch_down()
    with pytest.raises(IncorrectRepresentation):
        tp.into_ntt().switch_down()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("power", [0, 1, 5, N, N + 3, 2 * N - 1])
def test_multiply_inverse_power_of_x_matches_tpufhe(kind, power):
    jp, tp = _pair(kind, POWER_BASIS, 17)
    _same(jp.multiply_inverse_power_of_x(power),
          tp.multiply_inverse_power_of_x(power))


@pytest.mark.parametrize("kind", KINDS)
def test_host_accessors_match_tpufhe(kind):
    jp, tp = _pair(kind, POWER_BASIS, 18)
    got = tp.to_u64_matrix()
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(jp.to_u64_matrix(), got)
    assert jp.lift_bigints() == tp.lift_bigints()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rep", REPS)
def test_wire_format_matches_tpufhe(kind, rep):
    jp, tp = _pair(kind, rep, 19)
    data = tp.to_bytes()
    assert data == jp.to_bytes()
    _same(JPoly.from_bytes(data, jp.ctx), Poly.from_bytes(data, tp.ctx))
    _same(jp, Poly.from_bytes(jp.to_bytes(), tp.ctx, rep))


def test_lazy_ntt_and_mismatches_raise():
    _, tp = _pair("wide", POWER_BASIS, 20)
    lazy = tp.into_ntt(lazy=True)
    assert lazy.lazy and lazy.representation == NTT
    with pytest.raises(UnsupportedOperation):
        lazy + lazy
    with pytest.raises(UnsupportedOperation):
        lazy.into_power_basis()
    with pytest.raises(IncorrectRepresentation):
        tp.into_ntt().into_ntt()
    with pytest.raises(IncorrectRepresentation):
        tp + tp.into_ntt()
    with pytest.raises(IncorrectRepresentation):
        tp * tp
    _, other = _pair("narrow", POWER_BASIS, 20)
    with pytest.raises(ContextMismatch):
        tp + other
    assert isinstance(tp.coeffs, torch.Tensor)
