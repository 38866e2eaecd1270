"""The lazy NTT and the key switch alone against tpufhe on the CPU.

- ``Poly.into_ntt(lazy=True)`` and ``ntt_forward(lazy=True)``: tpufhe's
  lazy words are below 4p and congruent to the port's (which the plain
  transform leaves canonical, one valid lazy output); every canonical
  result of a lazy poly (a product by an NTT_SHOUP poly, a scalar product,
  after a substitution) equals tpufhe's bit for bit, also when the port's
  poly holds tpufhe's own lazy words (some read as negative int64); every
  operation tpufhe asserts against on a lazy poly raises
  UnsupportedOperation. Wide (3 x 62-bit) and narrow (3 x 30-bit).
- ``pipeline.key_switch`` with no addends by both routes, ks_tail (the
  default where the fused tails run) and K1 + ks_accumulate (forced with
  kernels.tail_fits), equal to tpufhe's KeySwitchingKey.key_switch at a
  leveled key (2 digit rows over 3 limbs) and at d = k, and
  ``key_switch_down`` inside a leveled relinearization equal to tpufhe's.

Tolerance: exact for canonical words; bound and congruence for lazy ones.
Degree 16, keys and values from one ChaCha8 seed in both packages.
"""

import jax  # noqa: F401  (tpufhe's backend, on the CPU here)
import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe.ops.rns import ScalingFactor as JScalingFactor
from tpufhe.ops.rq import Context as JContext
from tpufhe.ops.rq import Poly as JPoly
from tpufhe.ops.rq import Scaler as JScaler
from tpufhe.ops.rq import SubstitutionExponent as JSub
from tpufhe.ops.rq import ntt_forward_any
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed

import tpufhe_torch.bfv as T
from tpufhe_torch import convert, kernels
from tpufhe_torch import pipeline as tpl
from tpufhe_torch.errors import UnsupportedOperation
from tpufhe_torch.ops.ntt import ntt_transform
from tpufhe_torch.ops.rns import ScalingFactor
from tpufhe_torch.ops.rq import (
    NTT,
    NTT_SHOUP,
    POWER_BASIS,
    Context,
    Poly,
    Scaler,
    SubstitutionExponent,
    ntt_forward,
)
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

N = 16
KINDS = {"wide": [62] * 3, "narrow": [30] * 3}


def _contexts(kind):
    moduli = J.BfvParametersBuilder.generate_moduli(KINDS[kind], N)
    narrow = kind == "narrow"
    return JContext(moduli, N, narrow), Context(moduli, N, "cpu", narrow)


def _words(x):
    """tpufhe's (lo, hi) lanes as unsigned words (uint64)."""
    w = convert.lanes_to_words(np.asarray(getattr(x, "coeffs", x)))
    return w.view(np.uint32 if w.dtype == np.int32 else np.uint64).astype(
        np.uint64)


def _same(jp, tp):
    assert jp.representation == tp.representation and not tp.lazy
    np.testing.assert_array_equal(_words(jp),
                                  tp.coeffs.numpy().astype(np.uint64))


def _pair(kind, rep, seed):
    jctx, tctx = _contexts(kind)
    return (JPoly.random(jctx, JRng(j_seed(seed)), rep),
            Poly.random(tctx, ChaCha8Rng(seed_from_u64(seed)), rep))


def _lazy_words(jctx, jl):
    """tpufhe's lazy words: each below 4p; returned (k, N) uint64."""
    w = _words(jl)
    p = np.array(jctx.moduli, np.uint64)[:, None]
    assert (w < 4 * p).all()
    return w


@pytest.mark.parametrize("kind", KINDS)
def test_lazy_poly_products_match_tpufhe(kind):
    jp, tp = _pair(kind, POWER_BASIS, 1)
    jl, tl = jp.into_ntt(lazy=True), tp.into_ntt(lazy=True)
    assert jl.lazy and tl.lazy and tl.representation == NTT
    p = np.array(tl.ctx.moduli, np.uint64)[:, None]
    w = _lazy_words(jl.ctx, jl)
    np.testing.assert_array_equal(w % p, tl.coeffs.numpy().astype(np.uint64))
    np.testing.assert_array_equal(tl.coeffs, tp.into_ntt().coeffs)
    jq, tq = _pair(kind, NTT_SHOUP, 2)
    _same(jl * jq, tl * tq)
    _same(jl.scalar_mul(12345), tl.scalar_mul(12345))
    jexp, texp = JSub(jl.ctx, 3), SubstitutionExponent(tl.ctx, 3)
    js, ts = jl.substitute(jexp), tl.substitute(texp)
    assert ts.lazy
    _same(js * jq, ts * tq)
    # the port's poly on tpufhe's own lazy words (wide: some above 2^63)
    words = w.astype(np.uint32).view(np.int32) if tl.ctx.narrow \
        else w.view(np.int64)
    held = Poly(tl.ctx, NTT, torch.from_numpy(words.copy()), lazy=True)
    _same(jl * jq, held * tq)
    _same(jl.scalar_mul(7), held.scalar_mul(7))


def _refusals(kind):
    """(name, tpufhe call, port call) of each operation tpufhe asserts
    against on a lazy poly."""
    jp, tp = _pair(kind, POWER_BASIS, 3)
    jl, tl = jp.into_ntt(lazy=True), tp.into_ntt(lazy=True)
    jn, tn = _pair(kind, NTT, 4)
    jsc = JScaler(jl.ctx, jl.ctx, JScalingFactor.one())
    tsc = Scaler(tl.ctx, tl.ctx, ScalingFactor.one())
    return {
        "add": (lambda: jl + jn, lambda: tl + tn),
        "add_rhs": (lambda: jn + jl, lambda: tn + tl),
        "sub": (lambda: jl - jn, lambda: tl - tn),
        "neg": (lambda: -jl, lambda: -tl),
        "ntt_product": (lambda: jl * jn, lambda: tl * tn),
        "ntt_product_rhs": (lambda: jn * jl, lambda: tn * tl),
        "into_power_basis": (jl.into_power_basis, tl.into_power_basis),
        "into_ntt_shoup": (jl.into_ntt_shoup, tl.into_ntt_shoup),
        "scale": (lambda: jsc.scale(jl), lambda: tsc.scale(tl)),
        "to_bytes": (jl.to_bytes, tl.to_bytes),
    }


REFUSED = ["add", "add_rhs", "sub", "neg", "ntt_product", "ntt_product_rhs",
           "into_power_basis", "into_ntt_shoup", "scale", "to_bytes"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", REFUSED)
def test_lazy_poly_refusals_match_tpufhe(kind, name):
    j_call, t_call = _refusals(kind)[name]
    with pytest.raises(AssertionError):
        j_call()
    with pytest.raises(UnsupportedOperation):
        t_call()


@pytest.mark.parametrize("kind", KINDS)
def test_scaler_takes_a_poly_as_tpufhe(kind):
    """Scaler.scale of a (non-lazy) Poly, tpufhe's signature, in both
    representations: the same words as tpufhe's."""
    jctx, tctx = _contexts(kind)
    jsc = JScaler(jctx, jctx.next_context, JScalingFactor(3, 5))
    tsc = Scaler(tctx, tctx.next_context, ScalingFactor(3, 5))
    for rep in (POWER_BASIS, NTT):
        jp, tp = _pair(kind, rep, 5)
        _same(jsc.scale(jp), tsc.scale(tp))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sl", [None, slice(1, 3)])
def test_ntt_forward_lazy_within_bound_and_congruent(kind, sl):
    jctx, tctx = _contexts(kind)
    jp, tp = _pair(kind, POWER_BASIS, 6)
    limbs = slice(None) if sl is None else sl
    x = tp.coeffs[limbs].contiguous()
    got = ntt_forward(tctx, x, limbs if sl else None, lazy=True)
    assert got.dtype == tctx.dtype
    assert torch.equal(got, ntt_forward(tctx, x, limbs if sl else None))
    jw = _words(ntt_forward_any(jctx, jp.coeffs[limbs], lazy=True,
                                limb_slice=sl) if sl else
                ntt_forward_any(jctx, jp.coeffs, lazy=True))
    p = np.array(tctx.moduli[limbs], np.uint64)[:, None]
    assert (jw < 4 * p).all()
    np.testing.assert_array_equal(jw % p, got.numpy().astype(np.uint64))
    with pytest.raises(ValueError):
        ntt_transform(x, tctx.tables, inverse=True, lazy=True)


class Pair:
    """Secret keys of both packages from one seed, 3 x 62-bit, t = 65537."""

    def __init__(self, seed):
        def build(builder):
            return (builder().set_degree(N).set_plaintext_modulus(65537)
                    .set_moduli_sizes([62] * 3))

        self.jp = build(J.BfvParametersBuilder).build()
        self.tp = build(T.BfvParametersBuilder).set_device("cpu").build()
        self.jr, self.tr = JRng(j_seed(seed)), ChaCha8Rng(seed_from_u64(seed))
        self.jsk = J.SecretKey.random(self.jp, self.jr)
        self.tsk = T.SecretKey.random(self.tp, self.tr)


@pytest.fixture(scope="module")
def pair():
    return Pair(81)


def _route(monkeypatch, route):
    """Force key_switch's route; returns the list of ks_tail calls."""
    calls = []
    orig = tpl.ks_tail

    def spy(*args):
        calls.append(args[1].shape)
        return orig(*args)

    monkeypatch.setattr(tpl, "ks_tail", spy)
    if route == "unfused":
        monkeypatch.setattr(kernels, "tail_fits",
                            lambda n, word_bytes=8: False)
    return calls


@pytest.mark.parametrize("route", ["ks_tail", "unfused"])
@pytest.mark.parametrize("levels", [(1, 0), (0, 0)], ids=["leveled", "d=k"])
def test_key_switch_routes_match_tpufhe(pair, monkeypatch, route, levels):
    """KeySwitchingKey.key_switch of a power-basis row: ks_tail (d rows
    over the key's k limbs) or K1 + ks_accumulate, against tpufhe's."""
    p = pair
    ct_level, key_level = levels
    jctx_k, tctx_k = (p.jp.context_at_level(key_level),
                      p.tp.context_at_level(key_level))
    jfrom = JPoly.random(jctx_k, JRng(j_seed(9)), POWER_BASIS)
    tfrom = Poly.random(tctx_k, ChaCha8Rng(seed_from_u64(9)), POWER_BASIS)
    jk = J.KeySwitchingKey.new(p.jsk, jfrom, ct_level, key_level,
                               JRng(j_seed(10)))
    tk = T.KeySwitchingKey.new(p.tsk, tfrom.coeffs, ct_level, key_level,
                               ChaCha8Rng(seed_from_u64(10)))
    d = 3 - ct_level
    assert tk.c0.shape == (d, 3, N)
    j2 = JPoly.random(p.jp.context_at_level(ct_level), JRng(j_seed(11)),
                      POWER_BASIS)
    t2 = Poly.random(p.tp.context_at_level(ct_level),
                     ChaCha8Rng(seed_from_u64(11)), POWER_BASIS).coeffs
    calls = _route(monkeypatch, route)
    got = tk.key_switch(t2)
    assert calls == ([(d, N)] if route == "ks_tail" else [])
    for x, y in zip(jk.key_switch(j2), got):
        np.testing.assert_array_equal(_words(x), y.numpy().astype(np.uint64))
    # the kernel's plain version and the unfused composition, directly
    batch = torch.stack([t2, t2.flip(-1)])
    lifted = ntt_forward(tctx_k, tpl.ksk_rows(tctx_k, batch, tk))
    assert torch.equal(tpl.ks_tail_plain(tctx_k, batch, tk),
                       tpl.ks_accumulate_plain(tctx_k, lifted, tk))


@pytest.mark.parametrize("route", ["ks_tail", "unfused"])
def test_key_switch_down_routes_match_tpufhe(pair, monkeypatch, route):
    """A relinearization key for level-1 ciphertexts held at level 0:
    relinearizes runs key_switch_down (its key switch by either route),
    equal to tpufhe's, and decrypts to the product."""
    p = pair
    jrk = J.RelinearizationKey.new(p.jsk, JRng(j_seed(12)), 1, 0)
    trk = T.RelinearizationKey.new(p.tsk, ChaCha8Rng(seed_from_u64(12)), 1, 0)
    vals = np.random.default_rng(13)
    va, vb = (vals.integers(0, 65537, N, dtype=np.uint64) for _ in range(2))
    cts = []
    for v in (va, vb):
        jpt = J.Plaintext.try_encode(v, J.Encoding.simd(1), p.jp)
        tpt = T.Plaintext.try_encode(v, T.Encoding.simd(1), p.tp)
        cts.append((p.jsk.try_encrypt(jpt, p.jr), p.tsk.try_encrypt(tpt, p.tr)))
    (ja, ta), (jb, tb) = cts
    jc, tc = J.ct_mul(ja, jb), T.ct_mul(ta, tb)
    calls = _route(monkeypatch, route)
    jrk.relinearizes(jc)
    trk.relinearizes(tc)
    assert calls == ([(2, N)] if route == "ks_tail" else [])
    for i in range(2):
        np.testing.assert_array_equal(_words(jc[i]),
                                      tc[i].numpy().astype(np.uint64))
    got = p.tsk.try_decrypt(tc).try_decode(T.Encoding.simd(1))
    np.testing.assert_array_equal(
        got, (va.astype(object) * vb % 65537).astype(np.uint64))
