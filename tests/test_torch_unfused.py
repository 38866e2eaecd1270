"""The unfused composition of the port's programs against tpufhe.

Where the fused kernels K3, K4 and K5 do not fit one block
(``kernels.tail_fits``, false at N = 16384), the programs run K7 + K1
inverse and K1 forward + ks_accumulate in their place, as tpufhe does
where its tail kernel does not fit. Off the TPU tpufhe runs that unfused
composition itself, so its programs are the oracle. Here the predicate is
forced false at degree 16 and each program is held to tpufhe's and to the
port's fused route; ks_accumulate's plain version is held to the plain
tails at degree 64; the N = 16384, 6 x 62-bit builder to tpufhe's basis.
Every comparison is bit-exact (tolerance 0).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe.bfv.keys.evaluation_key import EvaluationKeyBuilder as JEkb
from tpufhe.pipeline import build_mul_relin_step as j_build_mul_relin_step
from tpufhe.pipeline import make_expand as j_make_expand
from tpufhe.pipeline import make_inner_sum as j_make_inner_sum
from tpufhe.pipeline import make_mul_relin as j_make_mul_relin
from tpufhe.pipeline import make_rotate as j_make_rotate
from tpufhe.pipeline import make_square_relin as j_make_square_relin
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed

import tpufhe_torch.bfv as T
from tpufhe_torch import convert, kernels
from tpufhe_torch import pipeline as tpl
from tpufhe_torch.bfv.keys.evaluation_key import EvaluationKeyBuilder
from tpufhe_torch.bfv.keys.key_switching_key import shoup_of
from tpufhe_torch.ops.ntt import forward_plain
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

T_PLAIN = 65537
EXPAND_LEVEL = 2
# the plain versions whose calls show which route a program took
ROUTE_FUNCTIONS = ("tensor_intt_plain", "relin_tail_plain", "rotate_tail_plain",
                   "tensor_plain", "ks_accumulate_plain")


def _params(degree, sizes):
    jp = (J.BfvParametersBuilder().set_degree(degree)
          .set_plaintext_modulus(T_PLAIN).set_moduli_sizes(sizes).build())
    tp = (T.BfvParametersBuilder().set_degree(degree)
          .set_plaintext_modulus(T_PLAIN).set_moduli_sizes(sizes)
          .set_device("cpu").build())
    return jp, tp


def _words(arr):
    return convert.lanes_to_words(np.asarray(arr))


class Pair:
    """Keys (relinearization, and inner sum + expansion) and two batches of
    ciphertexts, made by both packages from one seed."""

    def __init__(self, degree, sizes, seed, batch=2):
        self.jp, self.tp = _params(degree, sizes)
        jr, tr = JRng(j_seed(seed)), ChaCha8Rng(seed_from_u64(seed))
        self.jsk = J.SecretKey.random(self.jp, jr)
        self.tsk = T.SecretKey.random(self.tp, tr)
        self.jrk = J.RelinearizationKey.new(self.jsk, jr)
        self.trk = T.RelinearizationKey.new(self.tsk, tr)
        self.jek = (JEkb(self.jsk).enable_inner_sum()
                    .enable_expansion(EXPAND_LEVEL).build(jr))
        self.tek = (EvaluationKeyBuilder(self.tsk).enable_inner_sum()
                    .enable_expansion(EXPAND_LEVEL).build(tr))
        vals = np.random.default_rng(seed)
        self.jc, self.tc = [], []
        for _ in range(2):
            js, ts = [], []
            for v in vals.integers(0, T_PLAIN, (batch, degree), dtype=np.uint64):
                js.append(self.jsk.try_encrypt(J.Plaintext.try_encode(
                    v, J.Encoding.simd(), self.jp), jr))
                ts.append(self.tsk.try_encrypt(T.Plaintext.try_encode(
                    v, T.Encoding.simd(), self.tp), tr))
            self.jc.append(js)
            self.tc.append(ts)

    def j_args(self):
        return tuple(np.stack([np.asarray(c[i].coeffs) for c in cs])
                     for cs in self.jc for i in (0, 1))

    def t_args(self):
        return tuple(torch.stack([c[i] for c in cs])
                     for cs in self.tc for i in (0, 1))


@pytest.fixture(scope="module")
def pair3():
    """3 x 62-bit at degree 16, for the products."""
    return Pair(16, [62] * 3, 61)


@pytest.fixture(scope="module")
def pair4():
    """BASELINE config 4's moduli shape (4 x 62-bit) at degree 16, for the
    rotations."""
    return Pair(16, [62] * 4, 62)


def _run_routes(monkeypatch, build, args):
    """Run the program that `build()` makes on the fused route, then with
    the fit predicate forced false; returns ((fused outputs, calls),
    (unfused outputs, calls)), calls counting the plain versions run."""
    calls = {}
    for name in ROUTE_FUNCTIONS:
        def spy(*a, _fn=getattr(tpl, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tpl, name, spy)
    out = []
    for fits in (True, False):
        monkeypatch.setattr(kernels, "tail_fits", lambda n, word_bytes=8,
                            _fits=fits: _fits)
        calls.clear()
        result = build()(*args)
        out.append((result, dict(calls)))
    return out


def _assert_matches(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_words(w), g.numpy())


# ---------------------------------------------------------------------------
# The predicate and the N = 16384 builder
# ---------------------------------------------------------------------------


def test_tail_fits():
    assert kernels.tail_fits(8192)
    assert not kernels.tail_fits(16384)  # 393,216 bytes of 232,448
    assert kernels.tail_fits(16384, 4)  # narrow rows (K9 holds one)


def test_n16384_builder_matches_tpufhe_basis():
    """BASELINE config 5's ring (N = 16384, 6 x 62-bit): the port builds
    tpufhe's 13-limb multiplication basis and takes the unfused route."""
    jp, tp = _params(16384, [62] * 6)
    want = jp.context_level_at(0).mul_params().extender.to_ctx.moduli
    mb = tpl.mul_basis(tp)
    assert tuple(mb.ctx_mul.moduli) == tuple(want) and mb.ctx_mul.k == 13
    assert tuple(tp.moduli) == tuple(jp.moduli)
    assert not tpl._fused_tail(tp.context_at_level(0))
    assert mb.down._k_in == 13 and mb.ext._k_in == 6


# ---------------------------------------------------------------------------
# ks_accumulate's plain version + K1 forward against the plain tails
# ---------------------------------------------------------------------------


def _residues(moduli, lead, n, seed):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, p, lead + (n,), dtype=np.uint64)
                  for p in moduli], axis=-2)
    x.reshape((-1, len(moduli), n))[0] = np.array(moduli, dtype=np.uint64)[:, None] - 1
    return torch.from_numpy(x.astype(np.int64))


@pytest.mark.parametrize("tail", ["relin", "rotate"])
def test_ks_accumulate_plain_matches_plain_tails(tail):
    _, tp = _params(64, [62] * 4)
    ctx = tp.context_at_level(0)
    k, n = ctx.k, ctx.degree
    key = SimpleNamespace(log_base=0)
    key.c0 = _residues(ctx.moduli, (k,), n, 1)
    key.c1 = _residues(ctx.moduli, (k,), n, 2)
    key.c0_shoup = shoup_of(key.c0, ctx.moduli)
    key.c1_shoup = shoup_of(key.c1, ctx.moduli)
    omegas = ctx.tables.omegas
    if tail == "relin":
        dsc = _residues(ctx.moduli, (3, 2), n, 3)
        digits = tpl._ksk_digits(ctx, dsc[2])
        ntts = forward_plain(torch.cat([dsc[:2], digits]), omegas, ctx.mod)
        got = tpl.ks_accumulate_plain(ctx, ntts[2:], key, ntts[0], ntts[1])
        want = tpl.relin_tail_plain(ctx, dsc, key)
        unfused = tpl.relin_tail_unfused(ctx, dsc, key)
    else:
        s0 = _residues(ctx.moduli, (2,), n, 4)
        c2 = _residues(ctx.moduli, (2,), n, 5)
        lifted = forward_plain(tpl._ksk_digits(ctx, c2), omegas, ctx.mod)
        got = tpl.ks_accumulate_plain(ctx, lifted, key, s0)
        want = tpl.rotate_tail_plain(ctx, s0, c2, key)
        unfused = tpl.rotate_tail_unfused(ctx, s0, c2, key)
    assert got.shape == (2, 2, k, n)
    assert torch.equal(got, torch.stack(want))
    assert torch.equal(torch.stack(unfused), got)


# ---------------------------------------------------------------------------
# The programs, forced to the unfused route, against tpufhe at degree 16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kp", [None, 1])
def test_mul_relin_unfused_matches_tpufhe(pair3, monkeypatch, kp):
    p = pair3
    if kp is None:
        want = j_make_mul_relin(p.jp, p.jrk)(*p.j_args())
    else:
        want = jax.jit(j_build_mul_relin_step(p.jp, p.jrk, strategy2_primes=kp))(
            *p.j_args())
    (fused, fused_calls), (unfused, calls) = _run_routes(
        monkeypatch, lambda: tpl.make_mul_relin(p.tp, p.trk,
                                                strategy2_primes=kp),
        p.t_args())
    # tensor_intt_plain forms its tensor with tensor_plain
    assert fused_calls == {"tensor_intt_plain": 1, "tensor_plain": 1,
                           "relin_tail_plain": 1}
    assert calls == {"tensor_plain": 1, "ks_accumulate_plain": 1}
    _assert_matches(unfused, want)
    assert all(torch.equal(a, b) for a, b in zip(fused, unfused))


def test_square_unfused_matches_tpufhe(pair3, monkeypatch):
    p = pair3
    a = p.j_args()
    want = j_make_square_relin(p.jp, p.jrk)(a[0], a[1])
    (fused, fused_calls), (unfused, calls) = _run_routes(
        monkeypatch, lambda: tpl.make_square_relin(p.tp, p.trk),
        p.t_args()[:2])
    assert fused_calls == {"tensor_plain": 1, "relin_tail_plain": 1}
    assert calls == {"tensor_plain": 1, "ks_accumulate_plain": 1}
    _assert_matches(unfused, want)
    assert all(torch.equal(a, b) for a, b in zip(fused, unfused))


@pytest.mark.parametrize("program", ["rotate", "inner_sum", "expand"])
def test_rotations_unfused_match_tpufhe(pair4, monkeypatch, program):
    p = pair4
    args_j, args_t = p.j_args()[:2], p.t_args()[:2]
    if program == "rotate":
        e = p.tek.rot_to_gk_exponent[1]
        want = j_make_rotate(p.jp, p.jek.gk[e])(*args_j)
        steps = 1
        build = lambda: tpl.make_rotate(p.tp, p.tek.gk[e])  # noqa: E731
    elif program == "inner_sum":
        want = j_make_inner_sum(p.jp, p.jek)(*args_j)
        steps = p.tp.degree().bit_length() - 1
        build = lambda: tpl.make_inner_sum(p.tp, p.tek)  # noqa: E731
    else:
        want = j_make_expand(p.jp, p.jek, EXPAND_LEVEL)(*args_j)
        steps = EXPAND_LEVEL
        build = lambda: tpl.make_expand(p.tp, p.tek, EXPAND_LEVEL)  # noqa: E731
    (fused, fused_calls), (unfused, calls) = _run_routes(monkeypatch, build,
                                                         args_t)
    assert fused_calls == {"rotate_tail_plain": steps}
    assert calls == {"ks_accumulate_plain": steps}
    _assert_matches(unfused, want)
    assert all(torch.equal(a, b) for a, b in zip(fused, unfused))


# ---------------------------------------------------------------------------
# The narrow (w30) tails: ks_accumulate on int32 words
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("program", ["mul_relin", "rotate"])
def test_narrow_tail_runs_ks_accumulate(monkeypatch, program):
    """On narrow parameters every tail is unfused, and its accumulate is
    ks_accumulate on the context's int32 words (the kernel on the card,
    its plain version here), once per tail; the products and rotations
    decrypt right."""
    _, tp = _params(64, [30] * 3)
    ctx = tp.context_at_level(0)
    assert ctx.narrow
    tr = ChaCha8Rng(seed_from_u64(63))
    sk = T.SecretKey.random(tp, tr)
    vals = np.random.default_rng(63).integers(0, T_PLAIN, (2, 64),
                                              dtype=np.uint64)
    cts = [sk.try_encrypt(T.Plaintext.try_encode(v, T.Encoding.simd(), tp), tr)
           for v in vals]
    if program == "mul_relin":
        step = tpl.make_mul_relin(tp, T.RelinearizationKey.new(sk, tr))
        args = (cts[0][0][None], cts[0][1][None], cts[1][0][None],
                cts[1][1][None])
        want = vals[0].astype(object) * vals[1].astype(object) % T_PLAIN
    else:
        ek = EvaluationKeyBuilder(sk).enable_column_rotation(1).build(tr)
        step = tpl.make_rotate(tp, ek.gk[ek.rot_to_gk_exponent[1]])
        args = (cts[0][0][None], cts[0][1][None])
        h = 32
        want = np.concatenate([np.roll(vals[0][:h], -1),
                               np.roll(vals[0][h:], -1)])
    seen = []

    def spy(c, lifted, ksk, add0=None, add1=None, _fn=tpl.ks_accumulate):
        seen.append((lifted.dtype, ksk.c0_shoup.dtype))
        return _fn(c, lifted, ksk, add0, add1)

    monkeypatch.setattr(tpl, "ks_accumulate", spy)
    c0, c1 = step(*args)
    assert seen == [(torch.int32, torch.int32)]
    assert c0.dtype == torch.int32 and c0.shape == (1, ctx.k, 64)
    pt = sk.try_decrypt(T.Ciphertext(tp, [c0[0], c1[0]], 0))
    np.testing.assert_array_equal(
        pt.try_decode(T.Encoding.simd()), np.array(want, dtype=np.uint64))
