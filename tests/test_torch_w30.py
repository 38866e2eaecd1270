"""The port's narrow (w30) mode against tpufhe, every comparison bit-exact
(integers, tolerance 0):

1. ops/zq32.py against tpufhe's zq32, as tests/test_w30.py runs it;
2. the narrow NTT tables against tpufhe's ctx.dev.om32 / oms32 / zi32 /
   zis32 / ninv32 / ninvs32 / mu0 / mu1, at N = 256 and 8192;
3. the plain version of K9 against tpufhe's Pallas kernel in interpret
   mode at N = 256, and against tpufhe's XLA narrow transform at N = 8192
   with limb_slice;
4. the narrow parameter builder at 7 x 30 bits, N = 8192: the moduli, the
   16-limb multiplication basis and the 3-limb plaintext context;
5. the scaler on int32 rows against tpufhe's narrow scaler at the extend
   (7 -> 9 new limbs) and down-scale (16 -> 7) of that set;
6. keys from one ChaCha8 seed: sk, rk and Galois keys, with their shoup32
   arrays, and the ciphertexts;
7. make_mul_relin, make_square_relin, make_rotate and make_inner_sum
   against tpufhe's jitted programs at degree 64, 4 x 30 bits (as
   tests/test_pipeline_jit.py runs them), the outputs decrypted under both
   packages' keys;
8. the refusals: strategy 2 and the fused extend on narrow parameters,
   wide moduli in a narrow context, the launching wrappers on CPU tensors;
   and the narrow expansion, which is no longer refused, against tpufhe's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe.bfv.keys.evaluation_key import EvaluationKeyBuilder as JEkb
from tpufhe.ops import ntt as jntt
from tpufhe.ops import zq32 as jzq32
from tpufhe.ops.pallas.ntt32_kernel import (
    build_limb_scalars32,
    build_stage_tables32,
    ntt32_pallas,
)
from tpufhe.ops.rq import NTT, Poly, lane_shape, ntt_backward_any, ntt_forward_any
from tpufhe.ops.rq import Context as JContext
from tpufhe.ops.zq import Modulus as JModulus
from tpufhe.pipeline import make_inner_sum as j_make_inner_sum
from tpufhe.pipeline import make_mul_relin as j_make_mul_relin
from tpufhe.pipeline import make_rotate as j_make_rotate
from tpufhe.pipeline import make_square_relin as j_make_square_relin
from tpufhe.utils.primes import generate_prime
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed

import tpufhe_torch.bfv as T
from tpufhe_torch import convert
from tpufhe_torch.bfv.keys.evaluation_key import EvaluationKeyBuilder
from tpufhe_torch.errors import InvalidContext, UnsupportedOperation
from tpufhe_torch.ops import zq32
from tpufhe_torch.ops.ntt import backward32_plain, forward32_plain, ntt32_cuda
from tpufhe_torch.ops.rq import Context, ntt_backward, ntt_forward
from tpufhe_torch.ops.zq import Modulus
from tpufhe_torch.pipeline import (
    make_expand,
    make_inner_sum,
    make_mul_relin,
    make_rotate,
    make_square_relin,
)
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

T_PLAIN = 65537


def _residues(moduli, lead, n, seed):
    """Canonical (lead..., k, n) int32 residues; the first row all p - 1."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, p, lead + (n,), dtype=np.uint64)
                  for p in moduli], axis=-2)
    x.reshape((-1, len(moduli), n))[0] = np.array(moduli, dtype=np.uint64)[:, None] - 1
    return x.astype(np.int32)


def _words(arr):
    return convert.lanes_to_words(np.asarray(arr))


def _params(degree, sizes):
    jp = (J.BfvParametersBuilder().set_degree(degree)
          .set_plaintext_modulus(T_PLAIN).set_moduli_sizes(sizes).build())
    tp = (T.BfvParametersBuilder().set_degree(degree)
          .set_plaintext_modulus(T_PLAIN).set_moduli_sizes(sizes)
          .set_device("cpu").build())
    return jp, tp


# ---------------------------------------------------------------------------
# 1. zq32
# ---------------------------------------------------------------------------

N256 = 256
P1 = generate_prime(30, 2 * N256, 1 << 30)
P2 = generate_prime(30, 2 * N256, P1)
P3 = generate_prime(24, 2 * N256, 1 << 24)


@pytest.mark.parametrize("p", [P1, P2, P3, (1 << 29) + 5])
def test_zq32_matches_tpufhe(p):
    rng = np.random.default_rng(p % 1000)
    a = rng.integers(0, p, 512, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, p, 512, dtype=np.uint64).astype(np.uint32)
    a[:2], b[:2] = [0, p - 1], [p - 1, p - 1]
    q, jq = Modulus(p), JModulus(p)
    assert q.mu64 == jq.mu64
    bs = np.array([q.shoup32(int(v)) for v in b], dtype=np.uint32)
    assert list(bs) == [jq.shoup32(int(v)) for v in b]
    pj = jnp.uint32(p)
    mu0, mu1 = np.uint32(q.mu64 & 0xFFFFFFFF), np.uint32(q.mu64 >> 32)
    ta, tb = torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32))
    tbs = torch.from_numpy(bs.view(np.int32))
    tp = torch.tensor(p, dtype=torch.int32)
    for got, want in (
            (zq32.add(ta, tb, tp), jzq32.add_mod32(a, b, pj)),
            (zq32.sub(ta, tb, tp), jzq32.sub_mod32(a, b, pj)),
            (zq32.neg(ta, tp), jzq32.neg_mod32(a, pj)),
            (zq32.mul(ta, tb, tp), jzq32.mul_mod32(a, b, mu0, mu1, pj)),
            (zq32.mul_shoup(ta, tb, tbs, tp),
             jzq32.mul_shoup32(a, b, bs, pj))):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))


# ---------------------------------------------------------------------------
# 2. Narrow tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(256, 2), (8192, 7)])
def test_narrow_tables_match_tpufhe(n, k):
    moduli = J.BfvParametersBuilder.generate_moduli([30] * k, n)
    jctx = JContext(tuple(moduli), n, narrow=True)
    tctx = Context(moduli, n, "cpu", narrow=True)
    assert tctx.narrow and tctx.dtype == torch.int32
    d, tb = jctx.dev, tctx.tables
    for got, want in ((tb.omegas, d.om32), (tb.omegas_shoup, d.oms32),
                      (tb.zetas_inv, d.zi32), (tb.zetas_inv_shoup, d.zis32),
                      (tb.p, d.p32), (tb.ninv, d.ninv32),
                      (tb.ninv_shoup, d.ninvs32)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    mu = [q.mu64 for q in tctx.q]
    np.testing.assert_array_equal([m & 0xFFFFFFFF for m in mu], d.mu0)
    np.testing.assert_array_equal([m >> 32 for m in mu], d.mu1)
    assert tb.barrett_lo is None and tb.barrett_hi is None


# ---------------------------------------------------------------------------
# 3. K9's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt32_plain_matches_pallas_kernel(inverse):
    """Against ntt32_pallas in interpret mode, as tests/test_w30.py:117-148."""
    jctx = JContext((P1, P2), N256)
    tctx = Context((P1, P2), N256, "cpu", narrow=True)
    x = _residues((P1, P2), (2,), N256, 41 + inverse)
    tables = np.stack([build_stage_tables32(op, inverse) for op in jctx.ops])
    tables = tables.reshape(tables.shape[:-1] + lane_shape(N256))
    want = ntt32_pallas(x.view(np.uint32).reshape(x.shape[:-1] + lane_shape(N256)),
                        tables, build_limb_scalars32(jctx.ops),
                        inverse=inverse, interpret=True)
    tb = tctx.tables
    xt = torch.from_numpy(x)
    if inverse:
        got = backward32_plain(xt, tb.zetas_inv, tb.ninv, tb.p)
    else:
        got = forward32_plain(xt, tb.omegas, tb.p)
    np.testing.assert_array_equal(np.asarray(want).reshape(x.shape),
                                  got.numpy().view(np.uint32))
    back = ntt_forward(tctx, got) if inverse else ntt_backward(tctx, got)
    assert torch.equal(back, xt)


def test_ntt32_plain_matches_tpufhe_at_8192():
    """ntt_forward / ntt_backward of a narrow context against tpufhe's
    ntt_forward_any / ntt_backward_any (its XLA forward32 / backward32 on
    the CPU), whole and with limb_slice 2..5."""
    n = 8192
    moduli = J.BfvParametersBuilder.generate_moduli([30] * 5, n)
    jctx = JContext(tuple(moduli), n, narrow=True)
    tctx = Context(moduli, n, "cpu", narrow=True)
    x = _residues(moduli, (2,), n, 43)
    lanes, xt = convert.words_to_lanes(x), torch.from_numpy(x)
    fwd = jax.jit(lambda a: ntt_forward_any(jctx, a))(lanes)
    np.testing.assert_array_equal(_words(fwd), ntt_forward(tctx, xt).numpy())
    bwd = jax.jit(lambda a: ntt_backward_any(jctx, a))(lanes)
    np.testing.assert_array_equal(_words(bwd), ntt_backward(tctx, xt).numpy())
    sl = slice(2, 5)
    want = jntt.forward32(x[:, sl].view(np.uint32), jctx.dev.om32[sl],
                          jctx.dev.oms32[sl], jctx.dev.p32[sl],
                          jctx.dev.p232[sl])
    got = ntt_forward(tctx, xt[:, sl].contiguous(), limb_slice=sl)
    np.testing.assert_array_equal(np.asarray(want), got.numpy().view(np.uint32))


# ---------------------------------------------------------------------------
# 4 and 5. Parameters and scalers at 7 x 30 bits, N = 8192
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params_8192():
    return _params(8192, [30] * 7)


def test_narrow_builder_matches_tpufhe(params_8192):
    jp, tp = params_8192
    assert tp.moduli == tuple(jp.moduli)
    lvl_j, lvl_t = jp.context_level_at(0), tp.context_level_at(0)
    ctx = lvl_t.poly_context
    assert ctx.narrow and lvl_j.poly_context.narrow
    mp_j, mp_t = lvl_j.mul_params(), lvl_t.mul_params()
    assert mp_t.to_ctx.k == 16 and mp_t.to_ctx.narrow
    assert mp_t.to_ctx.moduli == mp_j.to_ctx.moduli
    assert all(m < (1 << 30) for m in mp_t.to_ctx.moduli)
    pc_j = lvl_j.cipher_plain_context.plaintext_context
    pc_t = lvl_t.cipher_plain_context.plaintext_context
    assert pc_t.k == 3 and pc_t.narrow and pc_t.moduli == pc_j.moduli
    assert not tp.ntt_operator.narrow and not jp.ntt_operator.narrow
    for lvl in range(len(tp.moduli)):
        assert tp.context_at_level(lvl).moduli == jp.context_at_level(lvl).moduli
        assert tp.context_at_level(lvl).narrow
    cp_j, cp_t = lvl_j.cipher_plain_context, lvl_t.cipher_plain_context
    assert cp_t.delta.dtype == torch.int32
    np.testing.assert_array_equal(cp_t.delta[:, 0].numpy(),
                                  _words(cp_j.delta.coeffs)[:, 0])
    assert cp_t.q_mod_t == cp_j.q_mod_t


@pytest.mark.parametrize("which", ["extend", "down"])
def test_narrow_scaler_matches_tpufhe(params_8192, which):
    jp, tp = params_8192
    mp_j = jp.context_level_at(0).mul_params()
    mp_t = tp.context_level_at(0).mul_params()
    k, k_mul = 7, 16
    if which == "extend":
        jsc, tsc = mp_j.extender.rns_scaler, mp_t.extender.rns_scaler
        start, size = k, k_mul - k
    else:
        jsc, tsc = mp_j.down_scaler.rns_scaler, mp_t.down_scaler.rns_scaler
        start, size = 0, k
    assert tsc.dtype == torch.int32
    moduli = tsc.from_ctx.moduli_u64
    x = _residues(moduli, (2,), 8192, 47)
    q = tsc.from_ctx.product
    for c, v in enumerate([0, 1, q - 1, q // 2 - 1, q // 2, q // 2 + 1, q // 3]):
        x[1, :, c] = [v % p for p in moduli]
    want = jax.jit(lambda a: jsc.scale(a, starting_index=start, size=size))(
        convert.words_to_lanes(x))
    got = tsc.scale(torch.from_numpy(x), start, size)
    assert got.dtype == torch.int32 and got.shape == (2, size, 8192)
    np.testing.assert_array_equal(_words(want), got.numpy())


# ---------------------------------------------------------------------------
# 6 and 7. Keys and programs at degree 64, 4 x 30 bits
# ---------------------------------------------------------------------------


class Pair:
    """Keys (sk, rk, the inner sum's Galois keys) and SIMD ciphertexts made
    by both packages from one seed."""

    def __init__(self, degree, seed, batch=2):
        self.n = degree
        self.jp, self.tp = _params(degree, [30] * 4)
        jr, tr = JRng(j_seed(seed)), ChaCha8Rng(seed_from_u64(seed))
        self.jsk = J.SecretKey.random(self.jp, jr)
        self.tsk = T.SecretKey.random(self.tp, tr)
        self.jrk = J.RelinearizationKey.new(self.jsk, jr)
        self.trk = T.RelinearizationKey.new(self.tsk, tr)
        self.jek = JEkb(self.jsk).enable_inner_sum().build(jr)
        self.tek = EvaluationKeyBuilder(self.tsk).enable_inner_sum().build(tr)
        vals = np.random.default_rng(seed)
        self.va = vals.integers(0, T_PLAIN, (batch, degree), dtype=np.uint64)
        self.vb = vals.integers(0, T_PLAIN, (batch, degree), dtype=np.uint64)
        self.jc, self.tc = [], []
        for v in np.concatenate([self.va, self.vb]):
            self.jc.append(self.jsk.try_encrypt(
                J.Plaintext.try_encode(v, J.Encoding.simd(), self.jp), jr))
            self.tc.append(self.tsk.try_encrypt(
                T.Plaintext.try_encode(v, T.Encoding.simd(), self.tp), tr))

    def args(self, which):
        """(a0, a1, b0, b1) batches: tpufhe's arrays or the port's tensors."""
        b = len(self.va)
        cts = self.jc if which == "j" else self.tc
        out = []
        for part in (cts[:b], cts[b:]):
            for i in (0, 1):
                if which == "j":
                    out.append(np.stack([np.asarray(c[i].coeffs) for c in part]))
                else:
                    out.append(torch.stack([c[i] for c in part]))
        return out

    def decrypt_both(self, c0, c1):
        """Decode (c0, c1) under both packages' secret keys; the noise must
        agree."""
        tct = T.Ciphertext(self.tp, [c0, c1], 0)
        ctx = self.jp.context_at_level(0)
        jct = J.Ciphertext(self.jp, [Poly(ctx, NTT, convert.from_tensor(c0)),
                                     Poly(ctx, NTT, convert.from_tensor(c1))], 0)
        assert self.tsk.measure_noise(tct) == self.jsk.measure_noise(jct)
        return (self.tsk.try_decrypt(tct).try_decode(T.Encoding.simd()),
                np.asarray(self.jsk.try_decrypt(jct).try_decode(J.Encoding.simd())))


@pytest.fixture(scope="module")
def pair64():
    return Pair(64, 61)


def _assert_ksk_equal(jksk, tksk):
    assert jksk.seed == tksk.seed
    for name in ("c0", "c1"):
        for i, poly in enumerate(getattr(jksk, name)):
            assert getattr(tksk, name)[i].dtype == torch.int32
            np.testing.assert_array_equal(_words(poly.coeffs),
                                          getattr(tksk, name)[i].numpy())
            np.testing.assert_array_equal(
                _words(poly.coeffs_shoup),
                getattr(tksk, name + "_shoup")[i].numpy())


def test_keys_and_ciphertexts_match_tpufhe(pair64):
    p = pair64
    np.testing.assert_array_equal(p.jsk.coeffs, p.tsk.coeffs)
    _assert_ksk_equal(p.jrk.ksk, p.trk.ksk)
    assert list(p.jek.gk) == list(p.tek.gk)
    for e, jgk in p.jek.gk.items():
        _assert_ksk_equal(jgk.ksk, p.tek.gk[e].ksk)
    for jc, tc in zip(p.jc, p.tc):
        assert jc.seed == tc.seed
        for i in (0, 1):
            assert tc[i].dtype == torch.int32
            np.testing.assert_array_equal(_words(jc[i].coeffs), tc[i].numpy())


def _want(p, program):
    t = T_PLAIN
    va, vb = p.va.astype(object), p.vb.astype(object)
    if program == "mul_relin":
        return (va * vb % t).astype(np.uint64)
    if program == "square":
        return (va * va % t).astype(np.uint64)
    if program == "rotate":
        h = p.n // 2
        return np.concatenate([np.roll(p.va[:, :h], -1, axis=1),
                               np.roll(p.va[:, h:], -1, axis=1)], axis=1)
    sums = (va.sum(axis=1) % t).astype(np.uint64)
    return np.repeat(sums[:, None], p.n, axis=1)


@pytest.mark.parametrize("program", ["mul_relin", "square", "rotate",
                                     "inner_sum"])
def test_programs_match_tpufhe_jitted(pair64, program):
    p = pair64
    ja, ta = p.args("j"), p.args("t")
    col = p.tek.rot_to_gk_exponent[1]
    if program == "mul_relin":
        jfn, tfn = j_make_mul_relin(p.jp, p.jrk), make_mul_relin(p.tp, p.trk)
    elif program == "square":
        jfn, tfn = (j_make_square_relin(p.jp, p.jrk),
                    make_square_relin(p.tp, p.trk))
        ja, ta = ja[:2], ta[:2]
    elif program == "rotate":
        jfn, tfn = j_make_rotate(p.jp, p.jek.gk[col]), make_rotate(p.tp, p.tek.gk[col])
        ja, ta = ja[:2], ta[:2]
    else:
        jfn, tfn = j_make_inner_sum(p.jp, p.jek), make_inner_sum(p.tp, p.tek)
        ja, ta = ja[:2], ta[:2]
    w0, w1 = jfn(*ja)
    c0, c1 = tfn(*ta)
    assert c0.dtype == torch.int32 and c0.shape == (len(p.va), 4, p.n)
    np.testing.assert_array_equal(_words(w0), c0.numpy())
    np.testing.assert_array_equal(_words(w1), c1.numpy())
    want = _want(p, program)
    for b in range(len(p.va)):
        got_t, got_j = p.decrypt_both(c0[b], c1[b])
        np.testing.assert_array_equal(got_t, want[b])
        np.testing.assert_array_equal(got_j, want[b])


def test_object_api_inner_sum_matches_program(pair64):
    """EvaluationKey.computes_inner_sum (ct_add and GaloisKey.relinearize
    on narrow ciphertexts) equals make_inner_sum."""
    p = pair64
    ct = p.tc[0]
    got = p.tek.computes_inner_sum(ct)
    c0, c1 = make_inner_sum(p.tp, p.tek)(ct[0], ct[1])
    assert torch.equal(got[0], c0) and torch.equal(got[1], c1)


def test_keys_carried_across_by_convert(pair64):
    p = pair64
    ksk = p.jrk.ksk
    rk = convert.relinearization_key(
        p.tp, ksk.seed, [np.asarray(q.coeffs) for q in ksk.c0],
        [np.asarray(q.coeffs_shoup) for q in ksk.c0],
        [np.asarray(q.coeffs) for q in ksk.c1],
        [np.asarray(q.coeffs_shoup) for q in ksk.c1])
    x = p.args("t")
    got = make_mul_relin(p.tp, rk)(*x)
    want = make_mul_relin(p.tp, p.trk)(*x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    sk = convert.secret_key(p.jsk.coeffs, p.tp)
    ct = convert.ciphertext(p.tp, [p.jc[0][0].coeffs, p.jc[0][1].coeffs])
    assert ct[0].dtype == torch.int32
    np.testing.assert_array_equal(
        sk.try_decrypt(ct).try_decode(T.Encoding.simd()), p.va[0])


# ---------------------------------------------------------------------------
# 8. Refusals
# ---------------------------------------------------------------------------


def test_refusals(pair64):
    p = pair64
    with pytest.raises(UnsupportedOperation):
        make_mul_relin(p.tp, p.trk, strategy2_primes=1)
    with pytest.raises(UnsupportedOperation):
        make_mul_relin(p.tp, p.trk, ext_fuse=True)
    # the narrow expansion runs (tests/test_torch_w30_levels.py): the inner
    # sum's keys hold x -> x^(N + 1), so both entry points expand by one
    # level, equal to tpufhe's
    assert p.tek.supports_expansion(1)
    c0, c1 = make_expand(p.tp, p.tek, 1)(p.tc[0][0][None], p.tc[0][1][None])
    for j, (jct, tct) in enumerate(zip(p.jek.expands(p.jc[0], 2),
                                       p.tek.expands(p.tc[0], 2))):
        for i, c in enumerate((c0, c1)):
            np.testing.assert_array_equal(_words(jct[i].coeffs), tct[i].numpy())
            assert torch.equal(c[j, 0], tct[i])
    with pytest.raises(InvalidContext):
        Context((P1, (1 << 62) - 57), N256, "cpu", narrow=True)
    ctx = p.tp.context_at_level(0)
    x = torch.from_numpy(_residues(ctx.moduli, (1,), p.n, 5))
    with pytest.raises(ValueError, match="expected cuda"):
        ntt32_cuda(x, ctx.tables, slice(None), False)
    mb = p.tp.context_level_at(0).mul_params()
    with pytest.raises(ValueError, match="expected cuda"):
        mb.extender.rns_scaler.scale_cuda(x, ctx.k, mb.to_ctx.k - ctx.k)
    with pytest.raises(ValueError, match="dtype"):
        ntt_forward(ctx, x.long())
    with pytest.raises(ValueError, match="dtype"):
        mb.extender.rns_scaler.scale(x.long(), ctx.k, mb.to_ctx.k - ctx.k)
