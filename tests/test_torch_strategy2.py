"""The port's strategy-2 multiply + relinearize, square + relinearize and
fused extend against tpufhe, all bit-exact (tolerance 0):

- the plain version of K7 (tensor product) against tpufhe's Pallas kernel
  in interpret mode, at the shapes of tests/test_tensor_pallas.py;
- the plain version of K8 (inverse NTT + HPS scale) at degree 1024, for
  the extend and the strategy-2 rhs, against tpufhe's Pallas kernel in
  interpret mode at 2 limbs, as tests/test_intt_scale.py does, and against
  its XLA composition at 3 limbs, where tpufhe's kernel does not run;
- the plain scaler (K2) at strategy 2's two new scalings (P/q into every
  limb, t/P out of 4 and 5 limbs) against tpufhe's exact scale_host at
  degree 1024;
- make_mul_relin(strategy2_primes=kP, ext_fuse=...) and make_square_relin
  against tpufhe's programs run eagerly at degree 16, with the
  multiplication bases compared;
- the products decrypt to va vb and va^2 mod t under both packages' keys
  at degree 64, t = 257, as tests/test_strategy2.py runs them;
- the refusals: ext_fuse where the limbs do not fit, the launching
  wrappers on CPU tensors.
"""

import inspect
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe.ops.pallas.intt_scale_kernel import intt_scale_ok, intt_scale_pallas
from tpufhe.ops.pallas.tensor_kernel import tensor_product_pallas
from tpufhe.ops.rns import ScalingFactor as JScalingFactor
from tpufhe.ops.rq import NTT, Poly
from tpufhe.ops.rq import Context as JContext
from tpufhe.ops.rq import Scaler as JScaler
from tpufhe.ops.rq import ntt_backward_any
from tpufhe.pipeline import build_mul_relin_step as j_build_mul_relin_step
from tpufhe.pipeline import make_square_relin as j_make_square_relin
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed

import tpufhe_torch.bfv as T
from tpufhe_torch import convert
from tpufhe_torch.errors import UnsupportedOperation
from tpufhe_torch.ops.intt_scale import (
    intt_scale,
    intt_scale_cuda,
    intt_scale_fits,
)
from tpufhe_torch.ops.rq import Context
from tpufhe_torch.pipeline import (
    make_mul_relin,
    make_square_relin,
    mul_basis,
    tensor,
    tensor_cuda,
)
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64


def _params(degree, t, sizes):
    jp = (J.BfvParametersBuilder().set_degree(degree).set_plaintext_modulus(t)
          .set_moduli_sizes(sizes).build())
    tp = (T.BfvParametersBuilder().set_degree(degree).set_plaintext_modulus(t)
          .set_moduli_sizes(sizes).set_device("cpu").build())
    return jp, tp


def _residues(moduli, lead, n, seed):
    """Canonical (lead..., k, n) int64 residues; the first row all p - 1."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, p, lead + (n,), dtype=np.uint64)
                  for p in moduli], axis=-2)
    x.reshape((-1, len(moduli), n))[0] = np.array(moduli, dtype=np.uint64)[:, None] - 1
    return x.astype(np.int64)


def _words(arr):
    return convert.lanes_to_words(np.asarray(arr))


def _product(moduli):
    out = 1
    for p in moduli:
        out *= int(p)
    return out


# ---------------------------------------------------------------------------
# K7 and K8: plain versions against tpufhe's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

TENSOR_Q = [4611686018326724609, 4611686018309947393, 1152921504606830593]


@pytest.mark.parametrize("lead", [(), (3,)], ids=["one", "batch3"])
def test_tensor_plain_matches_pallas_kernel(lead):
    n = 256
    jctx, tctx = JContext(TENSOR_Q, n), Context(TENSOR_Q, n, device="cpu")
    ops = [_residues(TENSOR_Q, lead, n, 11 + i) for i in range(4)]
    want = tensor_product_pallas(jctx, *(convert.words_to_lanes(a) for a in ops),
                                 interpret=True)
    got = tensor(tctx, *(torch.from_numpy(a) for a in ops))
    assert got.shape == (3,) + lead + (3, n)
    np.testing.assert_array_equal(_words(want), got.numpy())


@pytest.fixture(scope="module")
def params_1024():
    return _params(1024, 65537, [62, 62, 62])


@pytest.fixture(scope="module")
def params_1024_k2():
    return _params(1024, 65537, [62, 62])


def _fused_scalers(jp, tp, which):
    """tpufhe's and the port's scaler of the extend or the kP = 2 rhs, with
    the output rows (start, size)."""
    jctx = jp.context_at_level(0)
    if which == "extend":
        mp = jp.context_level_at(0).mul_params()
        return (mp.extender.rns_scaler, mul_basis(tp).ext, jctx.k,
                mp.to_ctx.k - jctx.k)
    mb = mul_basis(tp, strategy2_primes=2)
    basis = mb.ctx_mul.moduli
    jsc = JScaler(jctx, JContext(basis, jp.degree()),
                  JScalingFactor(_product(basis[jctx.k:]), jctx.modulus()))
    return jsc.rns_scaler, mb.rhs, 0, len(basis)


@pytest.mark.parametrize("which", ["extend", "strategy2_rhs"])
@pytest.mark.parametrize("limbs", [2, 3])
def test_intt_scale_plain_matches_tpufhe(params_1024, params_1024_k2, which,
                                         limbs):
    """At 2 limbs against tpufhe's fused kernel in interpret mode. At 3
    limbs (BASELINE config 3's basis) tpufhe's kernel refuses the scaler
    (its balanced-byte thetas do not fit, rns_kernel._bc_thetas_fit) and
    runs the split launches, so the oracle there is their XLA composition,
    scale(ntt_backward_any(x)), which tests/test_intt_scale.py holds equal
    to the kernel where the kernel runs."""
    jp, tp = params_1024 if limbs == 3 else params_1024_k2
    jctx, tctx = jp.context_at_level(0), tp.context_at_level(0)
    jsc, tsc, start, size = _fused_scalers(jp, tp, which)
    x = _residues(tctx.moduli, (2,), 1024, 31)
    lanes = convert.words_to_lanes(x)
    if limbs == 2:
        assert intt_scale_ok(jctx, jsc, start, size)
        want = intt_scale_pallas(lanes, jctx, jsc, start, size, interpret=True)
    else:
        assert not intt_scale_ok(jctx, jsc, start, size)
        want = jax.jit(lambda a: jsc.scale(
            ntt_backward_any(jctx, a, in_bits=62), starting_index=start,
            size=size))(lanes)
    got = intt_scale(tctx, tsc, torch.from_numpy(x), start, size)
    np.testing.assert_array_equal(_words(want), got.numpy())


# ---------------------------------------------------------------------------
# K2 at strategy 2's new scalings (degree 1024, against scale_host)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kp", [1, 2])
@pytest.mark.parametrize("which", ["rhs", "down"])
def test_strategy2_scalers_match_scale_host(params_1024, kp, which):
    jp, tp = params_1024
    jctx = jp.context_at_level(0)
    mb = mul_basis(tp, strategy2_primes=kp)
    basis = mb.ctx_mul.moduli
    jmul = JContext(basis, 1024)
    p_prod = _product(basis[jctx.k:])
    if which == "rhs":
        jsc = JScaler(jctx, jmul,
                      JScalingFactor(p_prod, jctx.modulus())).rns_scaler
        tsc, start, size = mb.rhs, 0, len(basis)
    else:
        jsc = JScaler(jmul, jctx, JScalingFactor(65537, p_prod)).rns_scaler
        tsc, start, size = mb.down, 0, jctx.k
    assert tsc.theta_garner_shift == jsc.theta_garner_shift
    moduli = tsc.from_ctx.moduli_u64
    x = _residues(moduli, (2,), 1024, 7 + kp)
    q = tsc.from_ctx.product
    specials = [0, 1, q - 1, q // 2 - 1, q // 2, q // 2 + 1, q // 3, q // 4]
    for c, v in enumerate(specials):
        x[1, :, c] = [v % p for p in moduli]
    got = tsc.scale(torch.from_numpy(x), start, size).numpy()
    for r in range(2):
        for c in range(0, 1024, 1 if r else 5):
            want = jsc.scale_host([int(v) for v in x[r, :, c]], size=size,
                                  starting_index=start)
            assert [int(v) for v in got[r, :, c]] == want, (r, c)


# ---------------------------------------------------------------------------
# Programs against tpufhe at degree 16
# ---------------------------------------------------------------------------


class Pair:
    """The same keys and ciphertexts, made by both packages from one seed."""

    def __init__(self, degree, t, sizes, seed):
        self.jp, self.tp = _params(degree, t, sizes)
        self.t = t
        jr, tr = JRng(j_seed(seed)), ChaCha8Rng(seed_from_u64(seed))
        self.jsk = J.SecretKey.random(self.jp, jr)
        self.tsk = T.SecretKey.random(self.tp, tr)
        self.jrk = J.RelinearizationKey.new(self.jsk, jr)
        self.trk = T.RelinearizationKey.new(self.tsk, tr)
        vals = np.random.default_rng(seed)
        self.va = vals.integers(0, t, degree, dtype=np.uint64)
        self.vb = vals.integers(0, t, degree, dtype=np.uint64)
        self.jc, self.tc = [], []
        for v in (self.va, self.vb):
            self.jc.append(self.jsk.try_encrypt(
                J.Plaintext.try_encode(v, J.Encoding.simd(), self.jp), jr))
            self.tc.append(self.tsk.try_encrypt(
                T.Plaintext.try_encode(v, T.Encoding.simd(), self.tp), tr))

    def j_args(self):
        return tuple(c[i].coeffs for c in self.jc for i in (0, 1))

    def t_args(self):
        return tuple(c[i] for c in self.tc for i in (0, 1))


@pytest.fixture(scope="module")
def pair16():
    return Pair(16, 65537, [62] * 3, 51)


@pytest.fixture(scope="module")
def tpufhe_products(pair16):
    """tpufhe's strategy-2 mul+relin products at degree 16, eager, by kP,
    with the multiplication basis it used."""
    out = {}
    for kp in (1, 2):
        step = j_build_mul_relin_step(pair16.jp, pair16.jrk, strategy2_primes=kp)
        ctx_mul = inspect.getclosurevars(step).nonlocals["ctx_mul"]
        with jax.disable_jit():
            w0, w1 = step(*pair16.j_args())
        out[kp] = (_words(w0), _words(w1), tuple(ctx_mul.moduli))
    return out


@pytest.mark.parametrize("kp,fused", [(1, False), (1, True), (2, False),
                                      (2, True)])
def test_strategy2_mul_relin_matches_tpufhe(pair16, tpufhe_products, kp,
                                            fused):
    p = pair16
    w0, w1, j_basis = tpufhe_products[kp]
    basis = mul_basis(p.tp, strategy2_primes=kp).ctx_mul.moduli
    assert tuple(basis) == j_basis
    # the first primes below 2^62 == 1 mod 2N are the ciphertext moduli,
    # which the basis loop skips
    assert basis[:3] == p.tp.moduli and len(set(basis)) == 3 + kp
    fn = make_mul_relin(p.tp, p.trk, strategy2_primes=kp, ext_fuse=fused)
    c0, c1 = fn(*p.t_args())
    np.testing.assert_array_equal(w0, c0.numpy())
    np.testing.assert_array_equal(w1, c1.numpy())


def test_default_fused_equals_split(pair16):
    """The default strategy with the fused extend gives the split step's
    integers, which tests/test_torch_pipeline.py holds equal to tpufhe's."""
    p = pair16
    split = make_mul_relin(p.tp, p.trk)(*p.t_args())
    fused = make_mul_relin(p.tp, p.trk, ext_fuse=True)(*p.t_args())
    assert all(torch.equal(a, b) for a, b in zip(split, fused))


def test_square_relin_matches_tpufhe(pair16):
    p = pair16
    a = p.j_args()
    with jax.disable_jit():
        w0, w1 = j_make_square_relin(p.jp, p.jrk)(a[0], a[1])
    c0, c1 = make_square_relin(p.tp, p.trk)(*p.t_args()[:2])
    np.testing.assert_array_equal(_words(w0), c0.numpy())
    np.testing.assert_array_equal(_words(w1), c1.numpy())


# ---------------------------------------------------------------------------
# Decryption under both packages' keys (degree 64, t = 257)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair64():
    return Pair(64, 257, [62, 62], 21)


@pytest.mark.parametrize("variant", ["kp1", "kp2", "kp2_fused", "square"])
def test_products_decrypt_under_both_keys(pair64, variant):
    p = pair64
    a0, a1, b0, b1 = p.t_args()
    if variant == "square":
        c0, c1 = make_square_relin(p.tp, p.trk)(a0, a1)
        want = p.va.astype(object) ** 2 % p.t
    else:
        fn = make_mul_relin(p.tp, p.trk, strategy2_primes=int(variant[2]),
                            ext_fuse=variant.endswith("fused"))
        c0, c1 = fn(a0, a1, b0, b1)
        want = p.va.astype(object) * p.vb.astype(object) % p.t
    want = want.astype(np.uint64)
    tct = T.Ciphertext(p.tp, [c0, c1], 0)
    np.testing.assert_array_equal(
        p.tsk.try_decrypt(tct).try_decode(T.Encoding.simd()), want)
    ctx = p.jp.context_at_level(0)
    jct = J.Ciphertext(p.jp, [Poly(ctx, NTT, convert.from_tensor(c0)),
                              Poly(ctx, NTT, convert.from_tensor(c1))], 0)
    np.testing.assert_array_equal(
        np.asarray(p.jsk.try_decrypt(jct).try_decode(J.Encoding.simd())), want)
    noise = p.tsk.measure_noise(tct)
    assert noise == p.jsk.measure_noise(jct)
    assert noise < sum(p.jp.moduli_sizes) - 9 - 1  # log2(q / t) - 1


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def test_intt_scale_fits():
    assert intt_scale_fits(3, 8192)
    assert not intt_scale_fits(4, 8192)  # 256 KB of shared memory
    assert intt_scale_fits(16, 1024)
    assert intt_scale_fits(17, 16)  # the scaler body takes any k_in
    assert not intt_scale_fits(0, 16)


def test_ext_fuse_refused_where_limbs_do_not_fit():
    """4 x 62-bit limbs at N = 8192 do not fit one block: the builder
    raises before any key material is touched, and without ext_fuse the
    same parameters build."""
    tp = (T.BfvParametersBuilder().set_degree(8192).set_plaintext_modulus(65537)
          .set_moduli_sizes([62] * 4).set_device("cpu").build())
    rk = SimpleNamespace(ksk=SimpleNamespace(ciphertext_level=0, ksk_level=0,
                                            log_base=0))
    for kp in (None, 1):
        with pytest.raises(UnsupportedOperation):
            make_mul_relin(tp, rk, strategy2_primes=kp, ext_fuse=True)
        make_mul_relin(tp, rk, strategy2_primes=kp)


def test_launching_wrappers_refuse_cpu_tensors(params_1024):
    _, tp = params_1024
    ctx = tp.context_at_level(0)
    mb = mul_basis(tp)
    x = torch.from_numpy(_residues(ctx.moduli, (1,), 1024, 3))
    with pytest.raises(ValueError, match="expected cuda"):
        tensor_cuda(ctx, x, x, x, x)
    with pytest.raises(ValueError, match="expected cuda"):
        intt_scale_cuda(ctx, mb.ext, x, ctx.k, mb.ctx_mul.k - ctx.k)
    x_mul = torch.from_numpy(_residues(mb.ctx_mul.moduli, (1,), 1024, 4))
    with pytest.raises(ValueError, match="input basis"):
        intt_scale(mb.ctx_mul, mb.ext, x_mul, 0, 1)
    with pytest.raises(ValueError, match="out of range"):
        intt_scale(ctx, mb.ext, x, ctx.k, mb.ctx_mul.k)
