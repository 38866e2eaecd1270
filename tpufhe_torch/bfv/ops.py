"""Homomorphic operations on ciphertexts (fhe/src/bfv/ops/; tpufhe's
bfv/ops.py):

- element-wise add, sub and neg, and the plaintext add, sub and multiply
  (ops/mod.rs:15-257): plain ring glue on the level's rows;
- ct_mul and ct_square for any number of parts: extend both operands to the
  multiplication basis (Scaler.scale: K1 inverse, K2, K1 forward of the new
  limbs), the tensor product (K7 for two parts of two; the O(parts^2)
  glue otherwise), the t/q down-scale (K1 inverse, K2, K1 forward)
  (ops/mod.rs:259-341);
- Multiplicator with the default strategy and strategy 2 (ops/mul.rs:22-227);
- dot_product_scalar with deferred 128-bit accumulation, kernel ct_pt_dot
  (ops/dot_product.rs:56-152).

The empty ciphertext (Ciphertext.zero) is the identity of ct_add and
ct_sub, as in tpufhe.
"""

from __future__ import annotations

import torch

from tpufhe_torch.bfv.ciphertext import Ciphertext
from tpufhe_torch.bfv.parameters import BfvParameters
from tpufhe_torch.bfv.plaintext import Plaintext
from tpufhe_torch.errors import (
    ContextMismatch,
    DimensionMismatch,
    InvalidCiphertext,
    InvalidLevel,
    NoMoreContext,
    TooFewValues,
    UnsupportedOperation,
)
from tpufhe_torch.ops.dot import MAX_PARTS, ct_pt_dot
from tpufhe_torch.ops.rns import ScalingFactor
from tpufhe_torch.ops.rq import Context, Scaler
from tpufhe_torch.utils import obs
from tpufhe_torch.utils.primes import generate_prime


def _check_par(a: Ciphertext, b) -> None:
    if a.par != b.par:
        raise ContextMismatch("Incompatible BFV parameters")


def _context(a: Ciphertext, level: int, size: int | None = None):
    """a's context, which the other operand's level (and size) must share."""
    if a.level != level or (size is not None and len(a) != size):
        raise InvalidCiphertext("the operands differ in level or size")
    return a.par.context_at_level(a.level)


def ct_add(a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check_par(a, b)
    if not a.c:
        return b.clone()
    if not b.c:
        return a.clone()
    ctx = _context(a, b.level, len(b))
    return Ciphertext(a.par, [ctx.add(x, y) for x, y in zip(a.c, b.c)],
                      a.level)


def ct_sub(a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check_par(a, b)
    if not a.c:
        return ct_neg(b)
    if not b.c:
        return a.clone()
    ctx = _context(a, b.level, len(b))
    return Ciphertext(a.par, [ctx.sub(x, y) for x, y in zip(a.c, b.c)],
                      a.level)


def ct_neg(a: Ciphertext) -> Ciphertext:
    ctx = a.par.context_at_level(a.level)
    return Ciphertext(a.par, [ctx.neg(x) for x in a.c], a.level)


def ct_add_pt(a: Ciphertext, pt: Plaintext) -> Ciphertext:
    """Adds Delta m to the first part (ops/mod.rs:139-160)."""
    _check_par(a, pt)
    if not a.c:
        raise TooFewValues(0, 2)
    ctx = _context(a, pt.level)
    return Ciphertext(a.par, [ctx.add(a.c[0], pt.to_poly())] + a.c[1:],
                      a.level)


def ct_sub_pt(a: Ciphertext, pt: Plaintext) -> Ciphertext:
    _check_par(a, pt)
    if not a.c:
        raise TooFewValues(0, 2)
    ctx = _context(a, pt.level)
    return Ciphertext(a.par, [ctx.sub(a.c[0], pt.to_poly())] + a.c[1:],
                      a.level)


def ct_mul_pt(a: Ciphertext, pt: Plaintext) -> Ciphertext:
    """Every part times m lifted without Delta (pt.poly_ntt)
    (ops/mod.rs:229-238)."""
    _check_par(a, pt)
    if not a.c:
        return a.clone()
    ctx = _context(a, pt.level)
    m = pt.poly_ntt
    with obs.span("ct_mul_pt"):
        return Ciphertext(a.par, [ctx.mul(x, m) for x in a.c], a.level)


def _ct_value_equal(a: Ciphertext, b: Ciphertext) -> bool:
    """The reference's `ct0 == ct1` square detection (ops/mod.rs:259-341):
    identity first, then torch.equal part by part on the device."""
    if a is b:
        return True
    if len(a) != len(b) or a.level != b.level:
        return False
    return all(x is y or (x.shape == y.shape and torch.equal(x, y))
               for x, y in zip(a.c, b.c))


def _tensor_parts(ctx: Context, a: list, b: list, square: bool) -> list:
    """The NTT-domain tensor product c_(i+j) += a_i b_j over ctx. Two parts
    by two: K7 (tensor32 when narrow) in one launch, whose middle part
    a0 b1 + a1 b0 equals the square branch's doubled a0 a1. Otherwise the
    glue of tpufhe's loops, with the symmetry of a square."""
    from tpufhe_torch.pipeline import tensor

    if len(a) == 2 and len(b) == 2:
        return list(tensor(ctx, *a, *b))
    c = [None] * (len(a) + len(b) - 1)
    for i in range(len(a)):
        for j in range(i if square else 0, len(b)):
            prod = ctx.mul(a[i], b[j])
            if square and i != j:
                prod = ctx.add(prod, prod)
            c[i + j] = prod if c[i + j] is None else ctx.add(c[i + j], prod)
    return c


def ct_mul(a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """HPS multiplication of ciphertexts of any sizes: extend, tensor,
    down-scale by t/q (ops/mod.rs:259-341); len(a) + len(b) - 1 parts."""
    if not a.c:
        return a.clone()
    _check_par(a, b)
    _context(a, b.level)
    if not b.c:
        raise TooFewValues(0, 2)
    mp = a.par.context_level_at(a.level).mul_params()
    square = _ct_value_equal(a, b)
    a_ext = list(mp.extender.scale(torch.stack(a.c), ntt=True))
    b_ext = a_ext if square else list(
        mp.extender.scale(torch.stack(b.c), ntt=True))
    c = _tensor_parts(mp.to_ctx, a_ext, b_ext, square)
    return Ciphertext(a.par, list(mp.down_scaler.scale(torch.stack(c),
                                                       ntt=True)), a.level)


def ct_square(a: Ciphertext) -> Ciphertext:
    return ct_mul(a, a)


def _extended_basis(par: BfvParameters, ctx: Context, extra: int) -> list:
    """ctx's moduli, then `extra` 62-bit primes == 1 mod 2N taken downward
    from 2^62, skipping the moduli already in the list."""
    basis = list(ctx.moduli)
    upper = 1 << 62
    while len(basis) != ctx.k + extra:
        upper = generate_prime(62, 2 * par.degree(), upper)
        if upper not in basis:
            basis.append(upper)
    return basis


class Multiplicator:
    """A multiplication strategy (ops/mul.rs:22-227): the lhs and rhs
    extenders into the extended basis, the tensor product, the
    post-multiplication down-scale, and optionally the relinearization."""

    def __init__(self, lhs_scaling_factor: ScalingFactor,
                 rhs_scaling_factor: ScalingFactor, extended_basis,
                 post_mul_scaling_factor: ScalingFactor,
                 par: BfvParameters, level: int = 0):
        base_ctx = par.context_at_level(level)
        if base_ctx.narrow:
            # the strategies extend into 62-bit primes, which a narrow
            # context's int32 rows cannot be scaled into
            raise UnsupportedOperation(
                "Multiplicator is not defined for narrow (w30) parameters")
        mul_ctx = Context(tuple(extended_basis), par.degree(), par.device)
        self.par = par
        self.extender_lhs = Scaler(base_ctx, mul_ctx, lhs_scaling_factor)
        self.extender_rhs = Scaler(base_ctx, mul_ctx, rhs_scaling_factor)
        self.down_scaler = Scaler(mul_ctx, base_ctx, post_mul_scaling_factor)
        self.base_ctx = base_ctx
        self.mul_ctx = mul_ctx
        self.rk = None
        self.mod_switch = False
        self.level = level

    @staticmethod
    def default(rk) -> "Multiplicator":
        """The standard HPS strategy (ops/mul.rs:100-130)."""
        par = rk.ksk.par
        ctx = par.context_at_level(rk.ksk.ciphertext_level)
        extra = -((-(sum(par.moduli_sizes[: ctx.k]) + 60)) // 62)
        m = Multiplicator(ScalingFactor.one(), ScalingFactor.one(),
                          _extended_basis(par, ctx, extra),
                          ScalingFactor(par.plaintext.value, ctx.modulus()),
                          par, rk.ksk.ciphertext_level)
        m.enable_relinearization(rk)
        return m

    @staticmethod
    def strategy2(rk, extension_primes: int = 2) -> "Multiplicator":
        """The second strategy of eprint 2021/204 (tpufhe's, ops/mul.rs:
        353-402): the lhs extends exactly, the rhs is scaled by P/q into
        q + P, the tensor is scaled by t/P, with P the product of
        `extension_primes` new primes."""
        par = rk.ksk.par
        ctx = par.context_at_level(rk.ksk.ciphertext_level)
        basis = _extended_basis(par, ctx, extension_primes)
        p_prod = 1
        for p in basis[ctx.k:]:
            p_prod *= p
        m = Multiplicator(ScalingFactor.one(),
                          ScalingFactor(p_prod, ctx.modulus()), basis,
                          ScalingFactor(par.plaintext.value, p_prod), par,
                          rk.ksk.ciphertext_level)
        m.enable_relinearization(rk)
        return m

    def enable_relinearization(self, rk):
        rk_ctx = self.par.context_at_level(rk.ksk.ciphertext_level)
        if rk_ctx is not self.base_ctx:
            raise ContextMismatch("Invalid relinearization key context")
        self.rk = rk

    def enable_mod_switching(self):
        if self.par.context_at_level(self.par.max_level()) is self.base_ctx:
            raise NoMoreContext()
        self.mod_switch = True

    def multiply(self, lhs: Ciphertext, rhs: Ciphertext) -> Ciphertext:
        """lhs * rhs, relinearized when a key is set and switched one
        level down when mod switching is on: extenders (K1 inverse, K2, K1
        forward each), K7, the down-scale, RelinearizationKey.relinearizes,
        then Ciphertext.switch_down."""
        if lhs.par != self.par or rhs.par != self.par:
            raise ContextMismatch("Ciphertexts do not have the same parameters")
        if lhs.level != self.level or rhs.level != self.level:
            raise InvalidLevel(lhs.level, self.level, self.level)
        if len(lhs) != 2 or len(rhs) != 2:
            raise InvalidCiphertext(
                "Multiplication requires size-2 ciphertexts")
        a = self.extender_lhs.scale(torch.stack(lhs.c), ntt=True)
        b = self.extender_rhs.scale(torch.stack(rhs.c), ntt=True)
        c = _tensor_parts(self.mul_ctx, list(a), list(b), False)
        ct = Ciphertext(self.par, list(self.down_scaler.scale(torch.stack(c),
                                                               ntt=True)),
                        self.level)
        if self.rk is not None:
            self.rk.relinearizes(ct)
        if self.mod_switch:
            ct.switch_down()
        return ct


def dot_product_scalar(cts: list, pts: list) -> Ciphertext:
    """sum_i cts[i] pts[i].poly_ntt over min(len) terms, every part at once
    on kernel ct_pt_dot (ops/dot_product.rs:56-152)."""
    count = min(len(cts), len(pts))
    if count == 0:
        raise TooFewValues(0, 1)
    first = cts[0]
    nparts = len(first)
    for ct in cts:
        if len(ct) != nparts or ct.par != first.par:
            raise DimensionMismatch(
                "dot_product_scalar requires uniform ciphertexts")
    if nparts == 0:
        return Ciphertext(first.par, [], first.level)
    ctx = first.par.context_at_level(first.level)
    k, n = ctx.k, ctx.degree
    lead = first[0].shape[:-2]
    parts = [torch.stack([ct[i] for ct in cts[:count]]).reshape(count, -1, k, n)
             for i in range(nparts)]
    db = torch.stack([pt.poly_ntt for pt in pts[:count]])[:, None]
    # (nparts, 1, B, k, N), at most MAX_PARTS parts a launch
    out = torch.cat([ct_pt_dot(ctx, parts[i:i + MAX_PARTS], db)
                     for i in range(0, nparts, MAX_PARTS)])
    return Ciphertext(first.par, [x.reshape(lead + (k, n)) for x in out[:, 0]],
                      first.level)
