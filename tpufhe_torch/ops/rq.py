"""Polynomials in R_q[x] = Z_q[x]/(x^N + 1) with RNS coefficients: the
port of tpufhe.ops.rq (fhe-math/src/rq/): contexts, the functions on
coefficient tensors that the BFV operations and programs call (the NTT,
the modulus switch-down, the Galois substitution, the context-to-context
scaler and switcher, the deferred-reduction dot product), and ``Poly``,
the object API's typestate over one tensor.

Coefficients are tensors shaped (..., k, N), one canonical residue per
word (int64, or int32 for a narrow w30 context), in power basis or in
bit-reversed NTT order; leading dimensions are batch. A ``Context`` holds
the moduli, their NTT operators and the per-limb tables on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufhe_torch.device import resolve_device
from tpufhe_torch.errors import (
    ContextMismatch,
    IncorrectRepresentation,
    InvalidContext,
    InvalidGaloisElement,
    NoMoreContext,
    TooFewValues,
    UnsupportedOperation,
)
from tpufhe_torch.ops import ntt as ntt_mod
from tpufhe_torch.ops import zq, zq32
from tpufhe_torch.ops.dot import ct_pt_dot
from tpufhe_torch.ops.rns import RnsContext, RnsScaler, ScalingFactor
from tpufhe_torch.ops.zq import Modulus
from tpufhe_torch.utils.obs import count
from tpufhe_torch.utils.rngs import expand_seed
from tpufhe_torch.utils.sampling import sample_vec_cbd

POWER_BASIS = "power"
NTT = "ntt"
NTT_SHOUP = "ntt_shoup"

_CONTEXT_CACHE: dict = {}


class Context:
    """Moduli + NTT operators + RNS context of one ring, on one device.

    Mirrors rq/context.rs:9-156. Cached by (moduli, degree, device,
    narrow); ``next_context`` drops the last modulus (the switch-down
    chain).

    ``narrow=True`` selects tpufhe's single-word w30 representation (every
    modulus below 2^30): rows are int32 (``dtype``), the NTT is kernel K9
    and the elementwise arithmetic ops/zq32.py. Wide and narrow contexts
    over the same moduli are distinct objects. ``add``, ``sub``, ``neg``,
    ``mul`` and ``mul_shoup`` are the elementwise ring operations on rows
    of the context's word type, in either mode.
    """

    def __new__(cls, moduli, degree: int, device=None, narrow: bool = False):
        device = resolve_device(device)
        key = (tuple(int(m) for m in moduli), int(degree), str(device),
               bool(narrow))
        if key in _CONTEXT_CACHE:
            return _CONTEXT_CACHE[key]
        self = super().__new__(cls)
        self._init(key[0], key[1], device, key[3])
        _CONTEXT_CACHE[key] = self
        return self

    def _init(self, moduli, degree, device, narrow):
        if degree < 8 or (degree & (degree - 1)) != 0:
            raise InvalidContext(
                "The degree is not a power of two larger or equal to 8")
        if narrow and any(m >= (1 << 30) for m in moduli):
            raise InvalidContext("narrow contexts need all moduli < 2^30")
        self.narrow = narrow
        self.moduli = moduli
        self.degree = degree
        self.device = device
        self.rns = RnsContext(list(moduli))
        self.q = [Modulus(m) for m in moduli]
        self.ops = []
        for qi in self.q:
            op = ntt_mod.NttOperator.new(qi, degree)
            if op is None:
                raise InvalidContext("Impossible to construct a Ntt operator")
            self.ops.append(op)
        self._tables = None
        self._switch = None

    @property
    def k(self) -> int:
        return len(self.moduli)

    @property
    def next_context(self) -> "Context | None":
        """The context without the last modulus, None for one modulus."""
        if self.k < 2:
            return None
        return Context(self.moduli[:-1], self.degree, self.device,
                       self.narrow)

    def context_at_level(self, i: int) -> "Context":
        """The context i switch-downs below this one (tpufhe
        rq.py:163-169); NoMoreContext past the last."""
        cur = self
        for _ in range(i):
            cur = cur.next_context
            if cur is None:
                raise NoMoreContext()
        return cur

    def niterations_to(self, other: "Context") -> int:
        """Switch-downs from this context to `other` (rq/context.rs:120-137)."""
        n, cur = 0, self
        while cur is not other:
            cur = cur.next_context
            if cur is None:
                raise InvalidContext("Invalid context (not in chain)")
            n += 1
        return n

    def modulus(self) -> int:
        return self.rns.product

    @property
    def dtype(self) -> torch.dtype:
        """The word type of the context's rows."""
        return torch.int32 if self.narrow else torch.int64

    @property
    def tables(self) -> ntt_mod.NttTables:
        """Per-limb device tables (built on first use)."""
        if self._tables is None:
            self._tables = ntt_mod.NttTables.build(self.ops, self.device,
                                                   self.narrow)
        return self._tables

    @property
    def mod(self) -> zq.ModTable:
        """Constants of the int64 elementwise ops of ops/zq.py, shape (k, 1)
        (in either mode; the narrow rows' own ops take ``p_col``)."""
        return self.tables.mod

    @property
    def p_col(self) -> torch.Tensor:
        """The moduli as a (k, 1) tensor of the context's word type."""
        return self.tables.p[:, None] if self.narrow else self.mod.p

    def add(self, a, b):
        return zq32.add(a, b, self.p_col) if self.narrow else zq.add(a, b, self.mod)

    def sub(self, a, b):
        return zq32.sub(a, b, self.p_col) if self.narrow else zq.sub(a, b, self.mod)

    def neg(self, a):
        return zq32.neg(a, self.p_col) if self.narrow else zq.neg(a, self.mod)

    def mul(self, a, b):
        return zq32.mul(a, b, self.p_col) if self.narrow else zq.mul(a, b, self.mod)

    def mul_shoup(self, a, b, b_shoup):
        """a b mod p with b's Shoup constants (2^32-scaled when narrow)."""
        if self.narrow:
            return zq32.mul_shoup(a, b, b_shoup, self.p_col)
        return zq.mul_shoup(a, b, b_shoup, self.mod)

    def __repr__(self):
        return (f"Context(moduli={self.moduli}, degree={self.degree}, "
                f"device={self.device}, narrow={self.narrow})")


def ntt_forward(ctx: Context, x: torch.Tensor,
                limb_slice: slice | None = None,
                lazy: bool = False) -> torch.Tensor:
    """Forward NTT of canonical (..., k_sel, N) rows (K1 on the card, K9
    for a narrow context). Counterpart of tpufhe.ops.rq.ntt_forward_any.
    lazy: the words are left below 4p, congruent to the canonical output
    (on the card; the plain version returns the canonical words), as
    tpufhe's lazy forward leaves them."""
    return ntt_mod.ntt_transform(x, ctx.tables, limb_slice, inverse=False,
                                 lazy=lazy)


def ntt_backward(ctx: Context, x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT of canonical (..., k, N) rows (K1 on the card, K9 for a
    narrow context). Counterpart of tpufhe.ops.rq.ntt_backward_any."""
    return ntt_mod.ntt_transform(x, ctx.tables, None, inverse=True)


def _switch_tables(ctx: Context) -> tuple:
    """(q_last^-1, its Shoup constant, floor(q_last / 2)) mod each of the
    first k - 1 moduli, (k - 1, 1) columns of the context's word type."""
    if ctx._switch is None:
        q_last = ctx.moduli[-1]
        rest = ctx.q[:-1]
        inv = [q.inv(q.reduce(q_last)) for q in rest]
        shoup = ([q.shoup32(v) for q, v in zip(rest, inv)] if ctx.narrow
                 else zq.as_int64(np.array(
                     [q.shoup(v) for q, v in zip(rest, inv)], np.uint64)))
        half = [(q_last // 2) % q.p for q in rest]

        def col(vals):
            return torch.tensor(np.asarray(vals, np.int64), device=ctx.device
                                ).to(ctx.dtype)[:, None]

        ctx._switch = (col(inv), col(shoup), col(half))
    return ctx._switch


def switch_down(ctx: Context, x: torch.Tensor) -> torch.Tensor:
    """Power-basis (..., k, N) rows of ctx divided by the last modulus and
    rounded, (..., k - 1, N) rows of ctx.next_context (tpufhe
    Poly.switch_down and _switch_down_fn, rq/mod.rs:390-449, eprint
    2018/931 Alg. 2): out_i = (x_i + floor(q_last / 2) - x') q_last^-1 mod
    q_i with x' = (x_last + floor(q_last / 2)) mod q_last. Canonical in and
    out, wide or narrow; plain torch on every device, as tpufhe's is XLA.
    Counted as ``rq.switch_down``, beside the glue calls it makes."""
    count("rq.switch_down")
    nxt = ctx.next_context
    if nxt is None:
        raise NoMoreContext()
    if x.shape[-2:] != (ctx.k, ctx.degree):
        raise InvalidContext(f"switch_down: rows {tuple(x.shape)}, expected "
                             f"(..., {ctx.k}, {ctx.degree})")
    inv, inv_shoup, half = _switch_tables(ctx)
    q_last = ctx.moduli[-1]
    last = x[..., -1:, :] + q_last // 2
    last = torch.where(last >= q_last, last - q_last, last)
    rest = nxt.add(x[..., :-1, :], half)
    rest = nxt.sub(rest, torch.remainder(last, nxt.p_col))
    return nxt.mul_shoup(rest, inv, inv_shoup)


def switch_down_to(ctx: Context, target: Context, x: torch.Tensor
                   ) -> torch.Tensor:
    """switch_down from ctx until the rows are target's (Poly.switch_down_to)."""
    for _ in range(ctx.niterations_to(target)):
        x = switch_down(ctx, x)
        ctx = ctx.next_context
    return x


def from_i64_coeffs(coeffs, ctx: Context) -> torch.Tensor:
    """Signed coefficients (N,) reduced into every limb: (k, N) power basis
    of the context's word type (rq/convert.rs TryConvertFrom<&[i64]>)."""
    v = np.zeros(ctx.degree, dtype=np.int64)
    v[: len(coeffs)] = np.asarray(coeffs, dtype=np.int64)
    t = torch.from_numpy(v).to(ctx.device)
    return torch.remainder(t[None, :], ctx.mod.p).to(ctx.dtype)


def from_u64_coeffs(coeffs, ctx: Context) -> torch.Tensor:
    """Unsigned coefficients below 2^63, reduced into every limb."""
    v = np.zeros(ctx.degree, dtype=np.uint64)
    cs = np.asarray(coeffs, dtype=np.uint64)
    v[: len(cs)] = cs
    t = torch.from_numpy(zq.as_int64(v)).to(ctx.device)
    if (t < 0).any():
        raise ValueError("coefficients must be below 2^63")
    return torch.remainder(t[None, :], ctx.mod.p).to(ctx.dtype)


def random_rows(ctx: Context, rng) -> torch.Tensor:
    """Uniform (k, N) residues sampled limb by limb (rq/mod.rs:226-237)."""
    rows = np.stack([q.random_vec(ctx.degree, rng) for q in ctx.q])
    words = rows.astype(np.int32) if ctx.narrow else zq.as_int64(rows)
    return torch.from_numpy(words).to(ctx.device)


def random_from_seed(ctx: Context, seed: bytes) -> torch.Tensor:
    """Deterministic expansion: ChaCha8(SHA-256(seed)) (rq/mod.rs:241-257)."""
    return random_rows(ctx, expand_seed(seed))


def shoup_of(x: torch.Tensor, moduli) -> torch.Tensor:
    """Shoup constants of canonical (..., k, N) residues, same device and
    word type: floor(v 2^64 / p) for int64 rows (stored by bit pattern),
    floor(v 2^32 / p) for the int32 rows of a narrow context (tpufhe's
    shoup32). Exact Python ints on the host."""
    vals = x.cpu().numpy()
    if x.dtype == torch.int32:
        return torch.from_numpy(zq32.shoup_array(vals, moduli)).to(x.device)
    arr = zq.shoup_array(vals.astype(np.uint64), moduli)
    return torch.from_numpy(zq.as_int64(arr)).to(x.device)


def lift_bigints(ctx: Context, coeffs: torch.Tensor) -> list:
    """CRT-lift each coefficient of a (k, N) power-basis poly into [0, q)."""
    mat = coeffs.cpu().numpy()
    return [ctx.rns.lift([int(mat[i, j]) for i in range(ctx.k)])
            for j in range(ctx.degree)]


class SubstitutionExponent:
    """Galois automorphism x -> x^exponent (rq/mod.rs:88-121), as gather
    tables on the context's device: ``perm_ntt`` for NTT-domain rows,
    ``perm_power`` and ``sign_power`` (True = negate) for power-basis rows.
    """

    def __init__(self, ctx: Context, exponent: int):
        n = ctx.degree
        exponent = exponent % (2 * n)
        if exponent % 2 == 0:
            raise InvalidGaloisElement(
                exponent, "the exponent should be odd modulo 2 * degree")
        self.ctx = ctx
        self.exponent = exponent
        mask = n - 1
        bitrev = ntt_mod.bitrev_indices(n)
        # NTT domain: out[bitrev[j]] = in[bitrev[((e - 1) / 2 + j e) mod n]]
        power = ((exponent - 1) // 2 + np.arange(n, dtype=np.int64) * exponent)
        perm_ntt = bitrev[power & mask][bitrev]
        # power basis: out[(j e) mod n] = (-1)^floor(j e / n) in[j]
        power = np.arange(n, dtype=np.int64) * exponent
        src = np.empty(n, dtype=np.int64)
        src[power & mask] = np.arange(n)
        sign = np.empty(n, dtype=bool)
        sign[power & mask] = (power & n) != 0
        self.perm_ntt = torch.from_numpy(perm_ntt).to(ctx.device)
        self.perm_power = torch.from_numpy(src).to(ctx.device)
        self.sign_power = torch.from_numpy(sign).to(ctx.device)


def substitute(x: torch.Tensor, exp: SubstitutionExponent,
               ntt: bool) -> torch.Tensor:
    """x(X) -> x(X^e) on (..., k, N) rows of exp's context, NTT domain or
    power basis (tpufhe.ops.rq.Poly.substitute): a gather along the last
    axis, and for power-basis rows a negation where ``sign_power`` is set."""
    count("glue.rq.substitute")
    if ntt:
        return x[..., exp.perm_ntt]
    gathered = x[..., exp.perm_power]
    return torch.where(exp.sign_power, exp.ctx.neg(gathered), gathered)


def scale_into(to_ctx: Context, scaler: RnsScaler, x_pb: torch.Tensor,
               start: int, size: int, ntt: bool,
               ntt_fwd=ntt_forward) -> torch.Tensor:
    """Rows start .. start + size of `to_ctx` scaled from the power-basis
    rows x_pb (K2 on the card), forward-NTT'd with `to_ctx`'s tables for
    those rows only (K1's limb_slice) when `ntt`: the scaled half of
    tpufhe's Scaler.scale (rq.py:1303-1313) and the extend of the
    multiplication programs. ntt_fwd: the transform (make_mul_relin's
    hook)."""
    rows = scaler.scale(x_pb, starting_index=start, size=size)
    if not ntt:
        return rows
    return ntt_fwd(to_ctx, rows, limb_slice=slice(start, start + size))


class Scaler:
    """Context-to-context scaler with the common-moduli fast path
    (rq/scaler.rs:18-127): the first ``number_common_moduli`` rows are
    copied, the others scaled (HPS, K2 on the card)."""

    def __init__(self, from_ctx: Context, to_ctx: Context, factor: ScalingFactor):
        if from_ctx.degree != to_ctx.degree:
            raise InvalidContext("Incompatible degrees")
        self.from_ctx = from_ctx
        self.to_ctx = to_ctx
        self.factor = factor
        ncm = 0
        if factor.is_one:
            for qa, qb in zip(from_ctx.q, to_ctx.q):
                if qa.p != qb.p:
                    break
                ncm += 1
        self.number_common_moduli = ncm
        if from_ctx.narrow != to_ctx.narrow:
            raise InvalidContext("a scaler joins two narrow or two wide "
                                 "contexts")
        self.rns_scaler = RnsScaler(from_ctx.rns, to_ctx.rns, factor,
                                    from_ctx.dtype)

    def scale(self, x, ntt: bool | None = None):
        """(..., k_from, N) canonical rows of from_ctx, power basis or (ntt)
        NTT domain -> (..., k_to, N) rows of to_ctx in the same form
        (tpufhe rq.py:1293-1316): rows below number_common_moduli copied,
        the rest from the power basis (K1 inverse first when ntt) by
        scale_into. x may also be a Poly of from_ctx in power basis or NTT
        form (tpufhe's Scaler.scale(p); not lazy), scaled into a Poly of
        to_ctx in the same representation."""
        if isinstance(x, Poly):
            if x.ctx is not self.from_ctx:
                raise ContextMismatch("wrong context for scaler")
            x._not_lazy("Scaler.scale")
            x._expect(POWER_BASIS, NTT)
            return Poly(self.to_ctx, x.representation,
                        self.scale(x.coeffs, x.representation == NTT))
        ncm, k_out = self.number_common_moduli, self.to_ctx.k
        parts = [x[..., :ncm, :]] if ncm else []
        if ncm < k_out:
            x_pb = ntt_backward(self.from_ctx, x) if ntt else x
            parts.append(scale_into(self.to_ctx, self.rns_scaler, x_pb, ncm,
                                    k_out - ncm, ntt))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


class Switcher:
    """Context switch by the factor to_modulus / from_modulus
    (rq/switcher.rs:11-27, tpufhe rq.py:1319-1329): a copy where both
    contexts are the same, else every row scaled by K2 (exact when scaling
    up into a context whose modulus is a multiple of from's)."""

    def __init__(self, from_ctx: Context, to_ctx: Context):
        self.scaler = Scaler(from_ctx, to_ctx,
                             ScalingFactor(to_ctx.modulus(), from_ctx.modulus()))

    def switch(self, x: torch.Tensor, ntt: bool) -> torch.Tensor:
        return self.scaler.scale(x, ntt)


def dot_product(ctx: Context, ps: list, qs: list) -> torch.Tensor:
    """sum_i ps[i] qs[i] of NTT-domain (..., k, N) rows of ctx over the
    first min(len(ps), len(qs)) terms, with deferred 128-bit accumulation
    (tpufhe rq.py:1337-1368, rq/ops.rs:448-550): kernel ct_pt_dot on the
    card. Each qs[i] has ps[i]'s shape, or is one (k, N) polynomial for
    every batch row of ps[i]."""
    if not ps or not qs:
        raise TooFewValues(0, 1)
    count = min(len(ps), len(qs))
    e, d = torch.stack(ps[:count]), torch.stack(qs[:count])
    lead, k, n = e.shape[1:-2], ctx.k, ctx.degree
    if e.shape[-2:] != (k, n):
        raise ValueError(f"dot_product: rows {tuple(e.shape[1:])}, expected "
                         f"(..., {k}, {n})")
    if d.shape[1:] == e.shape[1:]:
        # one product per row: the batch folds into the rows
        out = ct_pt_dot(ctx, [e.reshape(count, 1, -1, n)],
                        d.reshape(count, 1, -1, n))
    elif d.shape[1:] == (k, n):
        out = ct_pt_dot(ctx, [e.reshape(count, -1, k, n)], d[:, None])
    else:
        raise ValueError(f"dot_product: operand rows {tuple(d.shape[1:])} "
                         f"against {tuple(e.shape[1:])}")
    return out.reshape(lead + (k, n))


# ---------------------------------------------------------------------------
# Poly
# ---------------------------------------------------------------------------


def _rows(mat, ctx: Context) -> torch.Tensor:
    """Canonical (..., k, N) residues (numpy, any integer type) as a tensor
    of the context's word type on its device."""
    mat = np.asarray(mat)
    words = (mat.astype(np.int32) if ctx.narrow
             else zq.as_int64(mat.astype(np.uint64)))
    return torch.from_numpy(np.ascontiguousarray(words)).to(ctx.device)


class Poly:
    """An RNS polynomial of `ctx` in one representation (the reference's
    typestate, rq/mod.rs:50-84; tpufhe rq.py:941-1228): a thin wrapper of
    one (..., k, N) coefficient tensor on the context's device, with its
    Shoup constants in NTT_SHOUP. Operations return new polys; the
    conversions run K1 (K9 when narrow) on the card.

    ``lazy`` (tpufhe's flag, set by ``into_ntt(lazy=True)``): NTT-domain
    words in [0, 4p) as K1's or K9's lazy forward leaves them, read as
    unsigned. A lazy poly takes a product by an NTT_SHOUP poly, a scalar
    product and a substitution; the product's words are canonical. The
    operations that tpufhe asserts against on a lazy poly raise
    UnsupportedOperation here."""

    __slots__ = ("ctx", "representation", "coeffs", "coeffs_shoup", "lazy")

    def __init__(self, ctx: Context, representation: str,
                 coeffs: torch.Tensor, coeffs_shoup: torch.Tensor | None = None,
                 lazy: bool = False):
        if representation not in (POWER_BASIS, NTT, NTT_SHOUP):
            raise IncorrectRepresentation(representation, "a representation")
        if tuple(coeffs.shape[-2:]) != (ctx.k, ctx.degree):
            raise InvalidContext(f"coefficients {tuple(coeffs.shape)} for "
                                 f"(..., {ctx.k}, {ctx.degree})")
        self.ctx = ctx
        self.representation = representation
        self.coeffs = coeffs
        self.coeffs_shoup = coeffs_shoup
        self.lazy = lazy

    def __repr__(self):
        lazy = ", lazy" if self.lazy else ""
        return (f"Poly({self.representation}{lazy}, "
                f"{tuple(self.coeffs.shape)}, {self.ctx!r})")

    def _not_lazy(self, operation: str) -> None:
        if self.lazy:
            raise UnsupportedOperation(
                f"{operation} of a lazy poly (words in [0, 4p))")

    @property
    def batch_shape(self):
        return tuple(self.coeffs.shape[:-2])

    # the Serialize / DeserializeWithContext traits (rq/serialize.rs:10-27)
    def to_bytes(self) -> bytes:
        from tpufhe_torch.serialize.codecs import serialize_poly

        return serialize_poly(self)

    @classmethod
    def from_bytes(cls, data: bytes, ctx: Context,
                   expected_representation: str | None = None) -> "Poly":
        from tpufhe_torch.serialize.codecs import deserialize_poly

        return deserialize_poly(data, ctx, expected_representation)

    # -- constructors --

    @staticmethod
    def zero(ctx: Context, representation: str = POWER_BASIS, batch=()
             ) -> "Poly":
        coeffs = torch.zeros(tuple(batch) + (ctx.k, ctx.degree),
                             dtype=ctx.dtype, device=ctx.device)
        return Poly(ctx, representation, coeffs,
                    coeffs if representation == NTT_SHOUP else None)

    @staticmethod
    def from_u64_matrix(mat, ctx: Context, representation: str = POWER_BASIS
                        ) -> "Poly":
        """mat: (..., k, N) canonical residues, taken as the coefficients
        of `representation` (no transform)."""
        p = Poly(ctx, NTT if representation == NTT_SHOUP else representation,
                 _rows(mat, ctx))
        return p.into_ntt_shoup() if representation == NTT_SHOUP else p

    @staticmethod
    def random(ctx: Context, rng, representation: str = POWER_BASIS) -> "Poly":
        """Uniform polynomial, limbs sampled row by row (rq/mod.rs:226-237)."""
        return Poly.from_u64_matrix(
            np.stack([q.random_vec(ctx.degree, rng) for q in ctx.q]), ctx,
            representation)

    @staticmethod
    def random_from_seed(ctx: Context, seed: bytes,
                         representation: str = NTT) -> "Poly":
        """Deterministic expansion: ChaCha8(SHA-256(seed)) (rq/mod.rs:241-257)."""
        return Poly.random(ctx, expand_seed(seed), representation)

    @staticmethod
    def small(ctx: Context, variance: int, rng,
              representation: str = POWER_BASIS) -> "Poly":
        """Centered-binomial small polynomial (rq/mod.rs:263-285)."""
        p = Poly.from_i64_coeffs(sample_vec_cbd(ctx.degree, variance, rng), ctx)
        if representation == NTT:
            return p.into_ntt()
        if representation == NTT_SHOUP:
            return p.into_ntt_shoup()
        return p

    @staticmethod
    def from_i64_coeffs(coeffs, ctx: Context) -> "Poly":
        """Up to N signed coefficients, reduced into every limb
        (rq/convert.rs TryConvertFrom<&[i64]>)."""
        return Poly(ctx, POWER_BASIS, from_i64_coeffs(coeffs, ctx))

    @staticmethod
    def from_u64_coeffs(coeffs, ctx: Context) -> "Poly":
        """Up to N unsigned 64-bit coefficients, reduced into every limb."""
        v = np.zeros(ctx.degree, dtype=np.uint64)
        cs = np.asarray(coeffs, dtype=np.uint64)
        v[: len(cs)] = cs
        return Poly.from_u64_matrix(
            np.stack([v % np.uint64(m) for m in ctx.moduli]), ctx)

    @staticmethod
    def from_bigint_coeffs(coeffs, ctx: Context) -> "Poly":
        """Arbitrary-precision coefficients projected through the RNS."""
        rows = np.zeros((ctx.k, ctx.degree), dtype=np.uint64)
        cs = [int(c) for c in coeffs]
        for i, m in enumerate(ctx.moduli):
            rows[i, : len(cs)] = [c % m for c in cs]
        return Poly.from_u64_matrix(rows, ctx)

    # -- representation moves --

    def with_representation(self, representation: str) -> "Poly":
        return Poly(self.ctx, representation, self.coeffs, self.coeffs_shoup,
                    self.lazy)

    def compute_shoup(self) -> "Poly":
        self._not_lazy("compute_shoup")
        return Poly(self.ctx, self.representation, self.coeffs,
                    shoup_of(self.coeffs, self.ctx.moduli))

    def _expect(self, *representations) -> None:
        if self.representation not in representations:
            raise IncorrectRepresentation(self.representation,
                                          representations[0])

    def into_ntt(self, lazy: bool = False) -> "Poly":
        """Forward NTT of a power-basis poly; lazy: words left in [0, 4p)
        (K1's or K9's lazy forward on the card), a lazy poly."""
        self._expect(POWER_BASIS)
        return Poly(self.ctx, NTT, ntt_forward(self.ctx, self.coeffs,
                                               lazy=lazy), lazy=lazy)

    def into_ntt_shoup(self) -> "Poly":
        if self.representation == POWER_BASIS:
            return self.into_ntt().into_ntt_shoup()
        self._expect(NTT)
        self._not_lazy("into_ntt_shoup")
        return self.compute_shoup().with_representation(NTT_SHOUP)

    def into_power_basis(self) -> "Poly":
        if self.representation == POWER_BASIS:
            return self
        self._not_lazy("into_power_basis")
        return Poly(self.ctx, POWER_BASIS, ntt_backward(self.ctx, self.coeffs))

    def into_ntt_from_shoup(self) -> "Poly":
        self._expect(NTT_SHOUP)
        return Poly(self.ctx, NTT, self.coeffs)

    # -- arithmetic --

    def _check(self, other: "Poly") -> None:
        if self.ctx is not other.ctx:
            raise ContextMismatch("Incompatible contexts")
        if self.representation != other.representation:
            raise IncorrectRepresentation(other.representation,
                                          self.representation)

    def __add__(self, other: "Poly") -> "Poly":
        self._check(other)
        self._not_lazy("addition")
        other._not_lazy("addition")
        return Poly(self.ctx, self.representation,
                    self.ctx.add(self.coeffs, other.coeffs))

    def __sub__(self, other: "Poly") -> "Poly":
        self._check(other)
        self._not_lazy("subtraction")
        other._not_lazy("subtraction")
        return Poly(self.ctx, self.representation,
                    self.ctx.sub(self.coeffs, other.coeffs))

    def __neg__(self) -> "Poly":
        self._not_lazy("negation")
        return Poly(self.ctx, self.representation, self.ctx.neg(self.coeffs))

    def __mul__(self, other: "Poly") -> "Poly":
        """The NTT-domain product: by an NTT_SHOUP poly with its Shoup
        constants (self may be lazy: its words are reduced first, and the
        product is canonical, as tpufhe's Shoup product leaves it), else of
        two NTT polys."""
        if self.ctx is not other.ctx:
            raise ContextMismatch("Incompatible contexts")
        other._not_lazy("a product by a lazy poly")
        if other.representation == NTT_SHOUP:
            out = self.ctx.mul_shoup(self._canonical(), other.coeffs,
                                     other.coeffs_shoup)
        else:
            self._expect(NTT)
            other._expect(NTT)
            self._not_lazy("the product of two NTT polys")
            out = self.ctx.mul(self.coeffs, other.coeffs)
        return Poly(self.ctx, NTT, out)

    def _canonical(self) -> torch.Tensor:
        """The coefficients as canonical residues: lazy words, in [0, 4p)
        read as unsigned (a 62-bit p's int64 word, or a narrow one's int32
        word, may read as negative), reduced."""
        if not self.lazy:
            return self.coeffs
        if self.ctx.narrow:
            return torch.remainder(self.coeffs.long() & 0xFFFFFFFF,
                                   self.ctx.p_col.long()).int()
        return zq.reduce_u64(self.coeffs, self.ctx.mod)

    def scalar_mul(self, scalar: int) -> "Poly":
        """Multiply by an integer projected through the RNS
        (rq/ops.rs:297-352); canonical words, also of a lazy poly."""
        s = torch.tensor([int(scalar) % m for m in self.ctx.moduli],
                         dtype=self.ctx.dtype, device=self.ctx.device)
        return Poly(self.ctx, self.representation,
                    self.ctx.mul(self._canonical(), s[:, None]))

    # -- Galois substitution --

    def substitute(self, exp: "SubstitutionExponent") -> "Poly":
        if exp.ctx is not self.ctx:
            raise ContextMismatch("the exponent is of another context")
        if self.representation == POWER_BASIS:
            return Poly(self.ctx, POWER_BASIS,
                        substitute(self.coeffs, exp, ntt=False))
        shoup = (None if self.coeffs_shoup is None
                 else self.coeffs_shoup[..., exp.perm_ntt])
        return Poly(self.ctx, self.representation,
                    substitute(self.coeffs, exp, ntt=True), shoup, self.lazy)

    # -- modulus switching --

    def switch_down(self) -> "Poly":
        """Divide and round by the last modulus and drop it
        (rq/mod.rs:390-449)."""
        self._expect(POWER_BASIS)
        return Poly(self.ctx.next_context, POWER_BASIS,
                    switch_down(self.ctx, self.coeffs))

    def switch_down_to(self, target: Context) -> "Poly":
        self._expect(POWER_BASIS)
        return Poly(target, POWER_BASIS,
                    switch_down_to(self.ctx, target, self.coeffs))

    def multiply_inverse_power_of_x(self, power: int) -> "Poly":
        """Negacyclic multiply by x^-power (rq/mod.rs:465-486)."""
        self._expect(POWER_BASIS)
        n = self.ctx.degree
        shift = ((n << 1) - power) % (n << 1)
        index = shift + np.arange(n, dtype=np.int64)
        src = np.empty(n, dtype=np.int64)
        src[index & (n - 1)] = np.arange(n)
        sign = np.empty(n, dtype=bool)
        sign[index & (n - 1)] = (index & n) != 0
        dev = self.ctx.device
        gathered = self.coeffs[..., torch.from_numpy(src).to(dev)]
        return Poly(self.ctx, POWER_BASIS,
                    torch.where(torch.from_numpy(sign).to(dev),
                                self.ctx.neg(gathered), gathered))

    # -- data access --

    def to_u64_matrix(self) -> np.ndarray:
        """(..., k, N) uint64 canonical residues (host)."""
        return self.coeffs.cpu().numpy().astype(np.uint64)

    def lift_bigints(self) -> list:
        """CRT-lift each coefficient of an unbatched power-basis poly to an
        integer in [0, q)."""
        self._expect(POWER_BASIS)
        if self.coeffs.dim() != 2:
            raise ValueError("lift_bigints takes an unbatched poly")
        return lift_bigints(self.ctx, self.coeffs)
