"""RNS contexts and the HPS base conversion with rational scaling (kernel K2).

The host tables are those of tpufhe.ops.rns (fhe-math rns/{mod.rs,
scaler.rs}, Remark 3.2 of eprint 2021/204): given residues x mod q, the
scaler computes round(x num / den) in the `to` basis, with x read as
centered. ``scale_plain`` computes the integers of tpufhe's exact
Python-int oracle ``RnsScaler.scale_host`` (scaler.rs:249-352) with 31-bit
digits on int64 tensors; kernel K2 (csrc/rns_scale.cu) computes them on
the card, on int64 rows or on the int32 rows of narrow (w30) contexts,
where it serves tpufhe's XLA narrow scaler (the same integers).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from math import gcd

import numpy as np
import torch

from tpufhe_torch import kernels
from tpufhe_torch.device import on_card
from tpufhe_torch.errors import InvalidContext, TooFewValues
from tpufhe_torch.ops import zq
from tpufhe_torch.ops.zq import DIGIT_BITS, DIGIT_MASK, ModTable, Modulus
from tpufhe_torch.utils.misc import inverse
from tpufhe_torch.utils.obs import uncounted

_M64 = (1 << 64) - 1
_M128 = (1 << 128) - 1


def _lazy_shoup_host(a: int, b: int, b_shoup: int, p: int) -> int:
    """The exact word of lazy_mul_shoup (zq/mod.rs:217-222), in [0, 2p)."""
    return (a * b - ((a * b_shoup) >> 64) * p) & _M64


def _lazy_barrett_host(a: int, p: int) -> int:
    """The exact word of lazy_reduce_u128 (zq/mod.rs:693-707), a < 2^128."""
    barrett = (1 << 128) // p
    b_lo, b_hi = barrett & _M64, barrett >> 64
    a_lo, a_hi = a & _M64, a >> 64
    q = ((a_lo * b_hi + a_hi * b_lo + ((a_lo * b_lo) >> 64)) >> 64) + a_hi * b_hi
    return (a - q * p) & _M64


class RnsContext:
    """CRT context over pairwise-coprime moduli (rns/mod.rs:24-147)."""

    def __init__(self, moduli: list[int]):
        moduli = [int(m) for m in moduli]
        if not moduli:
            raise TooFewValues(0, 1)
        for i, mi in enumerate(moduli):
            for j, mj in enumerate(moduli):
                if i != j and gcd(mi, mj) != 1:
                    raise InvalidContext("The moduli are not coprime")
        self.moduli_u64 = moduli
        self.moduli = [Modulus(m) for m in moduli]
        self.product = 1
        for m in moduli:
            self.product *= m
        self.q_star = [self.product // m for m in moduli]
        self.q_tilde = [inverse(self.product // m, m) for m in moduli]
        self.q_tilde_shoup = [
            q.shoup(t) for q, t in zip(self.moduli, self.q_tilde)
        ]
        self.garner = [s * t for s, t in zip(self.q_star, self.q_tilde)]

    def modulus(self) -> int:
        """The product of the moduli, an exact Python int."""
        return self.product

    def project(self, a: int) -> list[int]:
        return [int(a) % m for m in self.moduli_u64]

    def lift(self, rests) -> int:
        acc = 0
        for r, g in zip(rests, self.garner):
            acc += g * int(r)
        return acc % self.product

    def get_garner(self, i: int) -> int | None:
        """The i-th Garner coefficient (q / q_i)((q / q_i)^-1 mod q_i), an
        exact Python int; None past the last modulus (rns/mod.rs:96-103)."""
        return self.garner[i] if i < len(self.garner) else None


@dataclass(frozen=True)
class ScalingFactor:
    """Rational scaling factor num/den (rns/scaler.rs:20-47)."""

    numerator: int
    denominator: int

    def __post_init__(self):
        assert self.denominator != 0

    @property
    def is_one(self) -> bool:
        return self.numerator == self.denominator

    @staticmethod
    def one() -> "ScalingFactor":
        return ScalingFactor(1, 1)


def _extract_projection_and_theta(
    ctx: RnsContext, inp: int, num: int, den: int, round_up: bool
):
    """gamma = round(num*inp/den) projected into ctx; theta = frac part scaled
    by 2^127 with a sign (rns/scaler.rs:183-229)."""
    gamma = (num * inp + (den >> 1)) // den
    projected = ctx.project(gamma)

    theta = (num * inp) % den
    theta_sign = False
    if den > 1:
        if den & 1 == 1:
            if theta > (den >> 1):
                theta_sign = True
                theta = den - theta
        else:
            if theta >= (den >> 1):
                theta_sign = True
                theta = den - theta
    if round_up:
        if theta_sign:
            theta = (theta << 127) // den
        else:
            theta = ((theta << 127) + den - 1) // den
    elif theta_sign:
        theta = ((theta << 127) + den - 1) // den
    else:
        theta = (theta << 127) // den
    return projected, theta, theta_sign


class RnsScaler:
    """Fused RNS base conversion + rational scaling (rns/scaler.rs:52-352).

    `dtype` is the word type of the rows it takes and returns: torch.int64
    between wide contexts, torch.int32 between narrow (w30) ones, whose
    moduli are all below 2^30. Both compute the same integers."""

    def __init__(self, from_ctx: RnsContext, to_ctx: RnsContext,
                 factor: ScalingFactor, dtype: torch.dtype = torch.int64):
        if dtype == torch.int32 and any(
                m >= (1 << 30) for m in from_ctx.moduli_u64 + to_ctx.moduli_u64):
            raise InvalidContext("int32 rows need every modulus below 2^30")
        self.from_ctx = from_ctx
        self.to_ctx = to_ctx
        self.factor = factor
        self.dtype = dtype
        num, den = factor.numerator, factor.denominator

        gamma, theta_gamma, tg_sign = _extract_projection_and_theta(
            to_ctx, from_ctx.product, num, den, False
        )
        self.gamma = gamma
        self.gamma_shoup = [q.shoup(g) for q, g in zip(to_ctx.moduli, gamma)]
        self.theta_gamma = theta_gamma
        self.theta_gamma_sign = tg_sign

        k_in = len(from_ctx.moduli)
        k_out = len(to_ctx.moduli)
        omegas = []
        self.theta_omega = []
        self.theta_omega_sign = []
        for g in from_ctx.garner:
            proj, theta, sign = _extract_projection_and_theta(
                to_ctx, g, num, den, True
            )
            omegas.append(proj)
            self.theta_omega.append(theta)
            self.theta_omega_sign.append(sign)
        # omega[j][i] = reduce(omegas[i][j]) per output modulus j
        self.omega = [
            [to_ctx.moduli[j].reduce(omegas[i][j]) for i in range(k_in)]
            for j in range(k_out)
        ]
        self.omega_shoup = [
            [to_ctx.moduli[j].shoup(self.omega[j][i]) for i in range(k_in)]
            for j in range(k_out)
        ]

        # shift so that the sum of scaled theta_garner fits in 192 bits
        # (scaler.rs:130-142)
        def next_pow2_log(x: int) -> int:
            return (x - 1).bit_length() if x > 1 else 0

        self.theta_garner_shift = min(
            min(192 - 1 - next_pow2_log(qi * k_in)
                for qi in from_ctx.moduli_u64),
            127,
        )
        self.theta_garner = [
            ((g << self.theta_garner_shift) + (from_ctx.product >> 1))
            // from_ctx.product
            for g in from_ctx.garner
        ]
        self._k_in = k_in
        self._k_out = k_out
        self._tables: dict = {}

    def scale_host(self, rests, size: int | None = None,
                   starting_index: int = 0) -> list:
        """The scale of one coefficient's k_in residues `rests` into rows
        starting_index .. starting_index + size of the `to` basis, exact on
        Python ints (scaler.rs:249-352; tpufhe rns.py:260): the oracle that
        scale_plain and K2 equal."""
        if len(rests) != self._k_in:
            raise ValueError(f"scale_host: {len(rests)} residues, expected "
                             f"{self._k_in}")
        size = self._k_out - starting_index if size is None else size
        sum_tg = 0
        for tg, r in zip(self.theta_garner, rests):
            sum_tg = (sum_tg + int(r) * tg) % (1 << 256)
        sum_tg >>= self.theta_garner_shift - 1
        # div_ceil(2) of the truncated u128
        s = sum_tg & _M128
        v = (s + 1) // 2 if s % 2 else s // 2
        w_sign, w = False, 0
        if not self.factor.is_one:
            sum_to = 0
            for to, sign, r in zip(self.theta_omega, self.theta_omega_sign,
                                   rests):
                prod = int(r) * to
                sum_to = (sum_to - prod if sign else sum_to + prod) % (1 << 256)
            v_tg = (v * self.theta_gamma) % (1 << 256)
            if self.theta_gamma_sign:
                sum_to = (sum_to + v_tg) % (1 << 256)
            else:
                sum_to = (sum_to - v_tg) % (1 << 256)
            w_sign = (sum_to >> 191) > 0
            if w_sign:
                w = ((((1 << 256) - 1 - sum_to) >> 126) & _M128) + 1
                w //= 2
            else:
                w = (sum_to >> 126) & _M128
                w = (w + 1) // 2 if w % 2 else w // 2
        out = []
        for j in range(starting_index, starting_index + size):
            p = self.to_ctx.moduli[j].p
            # lazy_mul_shoup(v mod p, gamma_j): its exact value in [0, 2p)
            y = 2 * p - _lazy_shoup_host(v % p, self.gamma[j],
                                         self.gamma_shoup[j], p)
            if not self.factor.is_one:
                w_lazy = _lazy_barrett_host(w, p)
                y += (2 * p - w_lazy) if w_sign else w_lazy
            for i in range(self._k_in):
                y += _lazy_shoup_host(int(rests[i]), self.omega[j][i],
                                      self.omega_shoup[j][i], p)
            out.append(y % p)
        return out

    def table_host(self, starting_index: int, size: int) -> np.ndarray:
        """The constant table of K2 and K8 for the output rows
        starting_index .. starting_index + size - 1, as host int64 words
        (layout in csrc/rns_scale_device.cuh)."""
        key = (starting_index, size)
        if key not in self._tables:
            words = [self.theta_gamma & _M64, self.theta_gamma >> 64]
            for tg, to, sign in zip(self.theta_garner, self.theta_omega,
                                    self.theta_omega_sign):
                words += [tg & _M64, tg >> 64, to & _M64, to >> 64, int(sign)]
            for j in range(starting_index, starting_index + size):
                q = self.to_ctx.moduli[j]
                words += [q.p, q.barrett_lo, q.barrett_hi, self.gamma[j],
                          self.gamma_shoup[j]] + self.omega[j]
            self._tables[key] = zq.as_int64(np.array(words, dtype=np.uint64))
        return self._tables[key]

    def table(self, device, starting_index: int, size: int) -> torch.Tensor:
        """table_host's words on `device`."""
        key = (str(device), starting_index, size)
        if key not in self._tables:
            self._tables[key] = torch.from_numpy(
                self.table_host(starting_index, size)).to(device)
        return self._tables[key]

    def check_rows(self, x: torch.Tensor, starting_index: int,
                   size: int | None) -> int:
        """The number of output rows (all from starting_index on when size
        is None); raises unless x has k_in limbs and the rows exist."""
        size = self._k_out - starting_index if size is None else size
        if x.shape[-2] != self._k_in:
            raise ValueError(f"rns_scale: {x.shape[-2]} input limbs, "
                             f"expected {self._k_in}")
        if not 0 <= starting_index <= starting_index + size <= self._k_out:
            raise ValueError("rns_scale: output rows out of range")
        return size

    def scale(self, x: torch.Tensor, starting_index: int = 0,
              size: int | None = None) -> torch.Tensor:
        """(..., k_in, n) canonical residues -> (..., size, n) in the `to`
        basis, rows starting_index .. starting_index + size."""
        size = self.check_rows(x, starting_index, size)
        if on_card(x):
            return self.scale_cuda(x, starting_index, size)
        if x.dtype != self.dtype:
            raise ValueError(f"rns_scale: dtype {x.dtype}, expected {self.dtype}")
        return self.scale_plain(x, starting_index, size)

    def scale_cuda(self, x: torch.Tensor, starting_index: int,
                   size: int) -> torch.Tensor:
        """Launch K2 (csrc/rns_scale.cu) on rows of the scaler's dtype."""
        kernels.require_cuda("rns_scale", self.dtype, x)
        n = x.shape[-1]
        y = torch.empty(x.shape[:-2] + (size, n), dtype=self.dtype,
                        device=x.device)
        total = x.numel() // self._k_in
        if total == 0 or size == 0:
            return y
        host = self.table_host(starting_index, size)
        tab = self.table(x.device, starting_index, size)
        kernels.launch("rns_scale", "tpufhe_rns_scale", _SCALE_ARGS,
                       kernels.ptr(x), kernels.ptr(y), total, n, self._k_in,
                       kernels.ptr(tab), ctypes.c_void_p(host.ctypes.data),
                       host.size, size, self.theta_garner_shift,
                       int(self.factor.is_one), int(self.theta_gamma_sign),
                       x.element_size())
        return y

    @uncounted
    def scale_plain(self, x: torch.Tensor, starting_index: int,
                    size: int) -> torch.Tensor:
        """The plain version of K2: the integers of scale_host, computed with
        31-bit digits on int64 tensors (narrow rows are widened on the way
        in and narrowed on the way out). Inputs must be below 2^62."""
        if x.dtype != torch.int64:
            return self.scale_plain(x.long(), starting_index, size).to(x.dtype)
        k_in = self._k_in
        r = [zq.to_digits(x[..., i, :], 2) for i in range(k_in)]

        # v = ceil((sum_i r_i theta_garner_i >> (shift - 1)) mod 2^128 / 2);
        # the sum is below 2^256, so no wrap occurs
        cols = [0] * 11
        for ri, tg in zip(r, self.theta_garner):
            zq.mul_columns(ri, zq.int_digits(tg, 5), cols)
        s = _shifted_u128(zq.normalize(cols, 9), self.theta_garner_shift - 1)
        v = _ceil_half(s)

        w = w_sign = None
        if not self.factor.is_one:
            cols = [0] * 11
            for ri, to, neg in zip(r, self.theta_omega, self.theta_omega_sign):
                zq.mul_columns(ri, zq.int_digits(to, 5), cols,
                               -1 if neg else 1)
            zq.mul_columns(v, zq.int_digits(self.theta_gamma, 5), cols,
                           1 if self.theta_gamma_sign else -1)
            # sum_to = S mod 2^256: nine digits carry 279 bits, the top one
            # is cut to 8
            sd = zq.normalize(cols, 9)
            sd[8] = sd[8] & 0xFF
            w_sign = ((sd[6] >> 5) | sd[7] | sd[8]) != 0
            comp = [d ^ DIGIT_MASK for d in sd[:8]] + [sd[8] ^ 0xFF]
            t = [torch.where(w_sign, a, b) for a, b in
                 zip(_shifted_u128(comp, 126), _shifted_u128(sd, 126))]
            w = _ceil_half(t)

        m = ModTable(self.to_ctx.moduli_u64[starting_index:starting_index + size],
                     x.device, (size, 1))
        v_red = zq.mod_of_digits([d[..., None, :] for d in v], m)
        gamma = _col(self.gamma[starting_index:starting_index + size], x.device)
        y = zq.neg(zq.mul(v_red, gamma, m), m)
        if w is not None:
            w_red = zq.mod_of_digits([d[..., None, :] for d in w], m)
            y = torch.where(w_sign[..., None, :], zq.sub(y, w_red, m),
                            zq.add(y, w_red, m))
        for i in range(k_in):
            om = _col([self.omega[starting_index + jj][i] for jj in range(size)],
                      x.device)
            ri = torch.remainder(x[..., i, None, :], m.p)
            y = zq.add(y, zq.mul(ri, om, m), m)
        return y


_SCALE_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
               + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _col(vals, device) -> torch.Tensor:
    return torch.tensor([int(v) for v in vals], dtype=torch.int64,
                        device=device).reshape(-1, 1)


def _shifted_u128(digits: list, shift: int) -> list:
    """Bits [shift, shift + 128) of a digit number, as five 31-bit digits
    (the top digit holds 4 bits)."""
    out = [zq.bits_of(digits, shift + DIGIT_BITS * i, DIGIT_BITS)
           for i in range(4)]
    out.append(zq.bits_of(digits, shift + 4 * DIGIT_BITS, 4))
    return out


def _ceil_half(t: list) -> list:
    """ceil(t / 2) of a 128-bit digit number: (t >> 1) + (t & 1)."""
    odd = t[0] & 1
    half = [((t[i] >> 1) | ((t[i + 1] & 1) << (DIGIT_BITS - 1)))
            for i in range(4)] + [t[4] >> 1]
    half[0] = half[0] + odd
    return zq.normalize(half, 5)
