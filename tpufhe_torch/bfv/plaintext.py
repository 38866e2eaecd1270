"""Plaintexts and encode/decode (fhe/src/bfv/{plaintext,plaintext_vec}.rs).

SIMD encoding is the SEAL batch encoder: apply the matrix_reps permutation,
then an inverse NTT over Z_t; decoding is the forward NTT followed by the
permutation. Both run as single-limb NTTs over the plaintext modulus (K1 on
the card). A large plaintext modulus (62 bits and more) takes polynomial
encoding only; its values are Python ints, lifted through the RNS
(Poly.from_bigint_coeffs; plaintext.rs:57, 144-161).

A plaintext keeps two polynomials of its level's context in the NTT
domain: ``to_poly()``, Delta m, which encryption and ct_add_pt take, and
``poly_ntt``, m lifted without Delta, which ct_mul_pt and the dot
products take (plaintext.rs:71-98; tpufhe plaintext.py:22-29, 154-157).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tpufhe_torch.bfv.encoding import POLY, SIMD, Encoding
from tpufhe_torch.bfv.parameters import BfvParameters
from tpufhe_torch.errors import EncodingMismatch, SimdNotSupported, TooManyValues
from tpufhe_torch.ops import zq
from tpufhe_torch.ops.rq import (
    Poly,
    from_u64_coeffs,
    ntt_backward,
    ntt_forward,
)


@dataclass
class Plaintext:
    """An encoded plaintext: its coefficients mod t, encoding and level."""

    par: BfvParameters
    value: np.ndarray | list  # (N,) uint64 (small t) or N ints (large t)
    encoding: Encoding | None
    level: int
    _poly_ntt: torch.Tensor | None = field(default=None, repr=False,
                                           compare=False)

    def __eq__(self, other):
        if not isinstance(other, Plaintext):
            return NotImplemented
        enc_eq = (self.encoding == other.encoding
                  if self.encoding is not None and other.encoding is not None
                  else True)
        if isinstance(self.value, np.ndarray) and isinstance(other.value,
                                                             np.ndarray):
            values_eq = bool(np.array_equal(self.value, other.value))
        else:
            values_eq = ([int(v) for v in self.value]
                         == [int(v) for v in other.value])
        return (self.par == other.par and values_eq
                and self.level == other.level and enc_eq)

    def _lift(self, values, ctx) -> torch.Tensor:
        """Coefficients into ctx's power basis, (k, N): uint64 values, or
        Python ints through the RNS for a large t."""
        if self.par.plaintext.is_small:
            return from_u64_coeffs(values, ctx)
        return Poly.from_bigint_coeffs(values, ctx).coeffs

    @property
    def poly_ntt(self) -> torch.Tensor:
        """m lifted into the level's context and forward-NTT'd, (k, N),
        without Delta; computed on first use and kept."""
        if self._poly_ntt is None:
            ctx = self.par.context_at_level(self.level)
            self._poly_ntt = ntt_forward(ctx, self._lift(self.value, ctx))
        return self._poly_ntt

    @staticmethod
    def zero(encoding: Encoding, par: BfvParameters) -> "Plaintext":
        ctx = par.context_at_level(encoding.level)
        poly = torch.zeros((ctx.k, ctx.degree), dtype=ctx.dtype,
                           device=ctx.device)
        value = (np.zeros(par.degree(), dtype=np.uint64)
                 if par.plaintext.is_small else [0] * par.degree())
        return Plaintext(par, value, encoding, encoding.level, poly)

    def to_poly(self) -> torch.Tensor:
        """Delta * m in the NTT domain, (k, N) (plaintext.rs:71-98)."""
        ctx_lvl = self.par.context_level_at(self.level)
        cp = ctx_lvl.cipher_plain_context
        t = self.par.plaintext.value
        m_v = [(int(v) * cp.q_mod_t) % t for v in self.value]
        ctx = ctx_lvl.poly_context
        m = ntt_forward(ctx, self._lift(m_v, ctx))
        return ctx.mul(m, cp.delta)

    @staticmethod
    def try_encode(values, encoding: Encoding, par: BfvParameters) -> "Plaintext":
        values = list(values)
        if len(values) > par.degree():
            raise TooManyValues(len(values), par.degree())
        return PlaintextVec.try_encode(values, encoding, par)[0]

    @staticmethod
    def try_encode_i64(values, encoding: Encoding, par: BfvParameters
                       ) -> "Plaintext":
        """Signed values, reduced into [0, t)."""
        t = par.plaintext.value
        return Plaintext.try_encode([int(v) % t for v in values], encoding,
                                    par)

    def try_decode(self, encoding: Encoding | None = None) -> np.ndarray:
        if self.encoding is None and encoding is None:
            raise EncodingMismatch("none", "an encoding")
        enc = self.encoding if self.encoding is not None else encoding
        if encoding is not None and enc != encoding:
            raise EncodingMismatch(enc, encoding)
        if enc.encoding == POLY:
            return (self.value.copy() if isinstance(self.value, np.ndarray)
                    else list(self.value))
        if self.par.ntt_operator is None:
            raise SimdNotSupported("no plaintext NTT for these parameters")
        x = torch.from_numpy(zq.as_int64(self.value)).to(self.par.device)
        w = ntt_forward(self.par.ntt_operator, x[None, :])[0].cpu().numpy()
        return w.astype(np.uint64)[self.par.matrix_reps_index_map]

    def try_decode_i64(self, encoding: Encoding | None = None) -> np.ndarray:
        """The decoded values as signed integers: v - t where v >= t / 2."""
        t = self.par.plaintext.value
        v = self.try_decode(encoding)
        if not self.par.plaintext.is_small:
            return np.array([int(x) - t if int(x) >= (t >> 1) else int(x)
                             for x in v], dtype=np.int64)
        v = v.astype(np.int64)
        return np.where(v >= (t >> 1), v - t, v)


class PlaintextVec(list):
    """Plaintexts of N values each, the last zero-padded
    (plaintext_vec.rs:19-234; tpufhe plaintext.py:128-166)."""

    @staticmethod
    def try_encode(values, encoding: Encoding, par: BfvParameters
                   ) -> "PlaintextVec":
        values = [int(v) for v in values]
        if not values:
            return PlaintextVec([Plaintext.zero(encoding, par)])
        if encoding.encoding == SIMD and par.ntt_operator is None:
            raise SimdNotSupported("no plaintext NTT for these parameters")
        n = par.degree()
        out = []
        for start in range(0, len(values), n):
            if not par.plaintext.is_small:
                if encoding.encoding == SIMD:
                    raise SimdNotSupported("large plaintext modulus")
                chunk = values[start:start + n]
                v = chunk + [0] * (n - len(chunk))
                out.append(Plaintext(par, v, encoding, encoding.level))
                continue
            chunk = np.asarray(values[start:start + n], dtype=np.uint64)
            v = np.zeros(n, dtype=np.uint64)
            if encoding.encoding == POLY:
                v[: len(chunk)] = chunk
            else:
                v[par.matrix_reps_index_map[: len(chunk)]] = chunk
                x = torch.from_numpy(zq.as_int64(v)).to(par.device)[None, :]
                v = ntt_backward(par.ntt_operator, x)[0].cpu().numpy().astype(
                    np.uint64)
            out.append(Plaintext(par, v, encoding, encoding.level))
        return PlaintextVec(out)


__all__ = ["Plaintext", "PlaintextVec", "Encoding", "POLY", "SIMD"]
