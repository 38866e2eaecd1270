"""Plaintexts and encode/decode (fhe/src/bfv/{plaintext,plaintext_vec}.rs).

SIMD encoding is the SEAL batch encoder: apply the matrix_reps permutation,
then an inverse NTT over Z_t; decoding is the forward NTT followed by the
permutation. Both run as single-limb NTTs over the plaintext modulus (K1 on
the card). Only small plaintext moduli and one chunk of values are ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpufhe_torch.bfv.encoding import POLY, SIMD, Encoding
from tpufhe_torch.bfv.parameters import BfvParameters
from tpufhe_torch.errors import EncodingMismatch, SimdNotSupported, TooManyValues
from tpufhe_torch.ops import zq
from tpufhe_torch.ops.rq import from_u64_coeffs, ntt_backward, ntt_forward


@dataclass
class Plaintext:
    """An encoded plaintext: its coefficients mod t, encoding and level."""

    par: BfvParameters
    value: np.ndarray  # (N,) uint64 coefficients in [0, t)
    encoding: Encoding | None
    level: int

    def __eq__(self, other):
        if not isinstance(other, Plaintext):
            return NotImplemented
        enc_eq = (self.encoding == other.encoding
                  if self.encoding is not None and other.encoding is not None
                  else True)
        return (self.par == other.par
                and bool(np.array_equal(self.value, other.value))
                and self.level == other.level and enc_eq)

    def to_poly(self) -> torch.Tensor:
        """Delta * m in the NTT domain, (k, N) (plaintext.rs:71-98)."""
        ctx_lvl = self.par.context_level_at(self.level)
        cp = ctx_lvl.cipher_plain_context
        t = self.par.plaintext.value
        m_v = np.array([(int(v) * cp.q_mod_t) % t for v in self.value],
                       dtype=np.uint64)
        ctx = ctx_lvl.poly_context
        m = ntt_forward(ctx, from_u64_coeffs(m_v, ctx))
        return ctx.mul(m, cp.delta)

    @staticmethod
    def try_encode(values, encoding: Encoding, par: BfvParameters) -> "Plaintext":
        values = [int(v) for v in values]
        n = par.degree()
        if len(values) > n:
            raise TooManyValues(len(values), n)
        v = np.zeros(n, dtype=np.uint64)
        if encoding.encoding == POLY:
            v[: len(values)] = np.asarray(values, dtype=np.uint64)
        else:
            if par.ntt_operator is None:
                raise SimdNotSupported("no plaintext NTT for these parameters")
            v[par.matrix_reps_index_map[: len(values)]] = np.asarray(
                values, dtype=np.uint64)
            ntt_ctx = par.ntt_operator
            x = torch.from_numpy(zq.as_int64(v)).to(par.device)[None, :]
            v = ntt_backward(ntt_ctx, x)[0].cpu().numpy().astype(np.uint64)
        return Plaintext(par, v, encoding, encoding.level)

    def try_decode(self, encoding: Encoding | None = None) -> np.ndarray:
        if self.encoding is None and encoding is None:
            raise EncodingMismatch("none", "an encoding")
        enc = self.encoding if self.encoding is not None else encoding
        if encoding is not None and enc != encoding:
            raise EncodingMismatch(enc, encoding)
        if enc.encoding == POLY:
            return self.value.copy()
        if self.par.ntt_operator is None:
            raise SimdNotSupported("no plaintext NTT for these parameters")
        x = torch.from_numpy(zq.as_int64(self.value)).to(self.par.device)
        w = ntt_forward(self.par.ntt_operator, x[None, :])[0].cpu().numpy()
        return w.astype(np.uint64)[self.par.matrix_reps_index_map]


__all__ = ["Plaintext", "Encoding", "POLY", "SIMD"]
