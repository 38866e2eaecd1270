"""Evaluation keys: bundles of Galois keys enabling inner sum, row and
column rotations and oblivious expansion (fhe/src/bfv/keys/evaluation_key.rs;
tpufhe's EvaluationKey and EvaluationKeyBuilder).

The oblivious expansion is Angel et al. (eprint 2019/1483): log-depth
doubling with Galois exponents (n >> l) + 1 and monomials x^{-2^l}
(evaluation_key.rs:153-193). Keys may sit below the ciphertext's level
(evaluation_key_level < ciphertext_level, see galois_key.py), as MulPIR
builds its expansion keys. On narrow (w30) contexts the monomials carry
shoup32 constants (floor(v 2^32 / p)) and the fold is ops/zq32.py's Shoup
product, as tpufhe's.
"""

from __future__ import annotations

import numpy as np

from tpufhe_torch.bfv.ciphertext import Ciphertext
from tpufhe_torch.bfv.keys.galois_key import GaloisKey
from tpufhe_torch.bfv.keys.key_switching_key import shoup_of
from tpufhe_torch.bfv.ops import ct_add, ct_sub
from tpufhe_torch.errors import (
    InvalidCiphertext,
    InvalidLevel,
    InvalidRotationStep,
    ParametersError,
    UnsupportedOperation,
)
from tpufhe_torch.ops.rq import from_i64_coeffs, ntt_forward


class EvaluationKey:
    def __init__(self, par, ciphertext_level, evaluation_key_level, gk,
                 rot_to_gk_exponent, monomials):
        self.par = par
        self.ciphertext_level = ciphertext_level
        self.evaluation_key_level = evaluation_key_level
        self.gk = gk  # dict[int exponent -> GaloisKey]
        self.rot_to_gk_exponent = rot_to_gk_exponent
        # x^{-2^l} as (NTT-domain (k, N) values, their Shoup constants)
        self.monomials = monomials

    # -- capability checks (evaluation_key.rs:39-147) --

    def supports_inner_sum(self) -> bool:
        ok = (self.par.degree() * 2 - 1) in self.gk
        i = 1
        while i < self.par.degree() // 2:
            ok &= self.rot_to_gk_exponent[i] in self.gk
            i *= 2
        return ok

    def supports_row_rotation(self) -> bool:
        return (self.par.degree() * 2 - 1) in self.gk

    def supports_column_rotation_by(self, i: int) -> bool:
        exp = self.rot_to_gk_exponent.get(i)
        return exp is not None and exp in self.gk

    def supports_expansion(self, level: int) -> bool:
        if level == 0:
            return True
        if self.evaluation_key_level == len(self.par.moduli):
            return False
        ok = level < 64 - (self.par.degree().bit_length() - 1)
        for l in range(level):
            ok &= ((self.par.degree() >> l) + 1) in self.gk
        return ok

    # -- operations --

    def computes_inner_sum(self, ct: Ciphertext) -> Ciphertext:
        if not self.supports_inner_sum():
            raise UnsupportedOperation("This key does not support the inner sum")
        out = ct
        i = 1
        while i < ct.par.degree() // 2:
            out = ct_add(out, self.gk[self.rot_to_gk_exponent[i]].relinearize(out))
            i *= 2
        return ct_add(out, self.gk[self.par.degree() * 2 - 1].relinearize(out))

    def rotates_rows(self, ct: Ciphertext) -> Ciphertext:
        if not self.supports_row_rotation():
            raise UnsupportedOperation("This key does not support row rotation")
        return self.gk[self.par.degree() * 2 - 1].relinearize(ct)

    def rotates_columns_by(self, ct: Ciphertext, i: int) -> Ciphertext:
        if not self.supports_column_rotation_by(i):
            raise InvalidRotationStep(
                "this key does not support this column rotation")
        return self.gk[self.rot_to_gk_exponent[i]].relinearize(ct)

    def expands(self, ct: Ciphertext, size: int) -> list:
        """Oblivious expansion into `size` ciphertexts
        (evaluation_key.rs:153-193)."""
        level = (size - 1).bit_length() if size > 1 else 0
        if len(ct) != 2:
            raise InvalidCiphertext("The ciphertext is not of size 2")
        if level == 0:
            return [ct]
        if not self.supports_expansion(level):
            raise UnsupportedOperation(
                "This key does not support expansion at this level")
        ctx = self.par.context_at_level(ct.level)
        out = [ct] + [None] * ((1 << level) - 1)
        for l in range(level):
            mono, mono_shoup = self.monomials[l]
            gk = self.gk[(self.par.degree() >> l) + 1]
            step = 1 << l
            for i in range(step):
                sub = gk.relinearize(out[i])
                j = step | i
                if j < size:
                    target = ct_sub(out[i], sub)
                    out[j] = Ciphertext(
                        target.par,
                        [ctx.mul_shoup(p, mono, mono_shoup)
                         for p in target.c],
                        target.level)
                out[i] = ct_add(out[i], sub)
        return out[:size]

    @staticmethod
    def construct_rot_to_gk_exponent(par) -> dict:
        m = 2 * par.degree()
        return {i: pow(3, i, m) for i in range(1, par.degree() // 2)}

    # the Serialize / DeserializeParametrized traits
    # (fhe-traits/src/lib.rs:128-154)
    def to_bytes(self) -> bytes:
        from tpufhe_torch.serialize.codecs import serialize_evaluation_key

        return serialize_evaluation_key(self)

    @classmethod
    def from_bytes(cls, data: bytes, par) -> "EvaluationKey":
        """The object of `data`, its tensors on par's device."""
        from tpufhe_torch.serialize.codecs import deserialize_evaluation_key

        return deserialize_evaluation_key(data, par)


def monomials(ctx) -> list:
    """x^{-2^l} for l < log2 N in the NTT domain of ctx, each as (values,
    Shoup constants), both (k, N) of ctx's word type (tpufhe
    evaluation_key.py:198-207; shoup32 constants on a narrow context)."""
    n = ctx.degree
    out = []
    for l in range(n.bit_length() - 1):
        coeffs = np.zeros(n, dtype=np.int64)
        coeffs[n - (1 << l)] = -1
        mono = ntt_forward(ctx, from_i64_coeffs(coeffs, ctx))
        out.append((mono, shoup_of(mono, ctx.moduli)))
    return out


class EvaluationKeyBuilder:
    """Builder (evaluation_key.rs:229-380)."""

    def __init__(self, sk, ciphertext_level: int = 0,
                 evaluation_key_level: int = 0):
        if (ciphertext_level < evaluation_key_level
                or ciphertext_level > sk.par.max_level()):
            raise InvalidLevel(ciphertext_level)
        self.sk = sk
        self.ciphertext_level = ciphertext_level
        self.evaluation_key_level = evaluation_key_level
        self.inner_sum = False
        self.row_rotation = False
        self.expansion_level = 0
        self.column_rotation: set[int] = set()
        self.rot_to_gk_exponent = EvaluationKey.construct_rot_to_gk_exponent(
            sk.par)

    def enable_expansion(self, level: int) -> "EvaluationKeyBuilder":
        if level >= 64 - (self.sk.par.degree().bit_length() - 1):
            raise ParametersError("Invalid expansion level")
        self.expansion_level = level
        return self

    def enable_inner_sum(self) -> "EvaluationKeyBuilder":
        self.inner_sum = True
        return self

    def enable_row_rotation(self) -> "EvaluationKeyBuilder":
        self.row_rotation = True
        return self

    def enable_column_rotation(self, i: int) -> "EvaluationKeyBuilder":
        exp = self.rot_to_gk_exponent.get(i)
        if exp is None:
            raise InvalidRotationStep("invalid column index")
        self.column_rotation.add(exp)
        return self

    def build(self, rng) -> EvaluationKey:
        par = self.sk.par
        n = par.degree()
        indices = set(self.column_rotation)
        if self.row_rotation or self.inner_sum:
            indices.add(n * 2 - 1)
        if self.inner_sum:
            i = 1
            while i < n // 2:
                indices.add(self.rot_to_gk_exponent[i])
                i *= 2
        for l in range(self.expansion_level):
            indices.add((n >> l) + 1)

        gk = {index: GaloisKey.new(self.sk, index, self.ciphertext_level,
                                   self.evaluation_key_level, rng)
              for index in sorted(indices)}
        return EvaluationKey(par, self.ciphertext_level,
                             self.evaluation_key_level, gk,
                             self.rot_to_gk_exponent,
                             monomials(par.context_at_level(self.ciphertext_level)))
