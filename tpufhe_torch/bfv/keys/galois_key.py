"""Galois keys: key-switch s(x^i) -> s(x) (fhe/src/bfv/keys/galois_key.rs;
tpufhe's GaloisKey).

Only keys at the ciphertext's level are ported: there tpufhe's
Switcher(ctx_ct, ctx_gk) is the identity (factor 1, every modulus common),
so the key switches from the substituted secret directly. Keys below the
ciphertext level need the Switcher and the switch-down, which are not
ported yet.
"""

from __future__ import annotations

from tpufhe_torch.bfv.ciphertext import Ciphertext
from tpufhe_torch.bfv.keys.key_switching_key import KeySwitchingKey
from tpufhe_torch.errors import InvalidCiphertext, UnsupportedOperation
from tpufhe_torch.ops.rq import SubstitutionExponent, from_i64_coeffs, substitute


class GaloisKey:
    def __init__(self, element: SubstitutionExponent, ksk: KeySwitchingKey):
        self.element = element
        self.ksk = ksk

    @staticmethod
    def new(sk, exponent: int, ciphertext_level: int, galois_key_level: int,
            rng) -> "GaloisKey":
        if ciphertext_level != galois_key_level:
            raise UnsupportedOperation(
                "Galois keys below the ciphertext level are not ported yet")
        ctx = sk.par.context_at_level(ciphertext_level)
        element = SubstitutionExponent(ctx, exponent)
        s_sub = substitute(from_i64_coeffs(sk.coeffs, ctx), element, ntt=False)
        ksk = KeySwitchingKey.new(sk, s_sub, ciphertext_level,
                                  galois_key_level, rng)
        return GaloisKey(element, ksk)

    def relinearize(self, ct: Ciphertext) -> Ciphertext:
        """Apply x -> x^i homomorphically through the pipeline's rotate
        step (galois_key.rs:62-87)."""
        if len(ct) != 2:
            raise InvalidCiphertext("The ciphertext is not of size 2")
        if ct.level != self.ksk.ciphertext_level:
            raise InvalidCiphertext("The ciphertext is not at the key's level")
        from tpufhe_torch.pipeline import _rotate_step

        step = _rotate_step(self.element.ctx, self.element, self.ksk)
        c0, c1 = step(ct[0], ct[1])
        return Ciphertext(ct.par, [c0, c1], self.ksk.ciphertext_level)
