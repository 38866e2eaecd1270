"""Galois keys: key-switch s(x^i) -> s(x) (fhe/src/bfv/keys/galois_key.rs;
tpufhe's GaloisKey).

A key below the ciphertext's level lives in a larger context: the
substituted secret is switched up into it (rq.Switcher, K2), and a
rotation key-switches there and switches back down
(pipeline.key_switch_down). At the ciphertext's level the Switcher is a
copy.
"""

from __future__ import annotations

from tpufhe_torch.bfv.ciphertext import Ciphertext
from tpufhe_torch.bfv.keys.key_switching_key import KeySwitchingKey
from tpufhe_torch.bfv.keys.relinearization_key import LEVELED_NARROW
from tpufhe_torch.errors import InvalidCiphertext, UnsupportedOperation
from tpufhe_torch.ops.rq import (
    SubstitutionExponent,
    Switcher,
    from_i64_coeffs,
    substitute,
)


class GaloisKey:
    def __init__(self, element: SubstitutionExponent, ksk: KeySwitchingKey):
        self.element = element
        self.ksk = ksk

    @staticmethod
    def new(sk, exponent: int, ciphertext_level: int, galois_key_level: int,
            rng) -> "GaloisKey":
        ctx_gk = sk.par.context_at_level(galois_key_level)
        ctx_ct = sk.par.context_at_level(ciphertext_level)
        if ctx_gk is not ctx_ct and ctx_ct.narrow:
            raise UnsupportedOperation(LEVELED_NARROW)
        element = SubstitutionExponent(ctx_ct, exponent)
        s_sub = substitute(from_i64_coeffs(sk.coeffs, ctx_ct), element,
                           ntt=False)
        s_sub_up = Switcher(ctx_ct, ctx_gk).switch(s_sub, ntt=False)
        ksk = KeySwitchingKey.new(sk, s_sub_up, ciphertext_level,
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
