"""Relinearization keys: key-switch s^2 -> s
(fhe/src/bfv/keys/relinearization_key.rs; tpufhe's RelinearizationKey)."""

from __future__ import annotations

from tpufhe_torch.bfv.ciphertext import Ciphertext
from tpufhe_torch.bfv.keys.key_switching_key import KeySwitchingKey
from tpufhe_torch.errors import (
    InvalidCiphertext,
    InvalidLevel,
    UnsupportedOperation,
)
from tpufhe_torch.ops.rq import ntt_backward


class RelinearizationKey:
    def __init__(self, ksk: KeySwitchingKey):
        self.ksk = ksk

    @staticmethod
    def new(sk, rng, ciphertext_level: int = 0, key_level: int = 0
            ) -> "RelinearizationKey":
        if ciphertext_level != key_level:
            # needs the context switcher, which is not ported yet
            raise UnsupportedOperation(
                "relinearization keys across levels are not ported yet")
        ctx = sk.par.context_at_level(key_level)
        if ctx.k == 1:
            raise UnsupportedOperation(
                "These parameters do not support key switching")
        s = sk.s_ntt(ctx)
        s2 = ntt_backward(ctx, ctx.mul(s, s))
        ksk = KeySwitchingKey.new(sk, s2, ciphertext_level, key_level, rng)
        return RelinearizationKey(ksk)

    def relinearizes(self, ct: Ciphertext):
        """In place: (c0, c1, c2) -> (c0 + ks0, c1 + ks1), (ks0, ks1) the key
        switch of c2 (relinearization_key.rs:71-98): K1 inverse of c2, then
        pipeline.relinearize (K5 and one add for a Garner key where the
        fused tails fit, else K1 forward + ks_accumulate)."""
        if len(ct) != 3:
            raise InvalidCiphertext(
                "Only size-3 ciphertexts can be relinearized")
        if ct.level != self.ksk.ciphertext_level:
            raise InvalidLevel(ct.level)
        if self.ksk.ksk_level != self.ksk.ciphertext_level:
            raise UnsupportedOperation(
                "relinearization keys below the ciphertext's level need the "
                "switch-down, which is not ported yet")
        from tpufhe_torch.pipeline import relinearize

        ctx = self.ksk.ctx_ciphertext
        c0, c1 = relinearize(ctx, self.ksk, ct[0], ct[1],
                             ntt_backward(ctx, ct[2]))
        ct[0] = c0
        ct[1] = c1
        ct.truncate(2)

    def relinearizes_poly(self, c2):
        """The key switch (c0, c1) of power-basis c2, NTT domain."""
        return self.ksk.key_switch(c2)
