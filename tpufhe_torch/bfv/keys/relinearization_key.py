"""Relinearization keys: key-switch s^2 -> s
(fhe/src/bfv/keys/relinearization_key.rs; tpufhe's RelinearizationKey)."""

from __future__ import annotations

from tpufhe_torch.bfv.keys.key_switching_key import KeySwitchingKey
from tpufhe_torch.errors import UnsupportedOperation
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
