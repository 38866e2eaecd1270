"""Relinearization keys: key-switch s^2 -> s
(fhe/src/bfv/keys/relinearization_key.rs; tpufhe's RelinearizationKey).

A key may sit below the ciphertext's level, in a larger context
(key_level < ciphertext_level): s^2 is switched up into it
(rq.Switcher, K2 with a factor above 1, on int32 rows for narrow
parameters), and the key switch's result is switched back down to the
ciphertext's context."""

from __future__ import annotations

from tpufhe_torch.bfv.ciphertext import Ciphertext
from tpufhe_torch.bfv.keys.key_switching_key import KeySwitchingKey
from tpufhe_torch.errors import (
    InvalidCiphertext,
    InvalidLevel,
    UnsupportedOperation,
)
from tpufhe_torch.ops.rq import Switcher, ntt_backward


class RelinearizationKey:
    def __init__(self, ksk: KeySwitchingKey):
        self.ksk = ksk

    @staticmethod
    def new(sk, rng, ciphertext_level: int = 0, key_level: int = 0
            ) -> "RelinearizationKey":
        ctx_relin = sk.par.context_at_level(key_level)
        ctx_ct = sk.par.context_at_level(ciphertext_level)
        if ctx_relin.k == 1:
            raise UnsupportedOperation(
                "These parameters do not support key switching")
        s = sk.s_ntt(ctx_ct)
        s2 = ntt_backward(ctx_ct, ctx_ct.mul(s, s))
        s2_up = Switcher(ctx_ct, ctx_relin).switch(s2, ntt=False)
        ksk = KeySwitchingKey.new(sk, s2_up, ciphertext_level, key_level, rng)
        return RelinearizationKey(ksk)

    def relinearizes(self, ct: Ciphertext):
        """In place: (c0, c1, c2) -> (c0 + ks0, c1 + ks1), (ks0, ks1) the key
        switch of c2 (relinearization_key.rs:71-98): K1 inverse of c2, then
        pipeline.relinearize (K5 and one add for a Garner key where the
        fused tails fit, else K1 forward + ks_accumulate), or for a key
        below the ciphertext's level pipeline.key_switch_down and two
        adds."""
        if len(ct) != 3:
            raise InvalidCiphertext(
                "Only size-3 ciphertexts can be relinearized")
        if ct.level != self.ksk.ciphertext_level:
            raise InvalidLevel(ct.level)
        from tpufhe_torch.pipeline import key_switch_down, relinearize

        ctx = self.ksk.ctx_ciphertext
        c2 = ntt_backward(ctx, ct[2])
        if self.ksk.ctx_ksk is ctx:
            c0, c1 = relinearize(ctx, self.ksk, ct[0], ct[1], c2)
        else:
            ks = key_switch_down(ctx, c2, self.ksk)
            c0, c1 = ctx.add(ct[0], ks[0]), ctx.add(ct[1], ks[1])
        ct[0] = c0
        ct[1] = c1
        ct.truncate(2)

    def relinearizes_poly(self, c2):
        """The key switch (c0, c1) of power-basis c2, NTT domain of the
        key's context."""
        return self.ksk.key_switch(c2)

    # the Serialize / DeserializeParametrized traits
    # (fhe-traits/src/lib.rs:128-154)
    def to_bytes(self) -> bytes:
        from tpufhe_torch.serialize.codecs import serialize_relinearization_key

        return serialize_relinearization_key(self)

    @classmethod
    def from_bytes(cls, data: bytes, par) -> "RelinearizationKey":
        """The object of `data`, its tensors on par's device."""
        from tpufhe_torch.serialize.codecs import deserialize_relinearization_key

        return deserialize_relinearization_key(data, par)
