"""RGSW ciphertexts and the external product (fhe/src/bfv/rgsw_ciphertext.rs;
tpufhe's bfv/rgsw.py).

An RGSW ciphertext of m is a pair of key-switching keys at the
plaintext's level, of m and of m s; the external product ct (x) RGSW is
two key switches, of ct's two parts, summed: a multiplication whose noise
adds instead of multiplying.
"""

from __future__ import annotations

import torch

from tpufhe_torch.bfv.ciphertext import Ciphertext
from tpufhe_torch.bfv.keys.key_switching_key import KeySwitchingKey
from tpufhe_torch.bfv.plaintext import Plaintext
from tpufhe_torch.errors import (
    ContextMismatch,
    InvalidCiphertext,
    InvalidLevel,
)
from tpufhe_torch.ops.rq import ntt_backward


class RGSWCiphertext:
    def __init__(self, ksk0: KeySwitchingKey, ksk1: KeySwitchingKey):
        self.ksk0 = ksk0
        self.ksk1 = ksk1

    @property
    def par(self):
        return self.ksk0.par

    @staticmethod
    def encrypt(sk, pt: Plaintext, rng) -> "RGSWCiphertext":
        """Keys of m and m s at pt's level, in that order of draws
        (rgsw_ciphertext.rs:96-121): m and m s leave the NTT domain in one
        K1 launch."""
        if pt.par != sk.par:
            raise ContextMismatch("Incompatible BFV parameters")
        level = pt.level
        ctx = sk.par.context_at_level(level)
        m = pt.poly_ntt
        m_pb = ntt_backward(ctx, torch.stack([m, ctx.mul(sk.s_ntt(ctx), m)]))
        ksk0 = KeySwitchingKey.new(sk, m_pb[0], level, level, rng)
        ksk1 = KeySwitchingKey.new(sk, m_pb[1], level, level, rng)
        return RGSWCiphertext(ksk0, ksk1)

    def external_product(self, ct: Ciphertext) -> Ciphertext:
        """ct (x) RGSW (rgsw_ciphertext.rs:123-157) for a two-part ct of any
        batch at the keys' level: K1 inverse of both parts in one launch,
        then a key switch of each, the second accumulating onto the first
        (pipeline.key_switch: the first by ks_tail where the fused tails
        run, the second K1 forward of its digits and ks_accumulate)."""
        from tpufhe_torch.pipeline import key_switch

        if ct.par != self.par:
            raise ContextMismatch("Incompatible BFV parameters")
        if ct.level != self.ksk0.ciphertext_level:
            raise InvalidLevel(ct.level)
        if len(ct) != 2:
            raise InvalidCiphertext("The ciphertext is not of size 2")
        ctx = self.ksk0.ctx_ciphertext
        pb = ntt_backward(ctx, torch.stack([ct[0], ct[1]]))
        c = key_switch(ctx, pb[0], self.ksk0)
        c = key_switch(ctx, pb[1], self.ksk1, c[0], c[1])
        return Ciphertext(ct.par, [c[0], c[1]], ct.level)

    # the Serialize / DeserializeParametrized traits
    def to_bytes(self) -> bytes:
        from tpufhe_torch.serialize.codecs import serialize_rgsw

        return serialize_rgsw(self)

    @classmethod
    def from_bytes(cls, data: bytes, par) -> "RGSWCiphertext":
        from tpufhe_torch.serialize.codecs import deserialize_rgsw

        return deserialize_rgsw(data, par)
