"""Public keys (fhe/src/bfv/keys/public_key.rs; tpufhe's PublicKey):
pk = Enc_sk(0) at level 0; encryption draws u, e1 and e2 from the CBD
sampler, in that order, then runs one program (pipeline.make_pk_encrypt):
c0 = u pk0 + e1 + Delta m, c1 = u pk1 + e2. A plaintext below the key's
level is encrypted under the key switched down to its level."""

from __future__ import annotations

from tpufhe_torch.bfv.ciphertext import Ciphertext
from tpufhe_torch.bfv.encoding import Encoding
from tpufhe_torch.bfv.parameters import BfvParameters
from tpufhe_torch.bfv.plaintext import Plaintext
from tpufhe_torch.errors import ContextMismatch
from tpufhe_torch.ops.rq import from_i64_coeffs
from tpufhe_torch.utils.sampling import sample_vec_cbd


class PublicKey:
    def __init__(self, par: BfvParameters, c: Ciphertext):
        self.par = par
        self.c = c
        self._enc_fns: dict = {}

    @staticmethod
    def new(sk, rng) -> "PublicKey":
        zero = Plaintext.zero(Encoding.poly(), sk.par)
        return PublicKey(sk.par, sk.try_encrypt(zero, rng))

    def _encrypt_fn(self, level: int):
        if level not in self._enc_fns:
            from tpufhe_torch.pipeline import make_pk_encrypt

            self._enc_fns[level] = make_pk_encrypt(self.par, level)
        return self._enc_fns[level]

    def try_encrypt(self, pt: Plaintext, rng) -> Ciphertext:
        if pt.par != self.par:
            raise ContextMismatch("Incompatible BFV parameters")
        ct = self.c
        if ct.level != pt.level:
            ct = ct.clone()
            ct.switch_to_level(pt.level)
        ctx = self.par.context_at_level(ct.level)
        var = self.par.variance
        u, e1, e2 = (from_i64_coeffs(sample_vec_cbd(ctx.degree, var, rng), ctx)
                     for _ in range(3))
        c0, c1 = self._encrypt_fn(ct.level)(u, e1, e2, pt.to_poly(), ct[0],
                                            ct[1])
        return Ciphertext(self.par, [c0, c1], ct.level)

    # the Serialize / DeserializeParametrized traits
    # (fhe-traits/src/lib.rs:128-154)
    def to_bytes(self) -> bytes:
        from tpufhe_torch.serialize.codecs import serialize_public_key

        return serialize_public_key(self)

    @classmethod
    def from_bytes(cls, data: bytes, par) -> "PublicKey":
        """The object of `data`, its tensors on par's device."""
        from tpufhe_torch.serialize.codecs import deserialize_public_key

        return deserialize_public_key(data, par)
