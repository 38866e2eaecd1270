"""Secret keys: CBD sampling, symmetric encryption, decryption, noise meter.

The port of tpufhe/bfv/keys/secret_key.py (fhe/src/bfv/keys/secret_key.rs):
- encrypt_poly: b = e - a*s + m with a expanded from a fresh 32-byte seed,
  in the reference's draw order (seed, then the CBD error);
- try_decrypt: phase c0 + c1 s (+ c2 s^2 ...) -> t/q scale -> the
  host-side mod-t fold of the first plaintext-context row, or for a large
  t of every row, CRT-lifted (secret_key.rs:200-282);
- measure_noise: decrypt, re-encode, report the largest noise in bits.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufhe_torch.bfv.ciphertext import Ciphertext
from tpufhe_torch.bfv.parameters import BfvParameters
from tpufhe_torch.bfv.plaintext import Plaintext
from tpufhe_torch.errors import ContextMismatch, TooFewValues
from tpufhe_torch.ops.rq import (
    from_i64_coeffs,
    lift_bigints,
    ntt_backward,
    ntt_forward,
    random_from_seed,
)
from tpufhe_torch.utils.sampling import sample_vec_cbd


def scaled_plaintext(par: BfvParameters, d: torch.Tensor, level: int
                     ) -> Plaintext:
    """The plaintext of d, the t/q-scaled power-basis rows (k_plain, N) of
    the level's plaintext context: for a small t row 0 folded as
    ((v + t) mod q0) mod t, else every row CRT-lifted and folded with
    Python ints (secret_key.rs:131-142, 233-260)."""
    t = par.plaintext.value
    if not par.plaintext.is_small:
        plain = par.context_level_at(level).cipher_plain_context
        q_plain = plain.plaintext_context.modulus()
        value = [((v + t) % q_plain) % t for v in
                 lift_bigints(plain.plaintext_context, d)]
        return Plaintext(par, value, None, level)
    q0 = par.moduli[0]
    row0 = d[0].cpu().numpy().astype(np.uint64)
    value = ((row0 + np.uint64(t)) % np.uint64(q0)) % np.uint64(t)
    return Plaintext(par, value, None, level)


class SecretKey:
    """A secret key: N signed small coefficients, host-side."""

    def __init__(self, coeffs: np.ndarray, par: BfvParameters):
        self.par = par
        self.coeffs = np.array(coeffs, dtype=np.int64, copy=True)
        self._s_ntt: dict = {}
        self._enc_fns: dict = {}
        self._dec_fns: dict = {}

    @staticmethod
    def random(par: BfvParameters, rng) -> "SecretKey":
        return SecretKey(sample_vec_cbd(par.degree(), par.variance, rng), par)

    def zeroize(self) -> None:
        """Overwrite the key material in place (secret_key.rs:29-40, tpufhe
        secret_key.py:44-55): the host coefficients and every cached s in
        the NTT domain, and drop the cached programs, which hold s too."""
        coeffs = getattr(self, "coeffs", None)
        if coeffs is not None and coeffs.flags.writeable:
            coeffs.fill(0)
        for s in getattr(self, "_s_ntt", {}).values():
            s.zero_()
        for attr in ("_enc_fns", "_dec_fns"):
            if hasattr(self, attr):
                delattr(self, attr)

    def __del__(self):
        try:
            self.zeroize()
        except Exception:
            pass

    def s_ntt(self, ctx) -> torch.Tensor:
        """s in the NTT domain of `ctx`, (k, N), cached per context."""
        key = id(ctx)
        if key not in self._s_ntt:
            self._s_ntt[key] = ntt_forward(ctx, from_i64_coeffs(self.coeffs, ctx))
        return self._s_ntt[key]

    def _encrypt_fn(self, level: int):
        if level not in self._enc_fns:
            from tpufhe_torch.pipeline import make_encrypt_with_seed_expansion

            self._enc_fns[level] = make_encrypt_with_seed_expansion(
                self.par, self, level)
        return self._enc_fns[level]

    def _decrypt_fn(self, level: int):
        if level not in self._dec_fns:
            from tpufhe_torch.pipeline import make_decrypt_phase

            self._dec_fns[level] = make_decrypt_phase(self.par, self, level)
        return self._dec_fns[level]

    def encrypt_poly(self, m: torch.Tensor, level: int, rng) -> Ciphertext:
        """Symmetric encryption of an NTT-domain (k, N) polynomial."""
        ctx = self.par.context_at_level(level)
        seed = rng.fill_bytes(32)
        a = random_from_seed(ctx, seed)
        e = from_i64_coeffs(
            sample_vec_cbd(ctx.degree, self.par.variance, rng), ctx)
        b = self._encrypt_fn(level)(a, e, m)
        return Ciphertext(self.par, [b, a], level, seed=seed)

    def try_encrypt(self, pt: Plaintext, rng) -> Ciphertext:
        if pt.par != self.par:
            raise ContextMismatch("Incompatible BFV parameters")
        return self.encrypt_poly(pt.to_poly(), pt.level, rng)

    def _phase(self, ct: Ciphertext) -> torch.Tensor:
        """c0 + sum_i c_i s^i in the NTT domain of ct's level."""
        ctx = self.par.context_at_level(ct.level)
        s = self.s_ntt(ctx)
        si, c = s, ct[0]
        for i in range(1, len(ct)):
            c = ctx.add(c, ctx.mul(ct[i], si))
            if i + 1 < len(ct):
                si = ctx.mul(si, s)
        return c

    def try_decrypt(self, ct: Ciphertext) -> Plaintext:
        """The plaintext of ct of any number of parts (secret_key.rs:200-282):
        two parts through the fused decryption core (make_decrypt_phase),
        others by c0 + sum_i c_i s^i in the NTT domain, its inverse NTT and
        the level's t/q scaler (K1 inverse, K2)."""
        if ct.par != self.par:
            raise ContextMismatch("Incompatible BFV parameters")
        if not ct.c:
            raise TooFewValues(0, 1)
        if len(ct) == 2:
            d = self._decrypt_fn(ct.level)(ct[0], ct[1])
        else:
            ctx = self.par.context_at_level(ct.level)
            cp = self.par.context_level_at(ct.level).cipher_plain_context
            d = cp.scaler.rns_scaler.scale(ntt_backward(ctx, self._phase(ct)))
        return scaled_plaintext(self.par, d, ct.level)

    def measure_noise(self, ct: Ciphertext) -> int:
        """Largest noise across coefficients, in bits (secret_key.rs:63-100)."""
        pt = self.try_decrypt(ct)
        ctx = self.par.context_at_level(ct.level)
        c = ntt_backward(ctx, ctx.sub(self._phase(ct), pt.to_poly()))
        q = ctx.modulus()
        noise = 0
        for coeff in lift_bigints(ctx, c):
            noise = max(noise, min(coeff.bit_length(), (q - coeff).bit_length()))
        return noise

    # the Serialize / DeserializeParametrized traits
    # (fhe-traits/src/lib.rs:128-154)
    def to_bytes(self) -> bytes:
        from tpufhe_torch.serialize.codecs import serialize_secret_key

        return serialize_secret_key(self)

    @classmethod
    def from_bytes(cls, data: bytes, par) -> "SecretKey":
        """The object of `data`, its tensors on par's device."""
        from tpufhe_torch.serialize.codecs import deserialize_secret_key

        return deserialize_secret_key(data, par)
