"""Key-switching keys (fhe/src/bfv/keys/key_switching_key.rs; tpufhe's
KeySwitchingKey), in the reference's two decomposition modes:

- RNS-Garner (k > 1): c0_i = e_i - c1_i s + garner_i from over the key
  context, one row per ciphertext modulus (key_switching_key.rs:126-169);
- single modulus (k == 1): log_base = ceil(log2 q0) / 2 and
  ceil(log2 q0 / log_base) rows, c0_i = e_i - c1_i s + 2^(i log_base) from
  (key_switching_key.rs:70-88, 172-211); a ciphertext row is cut into its
  base-2^log_base digits.

The key lives in the context of its level (ksk_level), which may hold more
moduli than the ciphertext's (a leveled key, ksk_level < ciphertext_level):
it has one Garner row per ciphertext modulus, each over the key's moduli.
c1_i are seed-chained uniform polynomials. Both are kept in the NTT domain
as (rows, k, N) tensors of the context's word type beside their Shoup
constants (floor(v 2^64 / p), or floor(v 2^32 / p) for a narrow context,
stored by bit pattern), which the key-switch accumulate consumes.
"""

from __future__ import annotations

import torch

from tpufhe_torch.errors import InvalidContext, TooFewValues
from tpufhe_torch.ops.rns import RnsContext
from tpufhe_torch.ops.rq import (
    from_i64_coeffs,
    ntt_backward,
    ntt_forward,
    random_rows,
    shoup_of,
)
from tpufhe_torch.utils.rngs import ChaCha8Rng, expand_seed
from tpufhe_torch.utils.sampling import sample_vec_cbd


def next_pow2_ilog2(x: int) -> int:
    """ilog2 of the next power of two at or above x (u64::next_power_of_two
    then ilog2)."""
    return (x - 1).bit_length() if x > 1 else 0


def decomposition_digits(p: torch.Tensor, log_base: int, ndigits: int
                         ) -> torch.Tensor:
    """The base-2^log_base digits of canonical power-basis (..., 1, N) rows
    of one modulus, lowest first: (ndigits, ..., 1, N), each below
    2^log_base (key_switching_key.rs:224-228)."""
    mask = (1 << log_base) - 1
    return torch.stack([(p >> (i * log_base)) & mask for i in range(ndigits)])


class KeySwitchingKey:
    def __init__(self, par, seed, c0, c0_shoup, c1, c1_shoup,
                 ciphertext_level, ksk_level, log_base: int = 0):
        self.par = par
        self.seed = seed
        self.c0 = c0  # (rows, k, N) NTT domain
        self.c0_shoup = c0_shoup
        self.c1 = c1
        self.c1_shoup = c1_shoup
        self.ciphertext_level = ciphertext_level
        self.ksk_level = ksk_level
        self.log_base = log_base  # 0: RNS-Garner rows
        self.ctx_ksk = par.context_at_level(ksk_level)
        self.ctx_ciphertext = par.context_at_level(ciphertext_level)

    @staticmethod
    def new(sk, from_poly: torch.Tensor, ciphertext_level: int, ksk_level: int,
            rng) -> "KeySwitchingKey":
        """from_poly: (k, N) power-basis polynomial of the key context."""
        par = sk.par
        ctx_ksk = par.context_at_level(ksk_level)
        ctx_ct = par.context_at_level(ciphertext_level)
        if tuple(from_poly.shape) != (ctx_ksk.k, ctx_ksk.degree):
            raise InvalidContext("Incorrect context for polynomial from")
        seed = rng.fill_bytes(32)
        log_base = 0
        if ctx_ksk.k == 1:
            log_modulus = next_pow2_ilog2(ctx_ksk.moduli[0])
            log_base = log_modulus // 2
            size = -(-log_modulus // log_base)
            scalars = [1 << (i * log_base) for i in range(size)]
        else:
            size = ctx_ct.k
            scalars = RnsContext(list(par.moduli[:size])).garner
        c1 = KeySwitchingKey._generate_c1(ctx_ksk, seed, size)
        c0 = KeySwitchingKey._generate_c0(sk, ctx_ksk, from_poly, c1, rng,
                                          scalars)
        return KeySwitchingKey(
            par, seed, c0, shoup_of(c0, ctx_ksk.moduli), c1,
            shoup_of(c1, ctx_ksk.moduli), ciphertext_level, ksk_level,
            log_base)

    @staticmethod
    def _generate_c1(ctx, seed: bytes, size: int) -> torch.Tensor:
        """Seed-chained uniform rows (key_switching_key.rs:108-123)."""
        rng = ChaCha8Rng(seed)
        rows = [random_rows(ctx, expand_seed(rng.fill_bytes(32)))
                for _ in range(size)]
        return torch.stack(rows)

    @staticmethod
    def _generate_c0(sk, ctx, from_poly: torch.Tensor, c1: torch.Tensor, rng,
                     scalars: list):
        """b_i = e_i - a_i s + scalars[i] from, in the NTT domain; the errors
        are drawn in row order."""
        size = c1.shape[0]
        if size == 0:
            raise TooFewValues(0, 1)
        a_s = ntt_backward(ctx, ctx.mul(c1, sk.s_ntt(ctx)[None]))
        e = torch.stack([
            from_i64_coeffs(sample_vec_cbd(ctx.degree, sk.par.variance, rng), ctx)
            for _ in range(size)])
        b = ctx.sub(e, a_s)
        scal = torch.tensor([[g % m for m in ctx.moduli] for g in scalars],
                            dtype=ctx.dtype, device=ctx.device)[..., None]
        b = ctx.add(b, ctx.mul(from_poly[None], scal))
        return ntt_forward(ctx, b)

    def key_switch(self, p: torch.Tensor) -> tuple:
        """(c0, c1) = sum_i d_i (c0_i, c1_i) in the NTT domain of the key's
        context, d_i the decomposition rows of power-basis p (..., k, N) of
        the ciphertext's context, reduced modulo every key modulus and
        forward-NTT'd (key_switching_key.rs:214-289): ks_tail on the card
        for a Garner key where the fused tails run, else K1 (K9 when
        narrow) and ks_accumulate (pipeline.key_switch)."""
        from tpufhe_torch.pipeline import key_switch

        ctx = self.ctx_ciphertext
        if tuple(p.shape[-2:]) != (ctx.k, ctx.degree):
            raise InvalidContext(
                "The input polynomial does not have the correct context")
        c = key_switch(self.ctx_ksk, p, self)
        return c[0], c[1]

    # the Serialize / DeserializeParametrized traits
    # (fhe-traits/src/lib.rs:128-154)
    def to_bytes(self) -> bytes:
        from tpufhe_torch.serialize.codecs import serialize_ksk

        return serialize_ksk(self)

    @classmethod
    def from_bytes(cls, data: bytes, par) -> "KeySwitchingKey":
        """The object of `data`, its tensors on par's device."""
        from tpufhe_torch.serialize.codecs import deserialize_ksk

        return deserialize_ksk(data, par)
