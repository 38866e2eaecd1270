"""Key-switching keys, RNS-Garner decomposition mode
(fhe/src/bfv/keys/key_switching_key.rs:126-169; tpufhe's KeySwitchingKey).

c1_i are seed-chained uniform polynomials; c0_i = e_i - c1_i s + garner_i
from over the key context. Both are kept in the NTT domain as (rows, k, N)
tensors of the context's word type beside their Shoup constants
(floor(v 2^64 / p), or floor(v 2^32 / p) for a narrow context, stored by
bit pattern), which the key-switch accumulate consumes. The
single-modulus digit decomposition (k == 1) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufhe_torch.errors import InvalidContext, TooFewValues, UnsupportedOperation
from tpufhe_torch.ops import zq, zq32
from tpufhe_torch.ops.rns import RnsContext
from tpufhe_torch.ops.rq import (
    from_i64_coeffs,
    ntt_backward,
    ntt_forward,
    random_rows,
)
from tpufhe_torch.utils.rngs import ChaCha8Rng, expand_seed
from tpufhe_torch.utils.sampling import sample_vec_cbd


def shoup_of(x: torch.Tensor, moduli) -> torch.Tensor:
    """Shoup constants of canonical (..., k, N) residues, same device and
    word type: floor(v 2^64 / p) for int64 rows, floor(v 2^32 / p) for the
    int32 rows of a narrow context (tpufhe's shoup32)."""
    vals = x.cpu().numpy()
    if x.dtype == torch.int32:
        return torch.from_numpy(zq32.shoup_array(vals, moduli)).to(x.device)
    arr = zq.shoup_array(vals.astype(np.uint64), moduli)
    return torch.from_numpy(zq.as_int64(arr)).to(x.device)


class KeySwitchingKey:
    def __init__(self, par, seed, c0, c0_shoup, c1, c1_shoup,
                 ciphertext_level, ksk_level):
        self.par = par
        self.seed = seed
        self.c0 = c0  # (rows, k, N) NTT domain
        self.c0_shoup = c0_shoup
        self.c1 = c1
        self.c1_shoup = c1_shoup
        self.ciphertext_level = ciphertext_level
        self.ksk_level = ksk_level
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
        if ctx_ksk.k == 1:
            raise UnsupportedOperation(
                "the single-modulus (k == 1) decomposition is not ported yet")
        seed = rng.fill_bytes(32)
        c1 = KeySwitchingKey._generate_c1(ctx_ksk, seed, ctx_ct.k)
        c0 = KeySwitchingKey._generate_c0(sk, ctx_ksk, from_poly, c1, rng)
        return KeySwitchingKey(
            par, seed, c0, shoup_of(c0, ctx_ksk.moduli), c1,
            shoup_of(c1, ctx_ksk.moduli), ciphertext_level, ksk_level)

    @staticmethod
    def _generate_c1(ctx, seed: bytes, size: int) -> torch.Tensor:
        """Seed-chained uniform rows (key_switching_key.rs:108-123)."""
        rng = ChaCha8Rng(seed)
        rows = [random_rows(ctx, expand_seed(rng.fill_bytes(32)))
                for _ in range(size)]
        return torch.stack(rows)

    @staticmethod
    def _generate_c0(sk, ctx, from_poly: torch.Tensor, c1: torch.Tensor, rng):
        """b_i = e_i - a_i s + garner_i from, in the NTT domain; the errors
        are drawn in row order."""
        size = c1.shape[0]
        if size == 0:
            raise TooFewValues(0, 1)
        garner = RnsContext(list(sk.par.moduli[:size])).garner
        a_s = ntt_backward(ctx, ctx.mul(c1, sk.s_ntt(ctx)[None]))
        e = torch.stack([
            from_i64_coeffs(sample_vec_cbd(ctx.degree, sk.par.variance, rng), ctx)
            for _ in range(size)])
        b = ctx.sub(e, a_s)
        scal = torch.tensor([[g % m for m in ctx.moduli] for g in garner],
                            dtype=ctx.dtype, device=ctx.device)[..., None]
        b = ctx.add(b, ctx.mul(from_poly[None], scal))
        return ntt_forward(ctx, b)

