"""Centered binomial sampling (error distribution); the pure-Python branch
of tpufhe/utils/sampling.py.

Behavioral parity with fhe-util/src/lib.rs:22-55: each coefficient consumes
4*variance bits from a little-endian bit pool fed 64 bits at a time;
value = popcount(pool & mask_add) - popcount(pool & mask_sub).
"""

from __future__ import annotations

import numpy as np

from tpufhe_torch.errors import ParametersError


def sample_vec_cbd(vector_size: int, variance: int, rng) -> np.ndarray:
    """Sample i64 coefficients from a centered binomial of given variance.

    `rng` must expose next_u64() (e.g. utils.rngs.ChaChaRng).
    """
    if not (1 <= variance <= 16):
        raise ParametersError("The variance should be between 1 and 16")
    number_bits = 4 * variance
    mask_add = ((1 << number_bits) - 1) >> (2 * variance)
    mask_sub = mask_add << (2 * variance)

    out = np.empty(vector_size, dtype=np.int64)
    pool = 0
    pool_nbits = 0
    for i in range(vector_size):
        if pool_nbits < number_bits:
            pool |= rng.next_u64() << pool_nbits
            pool_nbits += 64
        out[i] = (pool & mask_add).bit_count() - (pool & mask_sub).bit_count()
        pool >>= number_bits
        pool_nbits -= number_bits
    return out
