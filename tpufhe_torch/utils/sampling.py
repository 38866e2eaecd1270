"""Centered binomial sampling (error distribution); a copy of
tpufhe/utils/sampling.py, native when ``tpufhe_torch.native`` is built.

Behavioral parity with fhe-util/src/lib.rs:22-55: each coefficient consumes
4*variance bits from a little-endian bit pool fed 64 bits at a time;
value = popcount(pool & mask_add) - popcount(pool & mask_sub).
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpufhe_torch import native
from tpufhe_torch.errors import ParametersError
from tpufhe_torch.utils.rngs import ChaChaRng


def sample_vec_cbd(vector_size: int, variance: int, rng) -> np.ndarray:
    """Sample i64 coefficients from a centered binomial of given variance.

    `rng` must expose next_u64() (e.g. utils.rngs.ChaChaRng).
    """
    if not (1 <= variance <= 16):
        raise ParametersError("The variance should be between 1 and 16")

    lib = native.lib()
    if lib is not None and isinstance(rng, ChaChaRng):
        st = rng._native_state()
        if st is not None:
            counter = ctypes.c_uint64(st[0])
            wp = ctypes.c_uint32(st[1])
            out = np.empty(vector_size, dtype=np.int64)
            lib.chacha_cbd(
                rng._key_arr(), rng._stream_u64(), rng._rounds,
                ctypes.byref(counter), ctypes.byref(wp), variance,
                vector_size,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            rng._adopt_native_state(counter.value, wp.value, lib)
            return out
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
