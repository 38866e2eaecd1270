"""The card's peaks and the cost of the modular operations, frozen from
chip_smoke.py (:498-507, :542-571, :888-896).

A launch's least time is max(bytes / MEM_BYTES_PER_S, int32 multiplies /
INT32_MULS_PER_S). The memory rate is NVIDIA's published peak of one H100
SXM. The int32 multiply rate is derived, not published: 132 SMs x 64
multiplies a clock (CUDA C++ Programming Guide, compute capability 9.0)
x the 1980 MHz boost clock; a traced run samples the card's clock beside
its window.
"""

from __future__ import annotations

import math

MEM_BYTES_PER_S = 3.35e12
INT32_MULS_PER_S = 132 * 64 * 1980e6

# int32 multiplies of a 64 x 64 -> 64 low product (three partial
# products) and of a high product (four) (csrc/modarith.cuh)
LO, HI = 3, 4
SHOUP = HI + 2 * LO  # lazy_mul_shoup
RED128 = 3 * HI + 4 * LO  # reduce_u128
MULMOD = LO + HI + RED128
SHOUP32 = 3  # a narrow (w30) Shoup product
# a K3 / K7 tensor coefficient: two mul_mod and one mul_add_mod
TENSOR_OPS = 2 * MULMOD + 2 * (LO + HI) + RED128


def bound(nbytes: int, ops: int) -> tuple:
    """(least seconds, "bytes" or "operations": the term that bounds)."""
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = ops / INT32_MULS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ntt_ops(n: int, inverse: bool, shoup: int = SHOUP) -> int:
    """One length-n transform: a Shoup product per butterfly, and per word
    for the inverse's n^-1 fold."""
    ops = (n // 2) * int(math.log2(n)) * shoup
    return ops + n * shoup if inverse else ops


def ks_digit_ops(moduli, n: int) -> int:
    """One digit row of a key-switch tail: its forward transform, two Shoup
    products a coefficient, and a reduce_u64 (two low and two high
    products) where a limb can reach 4 p_j."""
    reduce = any(p_i >= 4 * p_j for p_i in moduli for p_j in moduli)
    return n * (2 * (LO + HI) * reduce + 2 * SHOUP) + ntt_ops(n, False)


def scale_ops(is_one: bool, k_in: int, size: int, coeffs: int) -> int:
    """The HPS scaler's body on `coeffs` coefficients into `size` limbs."""
    per = 2 * k_in * (LO + HI)
    per_out = 2 * RED128 + SHOUP + k_in * (LO + HI)
    if not is_one:
        per += 2 * k_in * (LO + HI) + 4 * (LO + HI)
        per_out += RED128
    return coeffs * (per + size * per_out)
