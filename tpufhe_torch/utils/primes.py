"""Prime generation for NTT-friendly moduli (a copy of tpufhe/utils/primes.py,
so that tpufhe_torch imports nothing of tpufhe).

Behavioral parity with the reference:
- ``is_prime``: deterministic Miller-Rabin for u64 (reference uses
  num-bigint-dig probably_prime, fhe-util/src/lib.rs:16-18; for 64-bit inputs
  a deterministic witness set is exact).
- ``supports_opt``: NFLlib Equation (1) check (fhe-math/src/zq/primes.rs:10-24).
- ``generate_prime``: downward scan for primes == 1 mod `modulo`
  (fhe-math/src/zq/primes.rs:30-59), reproducing the NFLlib 62-bit sequence.
"""

from __future__ import annotations

# Deterministic Miller-Rabin witnesses for n < 3,317,044,064,679,887,385,961,981
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(p: int) -> bool:
    """Exact primality test for integers below 2^64 (and beyond, probabilistically)."""
    p = int(p)
    if p < 2:
        return False
    for small in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if p == small:
            return True
        if p % small == 0:
            return False
    d = p - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, p)
        if x == 1 or x == p - 1:
            continue
        for _ in range(r - 1):
            x = (x * x) % p
            if x == p - 1:
                break
        else:
            return False
    return True


def supports_opt(p: int) -> bool:
    """Whether p satisfies Eq. (1) of the NFLlib paper, enabling the
    single-mulhi lazy reduction (fhe-math/src/zq/primes.rs:10-24)."""
    p = int(p)
    lz = 64 - p.bit_length()
    if lz < 1:
        return False
    s0 = lz
    left = ((1 << (3 * s0)) + 1) << 64
    right = (1 << (3 * s0)) * ((1 << s0) + 1) * p
    return left < right


def generate_prime(num_bits: int, modulo: int, upper_bound: int) -> int | None:
    """Largest prime < upper_bound with exactly num_bits bits, == 1 mod modulo.

    Mirrors fhe-math/src/zq/primes.rs:30-59 (including the leading-zeros
    invariants), validated against the NFLlib 62-bit prime KAT.
    """
    if not (10 <= num_bits <= 62):
        return None
    assert (1 << num_bits) >= upper_bound, "upper_bound larger than number of bits"

    def leading_zeros(x: int) -> int:
        return 64 - x.bit_length()

    target_lz = 64 - num_bits
    tentative = upper_bound - 1
    while tentative % modulo != 1 and leading_zeros(tentative) == target_lz:
        tentative -= 1
    while (
        leading_zeros(tentative) == target_lz
        and not is_prime(tentative)
        and tentative >= modulo
    ):
        tentative -= modulo
    if leading_zeros(tentative) == target_lz and is_prime(tentative):
        return tentative
    return None
