"""Small host utilities (modular inverse, sample variance): the port's
copy of tpufhe/utils/misc.py."""

from __future__ import annotations

import numpy as np


def inverse(a: int, p: int) -> int | None:
    """Modular multiplicative inverse of a mod p, or None if not invertible."""
    a, p = int(a) % int(p), int(p)
    if a == 0:
        return None
    g, x, _ = _egcd(a, p)
    if g != 1:
        return None
    return x % p


def _egcd(a: int, b: int):
    if a == 0:
        return b, 0, 1
    g, x, y = _egcd(b % a, a)
    return g, y - (b // a) * x, x


def variance(values) -> float:
    """Sample variance (n-1 denominator)."""
    v = np.asarray(values, dtype=np.float64)
    assert v.size > 1
    return float(v.var(ddof=1))
