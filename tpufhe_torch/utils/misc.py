"""Modular inverse: the part of tpufhe/utils/misc.py that the port uses."""

from __future__ import annotations


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
