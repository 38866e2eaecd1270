"""Plaintext encodings (fhe/src/bfv/encoding.rs); a copy of
tpufhe/bfv/encoding.py."""

from __future__ import annotations

from dataclasses import dataclass

POLY = "poly"
SIMD = "simd"


@dataclass(frozen=True)
class Encoding:
    """Poly (coefficient) or Simd (CRT slot) encoding, at a level."""

    encoding: str
    level: int = 0

    @staticmethod
    def poly(level: int = 0) -> "Encoding":
        return Encoding(POLY, level)

    @staticmethod
    def simd(level: int = 0) -> "Encoding":
        return Encoding(SIMD, level)

    poly_at_level = poly
    simd_at_level = simd
