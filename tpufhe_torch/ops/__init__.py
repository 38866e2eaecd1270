"""Compute core: modular arithmetic, NTT, RNS scaling, RNS polynomials."""
