"""Plain arithmetic of R_q = Z_q[X]/(X^N + 1) in NumPy: fhe.rs's prime
generation, its NTT tables (the primitive root from a ChaCha8 stream
seeded with 0, bit-reversed powers) and the negacyclic transforms in its
order, so that a residue in the NTT domain means what it means in
fhe.rs. Residues are uint64 below moduli of at most 62 bits; a product is
reduced exactly with a long-double quotient and a correction (mulmod),
and CRT lifts are Python integers in object arrays.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from fhebench.reference.chacha import Stream, random_range, seed_from_u64

_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(p: int) -> bool:
    """Deterministic Miller-Rabin, exact below 3.3e24."""
    if p < 2:
        return False
    for w in _WITNESSES:
        if p % w == 0:
            return p == w
    d, r = p - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _WITNESSES:
        x = pow(a, d, p)
        if x in (1, p - 1):
            continue
        for _ in range(r - 1):
            x = x * x % p
            if x == p - 1:
                break
        else:
            return False
    return True


def generate_prime(bits: int, modulo: int, upper: int) -> int | None:
    """The largest prime below `upper` of exactly `bits` bits and equal to
    1 mod `modulo` (fhe-math zq/primes.rs generate_prime)."""
    tent = upper - 1
    while tent % modulo != 1 and tent.bit_length() == bits:
        tent -= 1
    while tent.bit_length() == bits and not is_prime(tent) and tent >= modulo:
        tent -= modulo
    if tent.bit_length() == bits and is_prime(tent):
        return tent
    return None


def generate_moduli(sizes, degree: int) -> list[int]:
    """Distinct NTT-friendly primes of the given bit sizes
    (fhe.rs parameters.rs generate_moduli)."""
    moduli: list[int] = []
    for size in sizes:
        upper = 1 << size
        while True:
            p = generate_prime(size, 2 * degree, upper)
            if p is None:
                raise ValueError(f"no {size}-bit prime for degree {degree}")
            if p not in moduli:
                moduli.append(p)
                break
            upper = p
    return moduli


def bitrev(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        out |= ((idx >> b) & 1) << (logn - 1 - b)
    return out


def primitive_root(n: int, p: int) -> int:
    """A primitive 2n-th root of unity mod p by fhe.rs's seeded search
    (ntt/native.rs): candidates random_range(0..p)^((p - 1) / 2n) from
    ChaCha8 seeded by seed_from_u64(0)."""
    lam = (p - 1) // (2 * n)
    rng = Stream(seed_from_u64(0))
    for _ in range(100):
        root = pow(random_range(rng, p), lam, p)
        if pow(root, 2 * n, p) == 1 and pow(root, n, p) != 1:
            return root
    raise RuntimeError("no primitive root found")


def _check_longdouble() -> None:
    if np.finfo(np.longdouble).nmant < 63:
        raise RuntimeError("the reference's products need a long double of "
                           "64 significant bits (x86-64)")


def mulmod(a: np.ndarray, b: np.ndarray, p: np.ndarray) -> np.ndarray:
    """a b mod p, exact, for uint64 residues below p < 2^62: the quotient
    from a 64-bit-significand long double is off by at most one, and the
    remainder a b - q p, taken modulo 2^64, lies in (-p, 2p)."""
    _check_longdouble()
    q = np.floor(a.astype(np.longdouble) * b.astype(np.longdouble)
                 / p.astype(np.longdouble)).astype(np.uint64)
    r = (a * b - q * p).view(np.int64)
    pi = p.astype(np.int64)
    r = np.where(r < 0, r + pi, r)
    return np.where(r >= pi, r - pi, r).view(np.uint64)


@lru_cache(maxsize=None)
def ntt_table(p: int, n: int) -> tuple:
    """(omegas, zetas_inv, n^-1 mod p): the bit-reversed powers of the
    root and of its inverse, uint64."""
    w = primitive_root(n, p)
    winv = pow(w, -1, p)
    pw, pwi = [1] * n, [winv] * n
    for i in range(1, n):
        pw[i] = pw[i - 1] * w % p
        pwi[i] = pwi[i - 1] * winv % p
    rev = bitrev(n)
    omegas = np.array([pw[i] for i in rev], dtype=np.uint64)
    zetas = np.array([pwi[i] for i in rev], dtype=np.uint64)
    return omegas, zetas, pow(n, -1, p)


def _tables(moduli, n: int, which: int) -> np.ndarray:
    return np.stack([ntt_table(p, n)[which] for p in moduli])


def _col(moduli, ndim: int) -> np.ndarray:
    return np.array(moduli, dtype=np.uint64).reshape((-1,) + (1,) * ndim)


def forward(x: np.ndarray, moduli) -> np.ndarray:
    """The forward negacyclic NTT of uint64 rows (..., k, N), row j mod
    moduli[j], in fhe.rs's order (Cooley-Tukey, bit-reversed output)."""
    n = x.shape[-1]
    omegas = _tables(moduli, n, 0)
    lead = x.shape[:-1]
    p = _col(moduli, 2)
    l, m = n >> 1, 1
    while l > 0:
        x = x.reshape(lead + (m, 2, l))
        a = x[..., 0, :]
        t = mulmod(x[..., 1, :], omegas[:, m:2 * m, None], p)
        x = np.stack([np.where(a + t >= p, a + t - p, a + t),
                      np.where(a >= t, a - t, a + p - t)],
                     axis=-2).reshape(lead + (n,))
        l >>= 1
        m <<= 1
    return x


def backward(x: np.ndarray, moduli) -> np.ndarray:
    """The inverse of forward, with the n^-1 fold."""
    n = x.shape[-1]
    zetas = _tables(moduli, n, 1)
    lead = x.shape[:-1]
    p = _col(moduli, 2)
    l, k = 1, 0
    while l < n:
        m = n // (2 * l)
        x = x.reshape(lead + (m, 2, l))
        a, b = x[..., 0, :], x[..., 1, :]
        x = np.stack([np.where(a + b >= p, a + b - p, a + b),
                      mulmod(np.where(a >= b, a - b, a + p - b),
                             zetas[:, k:k + m, None], p)],
                     axis=-2).reshape(lead + (n,))
        k += m
        l <<= 1
    ninv = np.array([ntt_table(q, n)[2] for q in moduli], dtype=np.uint64)
    return mulmod(x, ninv[:, None], _col(moduli, 1))


def scale_round(rows: np.ndarray, moduli, t: int) -> np.ndarray:
    """round(t x / Q) mod t of the integers x (..., N) that residue rows
    (..., k, N) stand for, Q the product of the moduli: decryption's
    scale. With a_i = x_i (Q / q_i)^-1 mod q_i, t x / Q = sum_i t a_i /
    q_i mod t; each t a_i = u_i q_i + v_i exactly (a long-double quotient
    and a correction, as in mulmod), and the fractions v_i / q_i are
    summed in long double. So the result is exact unless sum v_i / q_i
    lies within about 2^-60 of a half, where a ciphertext that decrypts
    never comes: its fraction lies within t |e| / Q of an integer."""
    _check_longdouble()
    q = 1
    for m in moduli:
        q *= m
    tu = np.uint64(t)
    total = np.zeros(rows.shape[:-2] + rows.shape[-1:], dtype=np.uint64)
    frac = np.zeros(total.shape, dtype=np.longdouble)
    for x, qi in zip(np.moveaxis(rows, -2, 0), moduli):
        p = np.full(1, qi, dtype=np.uint64)
        a = mulmod(x, np.full(1, pow(q // qi, -1, qi), dtype=np.uint64), p)
        u = np.floor(a.astype(np.longdouble) * t / qi).astype(np.uint64)
        v = (a * tu - u * p).view(np.int64)
        low, high = v < 0, v >= np.int64(qi)
        u = u - low.astype(np.uint64) + high.astype(np.uint64)
        v = (v + np.where(low, np.int64(qi), 0)
             - np.where(high, np.int64(qi), 0))
        total += u
        frac += v.astype(np.longdouble) / qi
    return (total + np.floor(frac + 0.5).astype(np.uint64)) % tu


def garner(moduli) -> list[int]:
    """The CRT (Garner) coefficients (Q / q_i) ((Q / q_i)^-1 mod q_i)."""
    q = 1
    for m in moduli:
        q *= m
    return [(q // m) * pow(q // m, -1, m) % q for m in moduli]


def crt(rows: np.ndarray, moduli) -> np.ndarray:
    """Residue rows (..., k, N) -> the integers (..., N) in [0, Q) they
    stand for."""
    q = 1
    for m in moduli:
        q *= m
    acc = 0
    for r, g in zip(np.moveaxis(rows, -2, 0), garner(moduli)):
        acc = acc + r.astype(object) * g
    return acc % q
