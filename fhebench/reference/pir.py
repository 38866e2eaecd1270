"""MulPIR's server written again from fhe.rs's definitions in plain NumPy
(examples/mulpir.rs; evaluation_key.rs expands, galois_key.rs apply,
key_switching_key.rs key_switch, relinearization_key.rs, fhe-math's
mod_switch_down_next): the oblivious expansion with leveled Galois keys,
the first dimension's products with the database rows, the second
dimension's ciphertext products, relinearization and the switch to the
last level.

The second dimension is exact: the products of the centred lifts are
summed in an auxiliary NTT basis wide enough to hold them, lifted to
integers and scaled by t / Q with rounding to nearest. Every other step
is exact residue arithmetic. The keys are the reference's own
(bfv.Replay); nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

from fhebench.reference import ring
from fhebench.reference.bfv import U64, addmod, col, submod


def substitute_rows(x: np.ndarray, exponent: int, moduli) -> np.ndarray:
    """x(X) -> x(X^e) of power-basis residues (..., k, N)."""
    n = x.shape[-1]
    pos = np.arange(n, dtype=np.int64) * exponent
    neg = (pos % (2 * n)) >= n
    p = col(moduli)
    out = np.empty_like(x)
    out[..., pos % n] = np.where(neg & (x != 0), p - x, x)
    return out


def switch_down(x: np.ndarray, moduli) -> np.ndarray:
    """Power-basis residues (..., k, N) divided by the last modulus and
    rounded to nearest: (..., k - 1, N) over moduli[:-1]."""
    ql = moduli[-1]
    h = ql // 2
    last = (x[..., -1, :] + U64(h)) % U64(ql)
    rows = []
    for i, q in enumerate(moduli[:-1]):
        p = np.full(1, q, dtype=U64)
        r = (last % U64(q) + U64(q - h % q)) % U64(q)
        rows.append(ring.mulmod(submod(x[..., i, :], r, p),
                                np.full(1, pow(ql, -1, q), dtype=U64), p))
    return np.stack(rows, axis=-2)


def key_switch(c2: np.ndarray, key: tuple, key_moduli) -> tuple:
    """Σ_i c2_i (k0_i, k1_i) in the NTT domain of the key's moduli: c2
    (..., rows, N) power-basis residues at the ciphertext's level, row i
    taken as the integers [0, q_i) it holds."""
    k0, k1 = key
    p = col(key_moduli)
    acc0 = acc1 = None
    for i in range(c2.shape[-2]):
        d = ring.forward(np.stack([c2[..., i, :] % U64(q) for q in key_moduli],
                                  axis=-2), key_moduli)
        t0, t1 = ring.mulmod(d, k0[i], p), ring.mulmod(d, k1[i], p)
        acc0 = t0 if acc0 is None else addmod(acc0, t0, p)
        acc1 = t1 if acc1 is None else addmod(acc1, t1, p)
    return acc0, acc1


def to_level(x: np.ndarray, moduli, count: int) -> np.ndarray:
    """Power-basis residues switched down until `count` moduli remain."""
    moduli = list(moduli)
    while len(moduli) > count:
        x = switch_down(x, moduli)
        moduli = moduli[:-1]
    return x


def galois_apply(c0, c1, exponent, key, key_moduli, moduli) -> tuple:
    """A ciphertext (NTT residues (..., k, N) at `moduli`) under x -> x^e,
    key-switched back to s."""
    p = col(moduli)
    sub1 = substitute_rows(ring.backward(c1, moduli), exponent, moduli)
    k0, k1 = key_switch(sub1, key, key_moduli)
    if len(key_moduli) > len(moduli):
        k0, k1 = (ring.forward(to_level(ring.backward(k, key_moduli),
                                        key_moduli, len(moduli)), moduli)
                  for k in (k0, k1))
    sub0 = ring.forward(substitute_rows(ring.backward(c0, moduli), exponent,
                                        moduli), moduli)
    return addmod(k0, sub0, p), k1


def monomial(n: int, l: int, moduli) -> np.ndarray:
    """x^{-2^l} = -x^{N - 2^l} in the NTT domain."""
    v = np.zeros((len(moduli), n), dtype=U64)
    v[:, n - (1 << l)] = [q - 1 for q in moduli]
    return ring.forward(v, moduli)


def expand(c0, c1, levels: int, keys: dict, key_moduli, moduli) -> tuple:
    """The oblivious expansion of one query into 2^levels ciphertexts:
    two arrays (2^levels, k, N) of NTT residues."""
    n = c0.shape[-1]
    p = col(moduli)
    cur0, cur1 = c0[None], c1[None]
    for l in range(levels):
        e = (n >> l) + 1
        s0, s1 = galois_apply(cur0, cur1, e, keys[e], key_moduli, moduli)
        mono = monomial(n, l, moduli)
        new0 = ring.mulmod(submod(cur0, s0, p), mono, p)
        new1 = ring.mulmod(submod(cur1, s1, p), mono, p)
        cur0 = np.concatenate([addmod(cur0, s0, p), new0])
        cur1 = np.concatenate([addmod(cur1, s1, p), new1])
    return cur0, cur1


def centred(rows: np.ndarray, moduli) -> np.ndarray:
    """Residue rows (..., k, N) -> the integers in [-Q/2, Q/2) (objects)."""
    q = 1
    for m in moduli:
        q *= m
    x = ring.crt(rows, moduli)
    return np.where(x >= q // 2 + (q & 1), x - q, x)


def answer(par, rep, gkeys: dict, rk: tuple, query: tuple, row_values,
           dims: tuple, level: int, key_level: int) -> tuple:
    """The last-level answer (c0, c1), power-basis residues (1, N) each,
    to one query (c0, c1 NTT residues at `level`); row_values(r) gives
    database row r's plaintext coefficients, rows r = i dim2 + j."""
    dim1, dim2 = dims
    n, t = par.degree, par.plaintext
    m = par.level_moduli(level)
    km = par.level_moduli(key_level)
    p = col(m)
    levels = (dim1 + dim2 - 1).bit_length()
    e0, e1 = expand(query[0], query[1], levels, gkeys, km, m)
    # first dimension: resp_j = Σ_i db[i, j] e_i
    r0 = np.zeros((dim2, len(m), n), dtype=U64)
    r1 = np.zeros_like(r0)
    for i in range(dim1):
        vals = np.stack([row_values(i * dim2 + j) for j in range(dim2)])
        db = ring.forward(np.stack([vals % U64(q) for q in m], axis=1), m)
        r0 = addmod(r0, ring.mulmod(db, e0[i], p), p)
        r1 = addmod(r1, ring.mulmod(db, e1[i], p), p)
    # second dimension: Σ_j sel_j (x) resp_j, exact, then t / Q rounded
    q_all = 1
    for q in m:
        q_all *= q
    aux = ring.generate_moduli([62] * 5, n)
    pa = col(aux)

    def lift(x):
        return ring.forward(
            np.stack([(centred(ring.backward(x, m), m) % a).astype(U64)
                      for a in aux], axis=-2), aux)

    acc = [np.zeros((len(aux), n), dtype=U64) for _ in range(3)]
    for j in range(dim2):
        s0, s1 = lift(e0[dim1 + j]), lift(e1[dim1 + j])
        a0, a1 = lift(r0[j]), lift(r1[j])
        for k, x, y in ((0, s0, a0), (1, s0, a1), (1, s1, a0), (2, s1, a1)):
            acc[k] = addmod(acc[k], ring.mulmod(x, y, pa), pa)
    parts = []
    for x in acc:
        v = centred(ring.backward(x, aux), aux)
        y = (2 * t * v + q_all) // (2 * q_all)
        parts.append(np.stack([(y % q).astype(U64) for q in m]))
    # relinearization at the ciphertexts' level, then the last level
    k0, k1 = key_switch(parts[2], rk, m)
    c0 = addmod(ring.forward(parts[0], m), k0, p)
    c1 = addmod(ring.forward(parts[1], m), k1, p)
    return tuple(to_level(ring.backward(c, m), m, 1) for c in (c0, c1))


def noise_bits(rep, c0, c1, want: np.ndarray, level: int) -> float:
    """log2 of the largest |c0 + c1 s - floor(Q m / t)| mod Q, centred,
    of a two-part power-basis ciphertext that should hold `want`; the
    answer decrypts right while this stays under log2(Q / 2t)."""
    par = rep.par
    m = par.level_moduli(level)
    p = col(m)
    x = addmod(c0, ring.backward(ring.mulmod(ring.forward(c1, m),
                                             rep.s_ntt(m), p), m), p)
    q_all = 1
    for q in m:
        q_all *= q
    e = (ring.crt(x, m) - (want.astype(object) * q_all) // par.plaintext) \
        % q_all
    e = np.where(e >= q_all // 2, q_all - e, e)
    return float(np.log2(float(max(int(e.max()), 1))))
