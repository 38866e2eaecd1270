"""BFV as fhe.rs defines it, written again in NumPy from the seed: the
parameters, the keys and encryptions drawn from a ChaCha8 stream in the
order a set-up draws them, decryption, SIMD and PIR decoding, and the
wire format of a ciphertext. The benchmark hands the program's keys,
inputs and outputs to these functions, which compare them word for word
with what they work out again, or decrypt them with the secret key they
draw themselves.

Nothing here imports the program: the reference takes no table, key or
constant that the program made.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fhebench.reference import ring
from fhebench.reference.chacha import (
    Stream,
    cbd,
    expand_seed,
    seed_from_u64,
    uniform_below,
)

U64 = np.uint64


@dataclass
class Params:
    """A BFV parameter set: degree, plaintext modulus, the moduli sizes
    and the variance of the error and key distributions (10, fhe.rs's
    default)."""

    degree: int
    plaintext: int
    moduli_sizes: tuple
    variance: int = 10

    def __post_init__(self):
        self.moduli = ring.generate_moduli(self.moduli_sizes, self.degree)

    def level_moduli(self, level: int) -> list[int]:
        return self.moduli[: len(self.moduli) - level]

    def index_map(self) -> np.ndarray:
        """The SEAL batch encoder's slot permutation (parameters.rs)."""
        n = self.degree
        row, m2, pos = n >> 1, n << 1, 1
        rev = ring.bitrev(n)
        out = np.zeros(n, dtype=np.int64)
        for i in range(row):
            out[i] = rev[(pos - 1) >> 1]
            out[row | i] = rev[(m2 - pos - 1) >> 1]
            pos = pos * 3 & (m2 - 1)
        return out


def col(moduli) -> np.ndarray:
    return np.array(moduli, dtype=U64)[:, None]


def reduce_signed(v: np.ndarray, moduli) -> np.ndarray:
    """Signed int64 coefficients (N,) into every limb: (k, N) uint64."""
    return np.stack([np.mod(v, q).astype(U64) for q in moduli])


def addmod(a, b, p):
    s = a + b
    return np.where(s >= p, s - p, s)


def submod(a, b, p):
    return np.where(a >= b, a - b, a + p - b)


def substitute_power(v: np.ndarray, exponent: int) -> np.ndarray:
    """x(X) -> x(X^e) of signed coefficients (N,): coefficient j goes to
    j e mod N, negated where j e mod 2N >= N."""
    n = v.shape[-1]
    pos = np.arange(n, dtype=np.int64) * exponent
    out = np.empty_like(v)
    out[pos % n] = np.where((pos % (2 * n)) >= n, -v, v)
    return out


class Replay:
    """The set-up's draws from ChaCha8(seed_from_u64(seed)), in its order:
    the secret key, then each key-switching key and encryption as the
    benchmark's set-up makes them."""

    def __init__(self, par: Params, seed: int):
        self.par = par
        self.stream = Stream(seed_from_u64(seed))
        self.s = cbd(self.stream, par.degree, par.variance)
        self._s_ntt: dict = {}

    def s_ntt(self, moduli) -> np.ndarray:
        key = tuple(moduli)
        if key not in self._s_ntt:
            self._s_ntt[key] = ring.forward(reduce_signed(self.s, moduli),
                                            list(moduli))
        return self._s_ntt[key]

    def ksk(self, from_pb: np.ndarray, ct_level: int, key_level: int
            ) -> tuple:
        """(c0, c1), each (rows, k, N) in the NTT domain of the key's
        level: c1 the seed-chained uniform rows, c0 = NTT(e_i + g_i from)
        - c1 s, g_i the Garner coefficients of the ciphertext's moduli and
        from (k, N) uint64 in the power basis (key_switching_key.rs)."""
        par = self.par
        km = par.level_moduli(key_level)
        rows = len(par.level_moduli(ct_level))
        chain = Stream(self.stream.bytes(32))
        c1 = []
        for _ in range(rows):
            row_stream = expand_seed(chain.bytes(32))
            c1.append(np.stack([uniform_below(row_stream, q, par.degree)
                                for q in km]).astype(U64))
        c1 = np.stack(c1)
        p = col(km)
        s_ntt = self.s_ntt(km)
        c0 = []
        for i, g in enumerate(ring.garner(par.moduli[:rows])):
            e = reduce_signed(cbd(self.stream, par.degree, par.variance), km)
            gf = ring.mulmod(from_pb, np.array([g % q for q in km],
                                               dtype=U64)[:, None], p)
            c0.append(submod(ring.forward(addmod(e, gf, p), km),
                             ring.mulmod(c1[i], s_ntt, p), p))
        return np.stack(c0), c1

    def relin_key(self, level: int = 0) -> tuple:
        """The relinearization key of s^2 at the ciphertexts' level."""
        m = self.par.level_moduli(level)
        s = self.s_ntt(m)
        s2 = ring.backward(ring.mulmod(s, s, col(m)), m)
        return self.ksk(s2, level, level)

    def galois_key(self, exponent: int, ct_level: int, key_level: int
                   ) -> tuple:
        """The Galois key of x -> x^exponent: s(X^e) switched up from the
        ciphertexts' level into the key's (times Q_key / Q_ct)."""
        factor = 1
        for q in self.par.moduli[len(self.par.level_moduli(ct_level)):
                                 len(self.par.level_moduli(key_level))]:
            factor *= q
        sub = substitute_power(self.s, exponent)
        km = self.par.level_moduli(key_level)
        from_pb = np.stack([np.mod(sub.astype(object) * factor, q)
                            .astype(U64) for q in km])
        return self.ksk(from_pb, ct_level, key_level)

    def encryption(self, m_pb: np.ndarray, level: int) -> tuple:
        """(c0, c1, seed) of the next symmetric encryption of the plaintext
        polynomial m_pb (coefficients mod t, up to N): a 32-byte seed, then
        the error; c1 = a from the seed, c0 = NTT(e + Delta m') - a s with
        m' = m (Q mod t) mod t and Delta = (-t)^-1 mod Q
        (secret_key.rs, plaintext.rs)."""
        par = self.par
        m = par.level_moduli(level)
        p = col(m)
        seed = self.stream.bytes(32)
        a_stream = expand_seed(seed)
        a = np.stack([uniform_below(a_stream, q, par.degree)
                      for q in m]).astype(U64)
        e = reduce_signed(cbd(self.stream, par.degree, par.variance), m)
        q_all = 1
        for q in m:
            q_all *= q
        mm = np.zeros(par.degree, dtype=U64)
        mm[: len(m_pb)] = (m_pb.astype(object) * (q_all % par.plaintext)
                           % par.plaintext).astype(U64)
        delta = np.array([pow(-par.plaintext % q, -1, q) for q in m],
                         dtype=U64)[:, None]
        dm = ring.mulmod(np.broadcast_to(mm, (len(m), par.degree)), delta, p)
        c0 = submod(ring.forward(addmod(e, dm, p), m),
                    ring.mulmod(a, self.s_ntt(m), p), p)
        return c0, a, seed

    def skip_encryptions(self, count: int) -> None:
        """Move past `count` encryptions without working them out."""
        nb = 4 * self.par.variance
        self.stream.pos += count * (8 + 2 * -(-self.par.degree * nb // 64))

    def decrypt(self, c0: np.ndarray, c1: np.ndarray, level: int,
                ntt: bool = True) -> np.ndarray:
        """The plaintext polynomials (..., N) mod t of two-part
        ciphertexts ((..., k, N) residues each, in the NTT domain or the
        power basis): round(t (c0 + c1 s) / Q) mod t."""
        par = self.par
        m = par.level_moduli(level)
        p = col(m)
        s = self.s_ntt(m)
        if ntt:
            x = ring.backward(addmod(c0, ring.mulmod(c1, s, p), p), m)
        else:
            x = addmod(c0, ring.backward(
                ring.mulmod(ring.forward(c1, m), s, p), m), p)
        return ring.scale_round(x, m, par.plaintext)


def simd_encode(par: Params, values: np.ndarray) -> np.ndarray:
    """Slot values (N,) mod t -> the plaintext polynomial (N,)."""
    slots = np.zeros(par.degree, dtype=U64)
    slots[par.index_map()] = values
    return ring.backward(slots[None], [par.plaintext])[0]


def simd_decode(par: Params, poly: np.ndarray) -> np.ndarray:
    """Plaintext polynomials (..., N) -> their slot values (..., N)."""
    return ring.forward(poly[..., None, :].astype(U64),
                        [par.plaintext])[..., 0, :][..., par.index_map()]


# ---------------------------------------------------------------------------
# The wire format (fhe.rs's bfv.proto and rq.proto, proto3)
# ---------------------------------------------------------------------------


def _varint(buf: bytes, pos: int) -> tuple:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def proto_fields(buf: bytes) -> list:
    """(field, value) of a message of varint and length-delimited fields."""
    out, pos = [], 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        if key & 7 == 0:
            v, pos = _varint(buf, pos)
        elif key & 7 == 2:
            ln, pos = _varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"wire type {key & 7}")
        out.append((key >> 3, v))
    return out


def unpack_bits(data: bytes, nbits: int, count: int) -> np.ndarray:
    """`count` values of nbits bits each from a little-endian bit stream,
    zero past its end."""
    bits = np.zeros(count * nbits, dtype=np.uint8)
    raw = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    bits[: min(raw.size, bits.size)] = raw[: bits.size]
    bits = bits.reshape(count, nbits).astype(U64)
    return (bits << np.arange(nbits, dtype=U64)).sum(axis=1, dtype=U64)


def parse_ciphertext(par: Params, data: bytes) -> tuple:
    """(parts, level, seed) of a serialized ciphertext: each part (k, N)
    power-basis residues as its Rq message carries them."""
    fields = proto_fields(data)
    level = next((v for f, v in fields if f == 3), 0)
    seed = next((v for f, v in fields if f == 2), b"")
    m = par.level_moduli(level)
    parts = []
    for f, msg in fields:
        if f != 1:
            continue
        inner = dict(proto_fields(msg))
        if inner.get(2) != par.degree:
            raise ValueError("degree")
        payload, rows, at = inner.get(3, b""), [], 0
        for q in m:
            nb = (q - 1).bit_length()
            ln = nb * par.degree // 8
            rows.append(unpack_bits(payload[at:at + ln], nb, par.degree))
            at += ln
        if at != len(payload):
            raise ValueError("payload length")
        parts.append(np.stack(rows))
    return parts, level, bytes(seed)


def pir_row_values(par: Params, database: np.ndarray, row: int) -> np.ndarray:
    """The plaintext coefficients (N,) of database row `row`: its elements'
    bytes as a little-endian bit stream, bitlen(t) - 1 bits a value
    (examples/util.rs)."""
    count, size = database.shape
    nbits = par.plaintext.bit_length() - 1
    per = nbits * par.degree // (size * 8)
    chunk = np.zeros(per * size, dtype=np.uint8)
    flat = database[row * per: (row + 1) * per].reshape(-1)
    chunk[: flat.size] = flat
    vals = unpack_bits(chunk.tobytes(), nbits, -(-chunk.size * 8 // nbits))
    out = np.zeros(par.degree, dtype=U64)
    out[: vals.size] = vals
    return out
