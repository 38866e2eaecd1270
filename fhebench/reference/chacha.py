"""The randomness of fhe.rs, written again in NumPy: the ChaCha8 word
stream of rand_chacha 0.9, rand_core's seed_from_u64, the centered
binomial sampler of fhe-util and rand 0.9's uniform and range draws.

A stream is addressed by word: ``Stream.take(n)`` returns the next n
32-bit words and computes only the blocks that hold them, so a draw that
has to give back words (a rejection sampler that drew too many) moves the
position back.
"""

from __future__ import annotations

import hashlib

import numpy as np

MASK64 = (1 << 64) - 1
_CONST = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574],
                  dtype=np.uint32)


def _rotl(x: np.ndarray, k: int) -> np.ndarray:
    return (x << np.uint32(k)) | (x >> np.uint32(32 - k))


def chacha_blocks(key: np.ndarray, first: int, count: int,
                  double_rounds: int = 4) -> np.ndarray:
    """Blocks first .. first + count - 1 of the ChaCha stream with the
    eight-word key and stream id 0, as (count * 16,) uint32 words."""
    ctr = np.arange(first, first + count, dtype=np.uint64)
    state = np.empty((16, count), dtype=np.uint32)
    state[:4] = _CONST[:, None]
    state[4:12] = key[:, None]
    state[12] = (ctr & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    state[13] = (ctr >> np.uint64(32)).astype(np.uint32)
    state[14:] = 0
    x = state.copy()

    def qr(a, b, c, d):
        x[a] += x[b]
        x[d] = _rotl(x[d] ^ x[a], 16)
        x[c] += x[d]
        x[b] = _rotl(x[b] ^ x[c], 12)
        x[a] += x[b]
        x[d] = _rotl(x[d] ^ x[a], 8)
        x[c] += x[d]
        x[b] = _rotl(x[b] ^ x[c], 7)

    for _ in range(double_rounds):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return (x + state).T.reshape(-1)


class Stream:
    """A ChaCha8 word stream from a 32-byte seed."""

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("a ChaCha seed is 32 bytes")
        self.key = np.frombuffer(seed, dtype="<u4").astype(np.uint32)
        self.pos = 0

    def take(self, n: int) -> np.ndarray:
        """The next n words."""
        if n == 0:
            return np.zeros(0, dtype=np.uint32)
        b0, b1 = self.pos // 16, (self.pos + n - 1) // 16
        words = chacha_blocks(self.key, b0, b1 - b0 + 1)
        out = words[self.pos - 16 * b0: self.pos - 16 * b0 + n]
        self.pos += n
        return out

    def u64(self, n: int) -> np.ndarray:
        """The next n u64 draws, each two words, low first."""
        w = self.take(2 * n).astype(np.uint64)
        return w[0::2] | (w[1::2] << np.uint64(32))

    def bytes(self, n: int) -> bytes:
        """fill_bytes(n) for n a multiple of 4 (whole words)."""
        if n % 4:
            raise ValueError("only whole words are drawn here")
        return self.take(n // 4).astype("<u4").tobytes()


def seed_from_u64(state: int) -> bytes:
    """rand_core 0.9's SeedableRng::seed_from_u64 (PCG32 expansion)."""
    mul, inc = 6364136223846793005, 11634580027462260723
    state &= MASK64
    out = bytearray()
    for _ in range(8):
        state = (state * mul + inc) & MASK64
        xs = (((state >> 18) ^ state) >> 27) & 0xFFFFFFFF
        rot = state >> 59
        out += (((xs >> rot) | (xs << ((32 - rot) & 31))) & 0xFFFFFFFF
                ).to_bytes(4, "little")
    return bytes(out)


def expand_seed(seed: bytes) -> Stream:
    """ChaCha8(SHA-256(seed)): fhe.rs's Poly::random_from_seed stream."""
    return Stream(hashlib.sha256(seed).digest())


def cbd(stream: Stream, n: int, variance: int) -> np.ndarray:
    """n centered-binomial values (fhe-util sample_vec_cbd): value i takes
    bits [4 v i, 4 v (i + 1)) of the little-endian stream of u64 draws,
    the popcount of its low 2v bits minus that of its high 2v bits."""
    nb = 4 * variance
    words = stream.u64(-(-n * nb // 64))
    bits = np.unpackbits(words.astype("<u8").view(np.uint8),
                         bitorder="little")[: n * nb].reshape(n, nb)
    half = 2 * variance
    return (bits[:, :half].sum(axis=1, dtype=np.int64)
            - bits[:, half:].sum(axis=1, dtype=np.int64))


def uniform_below(stream: Stream, bound: int, n: int) -> np.ndarray:
    """n values uniform in [0, bound) by rand 0.9's widening multiply with
    rejection, as Python ints in an object array."""
    thresh = ((1 << 64) - bound) % bound
    out = []
    got = 0
    while got < n:
        want = n - got
        draw = want + want // 4 + 16
        start = stream.pos
        prod = stream.u64(draw).astype(object) * bound
        ok = np.flatnonzero((prod & MASK64) >= thresh)
        if len(ok) > want:
            ok = ok[:want]
            stream.pos = start + 2 * (int(ok[-1]) + 1)
        out.append(prod[ok] >> 64)
        got += len(ok)
    return np.concatenate(out)


def random_range(stream: Stream, bound: int) -> int:
    """rand 0.9's Rng::random_range(0..bound) for u64 (Canon's method)."""
    prod = int(stream.u64(1)[0]) * bound
    result, lo = prod >> 64, prod & MASK64
    if lo > ((1 << 64) - bound) % (1 << 64):
        hi2 = (int(stream.u64(1)[0]) * bound) >> 64
        result += 1 if lo + hi2 > MASK64 else 0
    return result
