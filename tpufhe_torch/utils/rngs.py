"""Deterministic randomness compatible with the reference's PRNG stack.

A copy of tpufhe/utils/rngs.py, so the streams are byte-identical to
tpufhe's. Bulk draws (``fill_bytes`` past the current block,
``uniform_u64_below``) go through the native sampler of
``tpufhe_torch.native`` when it is built, else through the same stream in
pure Python:

- ``ChaCha8Rng``: the ChaCha stream cipher with 8 double-rounds, word-level
  output order and 64-byte blocks as in rand_chacha 0.9.
- ``seed_from_u64``: rand_core 0.9's default SeedableRng::seed_from_u64
  (PCG32-based seed expansion).
- ``uniform_u64_below``: rand 0.9's UniformInt<u64> sample (Lemire
  widening-multiply rejection), used by Modulus.random_vec.
- ``random_range_u64``: rand 0.9's Rng::random_range (Canon's method), used
  by the NTT primitive-root search.

Everything is host-side Python: sampling happens at key and ciphertext
generation time, never on the device path.
"""

from __future__ import annotations

import ctypes
import hashlib

import numpy as np

from tpufhe_torch import native

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF


def _rotl32(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _MASK32


def _chacha_block(key_words, counter: int, nonce_words, rounds: int) -> bytes:
    """One ChaCha block (64 bytes). counter is 64-bit (words 12, 13)."""
    state = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *key_words,
        counter & _MASK32, (counter >> 32) & _MASK32,
        *nonce_words,
    ]
    x = list(state)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & _MASK32
        x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & _MASK32
        x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & _MASK32
        x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & _MASK32
        x[b] = _rotl32(x[b] ^ x[c], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)

    out = bytearray()
    for i in range(16):
        out += ((x[i] + state[i]) & _MASK32).to_bytes(4, "little")
    return bytes(out)


class ChaChaRng:
    """rand_chacha-compatible ChaCha RNG (word stream over 64-byte blocks)."""

    def __init__(self, seed: bytes, rounds: int = 8, stream: int = 0):
        assert len(seed) == 32
        self._key = [
            int.from_bytes(seed[4 * i : 4 * i + 4], "little") for i in range(8)
        ]
        self._nonce = [stream & _MASK32, (stream >> 32) & _MASK32]
        self._rounds = rounds
        self._counter = 0
        self._buf = b""
        self._pos = 0

    def _refill(self):
        self._buf = _chacha_block(self._key, self._counter, self._nonce, self._rounds)
        self._counter += 1
        self._pos = 0

    def next_u32(self) -> int:
        if self._pos + 4 > len(self._buf):
            self._refill()
        v = int.from_bytes(self._buf[self._pos : self._pos + 4], "little")
        self._pos += 4
        return v

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def fill_bytes(self, n: int) -> bytes:
        # rand_core fills from the u32 word stream; whole words are consumed.
        lib = native.lib()
        if lib is not None:
            # drain the current block exactly as the pure path does, then
            # generate whole blocks natively and one tail block
            out = bytearray()
            while len(out) < n and self._pos < len(self._buf):
                take = min(n - len(out), len(self._buf) - self._pos)
                out += self._buf[self._pos : self._pos + take]
                self._pos += take
                if len(out) < n and self._pos % 4 != 0:
                    self._pos += 4 - (self._pos % 4)
            nfull = (n - len(out)) // 64
            if nfull:
                buf = ctypes.create_string_buffer(64 * nfull)
                lib.chacha_blocks(self._key_arr(), self._counter,
                                  self._stream_u64(), self._rounds, nfull, buf)
                self._counter += nfull
                out += buf.raw
            if len(out) < n:
                self._refill()
                rem = n - len(out)
                out += self._buf[:rem]
                self._pos = rem
            return bytes(out)
        out = bytearray()
        while len(out) < n:
            if self._pos >= len(self._buf):
                self._refill()
            take = min(n - len(out), len(self._buf) - self._pos)
            out += self._buf[self._pos : self._pos + take]
            self._pos += take
            # Align to word boundary like rand_core's fill_via_u32_chunks
            if len(out) < n and self._pos % 4 != 0:
                self._pos += 4 - (self._pos % 4)
        return bytes(out)

    # -- the native stream-state protocol (native/tpufhe_native.cpp) --

    def _key_arr(self):
        if not hasattr(self, "_key_c"):
            self._key_c = (ctypes.c_uint32 * 8)(*self._key)
        return self._key_c

    def _stream_u64(self) -> int:
        return self._nonce[0] | (self._nonce[1] << 32)

    def _native_state(self):
        """(next_block_counter, wordpos 0..16) or None if mid-word."""
        if self._pos % 4 != 0:
            return None
        if self._buf and self._pos < len(self._buf):
            return self._counter, self._pos // 4
        return self._counter, 16

    def _adopt_native_state(self, counter: int, wordpos: int, lib):
        self._counter = int(counter)
        if wordpos < 16:
            buf = ctypes.create_string_buffer(64)
            lib.chacha_blocks(self._key_arr(), self._counter - 1,
                              self._stream_u64(), self._rounds, 1, buf)
            self._buf = buf.raw
            self._pos = wordpos * 4
        else:
            self._buf = b""
            self._pos = 0


def ChaCha8Rng(seed: bytes) -> ChaChaRng:
    """ChaCha with 8 rounds, as used throughout the reference."""
    return ChaChaRng(seed, rounds=8)


def seed_from_u64(state: int) -> bytes:
    """rand_core 0.9 default SeedableRng::seed_from_u64: PCG32 expansion."""
    MUL = 6364136223846793005
    INC = 11634580027462260723
    state = int(state) & _MASK64
    seed = bytearray()
    for _ in range(8):
        state = (state * MUL + INC) & _MASK64
        xorshifted = (((state >> 18) ^ state) >> 27) & _MASK32
        rot = state >> 59
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & _MASK32
        seed += x.to_bytes(4, "little")
    return bytes(seed)


def uniform_u64_below(rng, bound: int, size: int) -> np.ndarray:
    """Sample `size` u64 values uniform in [0, bound).

    rand 0.9 UniformInt::sample (distribution path): widening multiply with
    rejection when the low word falls below the precomputed threshold.
    """
    bound = int(bound)
    assert 0 < bound
    lib = native.lib()
    if lib is not None and isinstance(rng, ChaChaRng):
        st = rng._native_state()
        if st is not None:
            counter = ctypes.c_uint64(st[0])
            wp = ctypes.c_uint32(st[1])
            out = np.empty(size, dtype=np.uint64)
            lib.chacha_uniform_u64(
                rng._key_arr(), rng._stream_u64(), rng._rounds,
                ctypes.byref(counter), ctypes.byref(wp), bound, size,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            )
            rng._adopt_native_state(counter.value, wp.value, lib)
            return out
    thresh = ((1 << 64) - bound) % bound
    out = np.empty(size, dtype=np.uint64)
    for i in range(size):
        while True:
            v = rng.next_u64()
            prod = v * bound
            hi, lo = prod >> 64, prod & _MASK64
            if lo >= thresh:
                out[i] = hi
                break
    return out


def random_range_u64(rng, bound: int) -> int:
    """rand 0.9 Rng::random_range(0..bound) for u64: single-sample Canon's
    method (one widening multiply, one conditional correction sample)."""
    bound = int(bound)
    assert bound > 0
    v = rng.next_u64()
    prod = v * bound
    result, lo_order = prod >> 64, prod & _MASK64
    if lo_order > ((1 << 64) - bound) % (1 << 64):
        new_hi_order = (rng.next_u64() * bound) >> 64
        is_overflow = (lo_order + new_hi_order) > _MASK64
        result += 1 if is_overflow else 0
    return result


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def expand_seed(seed: bytes) -> ChaChaRng:
    """SHA-256(seed) -> ChaCha8Rng, the deterministic polynomial expansion
    used by Poly::random_from_seed (rq/mod.rs:241-257)."""
    return ChaCha8Rng(sha256(seed))
