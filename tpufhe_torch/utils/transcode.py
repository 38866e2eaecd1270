"""Bit-width transcoding of integer vectors (a wire-format building block).

The port's copy of tpufhe/utils/transcode.py (fhe-util/src/lib.rs:60-176):
values are packed little-endian, `nbits` bits each, into bytes or into
values of another width. tpufhe moves one value at a time in Python; here
the packing is vectorized with numpy over 64-bit words: value i occupies
bits [i nbits, (i + 1) nbits) of the stream, so it lands in word
(i nbits) >> 6 at offset (i nbits) & 63 and spills into the next word
when it crosses a word boundary. The outputs, and the AssertionError on a
value wider than `nbits`, are tpufhe's.

Every function also takes arrays with leading dimensions and transcodes
along the last axis, each row on its own (the PIR database's rows, the
parts of SealPIR's folded ciphertexts).
"""

from __future__ import annotations

import numpy as np

_U64 = np.uint64


def _values(a, nbits: int) -> np.ndarray:
    """`a` as uint64, raising AssertionError where a value is wider than
    nbits bits (tpufhe's assert on bit_length)."""
    if isinstance(a, np.ndarray) and a.dtype.kind in "ui":
        if a.dtype.kind == "i" and a.size and int(a.min()) < 0:
            raise AssertionError("negative value")
        arr = a.astype(_U64, copy=False)
    else:
        values = a if isinstance(a, np.ndarray) else [int(x) for x in a]
        try:
            arr = np.asarray(values, dtype=_U64)
        except OverflowError as e:
            raise AssertionError(f"value wider than {nbits} bits") from e
    if nbits < 64 and arr.size and bool((arr >> _U64(nbits)).any()):
        raise AssertionError(f"value wider than {nbits} bits")
    return arr


def _pack(arr: np.ndarray, nbits: int) -> np.ndarray:
    """(..., n) uint64 values of nbits bits each -> (..., ceil(n nbits / 64)
    + 1) uint64 words of their little-endian bit stream."""
    n = arr.shape[-1]
    words = np.zeros(arr.shape[:-1] + ((n * nbits + 63) // 64 + 1,), _U64)
    if n == 0:
        return words
    b = np.arange(n, dtype=np.int64) * nbits
    w = b >> 6
    o = (b & 63).astype(_U64)
    lo = arr << o
    hi = np.where(o > 0, arr >> ((_U64(64) - o) & _U64(63)), _U64(0))
    # w is nondecreasing: OR each run of equal words at once
    starts = np.flatnonzero(np.diff(w, prepend=-1))
    uw = w[starts]
    words[..., uw] = np.bitwise_or.reduceat(lo, starts, axis=-1)
    words[..., uw + 1] |= np.bitwise_or.reduceat(hi, starts, axis=-1)
    return words


def _unpack(words: np.ndarray, nbits: int, count: int) -> np.ndarray:
    """The first `count` nbits-bit values of the bit stream in (..., nw)
    uint64 words, as (..., count) uint64 (bits past the words read 0)."""
    need = (count * nbits) // 64 + 2
    if words.shape[-1] < need:
        pad = np.zeros(words.shape[:-1] + (need - words.shape[-1],), _U64)
        words = np.concatenate([words, pad], axis=-1)
    b = np.arange(count, dtype=np.int64) * nbits
    w = b >> 6
    o = (b & 63).astype(_U64)
    lo = words[..., w] >> o
    hi = np.where(o > 0, words[..., w + 1] << ((_U64(64) - o) & _U64(63)),
                  _U64(0))
    mask = _U64((1 << nbits) - 1)
    # the ufuncs keep the gathers' memory order, which need not be C's
    return np.ascontiguousarray((lo | hi) & mask)


def transcode_to_bytes(a, nbits: int) -> bytes:
    """Pack each value of `a` into nbits little-endian bits. A 1-D input
    gives bytes; an array with leading dimensions gives a uint8 array of
    the packed rows."""
    assert 0 < nbits <= 64
    arr = _values(a, nbits)
    n = arr.shape[-1]
    nbytes = -((-n * nbits) // 8)
    words = _pack(arr, nbits).astype("<u8", copy=False)
    if arr.ndim == 1:
        return words.tobytes()[:nbytes]
    return words.view(np.uint8)[..., :nbytes]


def transcode_from_bytes(b, nbits: int) -> np.ndarray:
    """Unpack bytes (or a uint8 array, along its last axis) into nbits-wide
    values, ceil(8 len / nbits) of them (uint64)."""
    assert 0 < nbits <= 64
    buf = np.frombuffer(bytes(b), np.uint8) if not isinstance(b, np.ndarray) \
        else np.ascontiguousarray(b, dtype=np.uint8)
    nb = buf.shape[-1]
    nelements = -((-nb * 8) // nbits)
    pad = np.zeros(buf.shape[:-1] + ((-nb) % 8 + 8,), np.uint8)
    words = np.concatenate([buf, pad], axis=-1).view("<u8").astype(_U64)
    return _unpack(words, nbits, nelements)


def transcode_bidirectional(a, input_nbits: int, output_nbits: int
                            ) -> np.ndarray:
    """Repack input_nbits-wide values into output_nbits-wide values,
    ceil(len input_nbits / output_nbits) of them (uint64)."""
    assert 0 < input_nbits <= 64 and 0 < output_nbits <= 64
    arr = _values(a, input_nbits)
    count = -((-arr.shape[-1] * input_nbits) // output_nbits)
    return _unpack(_pack(arr, input_nbits), output_nbits, count)
