"""Z_q modular arithmetic for moduli up to 62 bits.

Two halves:

- ``Modulus``: host-side constants and exact Python-int arithmetic, the
  counterpart of tpufhe/ops/zq.py's Modulus (fhe-math/src/zq/mod.rs:32-98):
  the 128-bit Barrett constant, Shoup precomputation, inverses and the
  reference-compatible uniform sampler.
- Elementwise ops on ``torch.int64`` tensors holding one residue per
  word: ``add``, ``sub``, ``neg``, ``mul`` and ``mul_shoup`` mod p. They are
  the glue around the CUDA kernels (encryption's e - a*s + m, the decryption
  phase, the key-switch digits, the expansion's switch-down) and the
  arithmetic of every kernel's plain version.

On CUDA tensors ``mul`` and ``mul_shoup`` launch the kernel zq_mul
(csrc/zq_mul.cu: one pass, 64 x 64 -> 128-bit products) and raise where it
cannot take the operands. On CPU tensors they run the kernel's plain
versions, ``mul_plain`` and ``mul_shoup_plain``: torch has no 128-bit
product and almost no uint64 arithmetic, so a product of two 62-bit
residues is formed from 31-bit digits whose partial products stay below
2^62 (``mul_columns``), and reduced by Barrett's method with
mu = floor(2^124 / p) or by Shoup's. Nothing relies on int64 wraparound:
every intermediate is a non-negative value below 2^63, except the signed
columns of ``normalize``, whose floor shifts are exact. Both routes return
the canonical residue, so their words are equal.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from tpufhe_torch import kernels
from tpufhe_torch.device import on_card
from tpufhe_torch.errors import InvalidModulus
from tpufhe_torch.utils.obs import count
from tpufhe_torch.utils.primes import is_prime, supports_opt
from tpufhe_torch.utils.rngs import uniform_u64_below
from tpufhe_torch.utils.transcode import transcode_from_bytes, transcode_to_bytes

DIGIT_BITS = 31
DIGIT_MASK = (1 << DIGIT_BITS) - 1
_M64 = (1 << 64) - 1


@dataclass(frozen=True)
class Modulus:
    """A modulus p < 2^62 with precomputed Barrett/Shoup constants.

    Mirrors fhe-math/src/zq/mod.rs:32-98 and tpufhe.ops.zq.Modulus.
    """

    p: int
    barrett_hi: int = field(init=False)
    barrett_lo: int = field(init=False)
    leading_zeros: int = field(init=False)
    supports_opt: bool = field(init=False)

    def __post_init__(self):
        p = int(self.p)
        if p < 2 or (p >> 62) != 0:
            raise InvalidModulus(p)
        barrett = (1 << 128) // p
        object.__setattr__(self, "p", p)
        object.__setattr__(self, "barrett_hi", barrett >> 64)
        object.__setattr__(self, "barrett_lo", barrett & _M64)
        object.__setattr__(self, "leading_zeros", 64 - p.bit_length())
        object.__setattr__(self, "supports_opt", supports_opt(p))

    # exact host scalar arithmetic on Python ints (tpufhe zq.py:82-122)

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def pow(self, a: int, n: int) -> int:
        return pow(a, n, self.p)

    def center(self, a: int) -> int:
        """a mod p in the centered range [-(p - 1) / 2, p / 2]."""
        a = int(a) % self.p
        return a - self.p if a >= (self.p + 1) // 2 else a

    def shoup(self, a: int) -> int:
        """floor(a * 2^64 / p), the Shoup precomputation (zq/mod.rs:195-199)."""
        assert 0 <= a < self.p
        return (a << 64) // self.p

    def shoup32(self, a: int) -> int:
        """floor(a * 2^32 / p), the single-word (w30) Shoup constant."""
        assert 0 <= a < self.p < (1 << 30)
        return (a << 32) // self.p

    @property
    def mu64(self) -> int:
        """floor(2^64 / p), the w30 Barrett constant (< 2^35 for p >= 2^29)."""
        return (1 << 64) // self.p

    def inv(self, a: int) -> int | None:
        if not is_prime(self.p) or a == 0:
            return None
        return pow(a, self.p - 2, self.p)

    def reduce(self, a: int) -> int:
        return int(a) % self.p

    def random_vec(self, size: int, rng) -> np.ndarray:
        """Uniform values in [0, p) with rand-0.9 Uniform semantics."""
        return uniform_u64_below(rng, self.p, size)

    # serialization helpers (zq/mod.rs:773-793)

    @property
    def nbits(self) -> int:
        """Bits a serialized residue takes: the bit length of p - 1."""
        return (self.p - 1).bit_length()

    def serialization_length(self, size: int) -> int:
        assert size % 8 == 0
        return self.nbits * size // 8

    def serialize_vec(self, a):
        """Residues packed nbits bits each (rows of a 2-D array each)."""
        return transcode_to_bytes(a, self.nbits)

    def deserialize_vec(self, b) -> np.ndarray:
        return transcode_from_bytes(b, self.nbits)


def shoup_array(values: np.ndarray, moduli) -> np.ndarray:
    """Shoup constants floor(v * 2^64 / p) of canonical residues.

    values: (..., k, N) residues, moduli: the k moduli. Returns uint64 (the
    constants use all 64 bits; callers store them in int64 by bit pattern).
    """
    values = np.asarray(values, dtype=np.uint64)
    out = np.empty(values.shape, dtype=np.uint64)
    for j, p in enumerate(moduli):
        src = values[..., j, :]
        flat = [(int(v) << 64) // int(p) for v in src.reshape(-1)]
        out[..., j, :] = np.array(flat, dtype=np.uint64).reshape(src.shape)
    return out


def as_int64(values: np.ndarray) -> np.ndarray:
    """uint64 words -> int64 with the same bit pattern."""
    return np.ascontiguousarray(np.asarray(values, dtype=np.uint64)).view(np.int64)


# ---------------------------------------------------------------------------
# 31-bit digit arithmetic on int64 tensors
# ---------------------------------------------------------------------------


def to_digits(x, n: int) -> list:
    """Digits of an int64 tensor read as an unsigned 64-bit word.

    Digit i holds bits [31 i, 31 i + 31); the top digit is masked to the
    bits the word has, so a negative bit pattern (a word >= 2^63) yields
    its unsigned digits.
    """
    out = []
    for i in range(n):
        width = min(DIGIT_BITS, 64 - DIGIT_BITS * i)
        out.append((x >> (DIGIT_BITS * i)) & ((1 << width) - 1))
    return out


def int_digits(x: int, n: int) -> list:
    """Digits of a non-negative Python int."""
    return [(int(x) >> (DIGIT_BITS * i)) & DIGIT_MASK for i in range(n)]


def normalize(cols: list, n: int | None = None) -> list:
    """Carry-propagate columns into n digits in [0, 2^31).

    Columns may be negative; the floor shift makes the result the two's
    complement of the value modulo 2^(31 n). The final carry is dropped.
    """
    n = len(cols) if n is None else n
    out = []
    carry = 0
    for i in range(n):
        v = carry + (cols[i] if i < len(cols) else 0)
        out.append(v & DIGIT_MASK)
        carry = v >> DIGIT_BITS
    return out


def mul_columns(a: list, b: list, cols: list | None = None, sign: int = 1) -> list:
    """Add sign * (a * b) into 31-bit columns, schoolbook.

    Each partial product (< 2^62) is split into its low and high 31 bits
    before it enters a column, so a column stays far below 2^63 for any
    digit count used here.
    """
    if cols is None:
        cols = [0] * (len(a) + len(b) + 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            prod = ai * bj
            lo = prod & DIGIT_MASK
            hi = prod >> DIGIT_BITS
            if sign > 0:
                cols[i + j] = cols[i + j] + lo
                cols[i + j + 1] = cols[i + j + 1] + hi
            else:
                cols[i + j] = cols[i + j] - lo
                cols[i + j + 1] = cols[i + j + 1] - hi
    return cols


def bits_of(digits: list, start: int, width: int):
    """Bits [start, start + width) of a digit number as an int64 (width <= 63)."""
    assert width <= 63
    out = 0
    got = 0
    while got < width:
        pos = start + got
        d, off = divmod(pos, DIGIT_BITS)
        take = min(DIGIT_BITS - off, width - got)
        if d < len(digits):
            piece = (digits[d] >> off) & ((1 << take) - 1)
            out = out + (piece << got)
        got += take
    return out


class ModTable:
    """Per-modulus constants of the plain ops, shaped to broadcast.

    `p` has shape `shape` (e.g. (k, 1) against (..., k, N) data); the
    Barrett constant mu = floor(2^124 / p) is held as four 31-bit digits.
    """

    def __init__(self, moduli, device, shape=None):
        self.moduli = tuple(int(m) for m in moduli)
        self.device = torch.device(device)
        self.shape = (len(self.moduli), 1) if shape is None else tuple(shape)
        col = self._col
        self.p = col(list(self.moduli))
        self.p_digits = [col([d[i] for d in
                              (int_digits(m, 2) for m in self.moduli)])
                         for i in range(2)]
        mus = [int_digits((1 << 124) // m, 4) for m in self.moduli]
        self.mu_digits = [col([d[i] for d in mus]) for i in range(4)]

    def _col(self, vals):
        return torch.tensor(vals, dtype=torch.int64,
                            device=self.device).reshape(self.shape)

    @functools.cached_property
    def barrett(self) -> tuple:
        """(lo, hi) of floor(2^128 / p), int64 by bit pattern and shaped as
        ``p``: zq_mul's Barrett constants (made on first use)."""
        b = [(1 << 128) // m for m in self.moduli]
        return tuple(self._col(as_int64(np.array(
            [(v >> s) & _M64 for v in b], np.uint64)).tolist())
            for s in (0, 64))

    def view(self, shape) -> "ModTable":
        """The same constants reshaped (e.g. (k, 1, 1) for staged NTT views)."""
        return ModTable(self.moduli, self.device, shape)

    def __getitem__(self, sl: slice) -> "ModTable":
        return ModTable(self.moduli[sl], self.device,
                        (len(self.moduli[sl]),) + self.shape[1:])


def add(a, b, m: ModTable):
    """(a + b) mod p for a, b < p."""
    count("glue.zq.add")
    s = a + b
    return torch.where(s >= m.p, s - m.p, s)


def sub(a, b, m: ModTable):
    """(a - b) mod p for a, b < p."""
    count("glue.zq.sub")
    d = a - b
    return torch.where(d < 0, d + m.p, d)


def neg(a, m: ModTable):
    """(-a) mod p for a < p."""
    count("glue.zq.neg")
    return torch.where(a == 0, a, m.p - a)


def _barrett_digits(prod: list, m: ModTable):
    """Reduce a product given as four 31-bit digits (value < p^2 < 2^124).

    q = floor(prod * mu / 2^124) with mu = floor(2^124 / p) is the true
    quotient or one less, so r = prod - q p lies in [0, 2p) and one
    conditional subtraction finishes.
    """
    qcols = mul_columns(prod[:4], m.mu_digits)
    qd = normalize(qcols, 6)[4:6]  # q < 2^62: digits 4 and 5
    qp = normalize(mul_columns(qd, m.p_digits), 3)
    r = normalize([prod[i] - qp[i] for i in range(3)], 3)
    r = r[0] + (r[1] << DIGIT_BITS) + (r[2] << (2 * DIGIT_BITS))
    return torch.where(r >= m.p, r - m.p, r)


def mul(a, b, m: ModTable):
    """(a * b) mod p for canonical a, b < p < 2^62: zq_mul on CUDA tensors,
    else the digit chain."""
    count("glue.zq.mul")
    if on_card(a) or on_card(b):
        return mul_cuda(a, b, None, m)
    return mul_plain(a, b, m)


def mul_plain(a, b, m: ModTable):
    """zq_mul's plain version in Barrett's mode: the product formed from
    31-bit digits and reduced with mu = floor(2^124 / p)."""
    prod = normalize(mul_columns(to_digits(a, 2), to_digits(b, 2)), 4)
    return _barrett_digits(prod, m)


def reduce_u64(x, m: ModTable):
    """int64 words read as unsigned 64-bit values (a lazy word of a 62-bit
    p may read as negative), reduced mod p."""
    count("glue.zq.reduce_u64")
    r = torch.remainder(x, m.p)
    two64 = torch.tensor([(1 << 64) % p for p in m.moduli],
                         dtype=torch.int64, device=m.p.device
                         ).reshape(m.p.shape)
    return torch.where(x < 0, torch.remainder(r + two64, m.p), r)


def mul_shoup(a, b, b_shoup, m: ModTable):
    """a * b mod p by Shoup's method (zq/mod.rs:224-234), fully reduced:
    zq_mul on CUDA tensors, else the digit chain. b < p and
    b_shoup = floor(b 2^64 / p) stored by bit pattern in int64; a is any
    value below 2^63."""
    count("glue.zq.mul_shoup")
    if on_card(a) or on_card(b):
        return mul_cuda(a, b, b_shoup, m)
    return mul_shoup_plain(a, b, b_shoup, m)


def mul_shoup_plain(a, b, b_shoup, m: ModTable):
    """zq_mul's plain version in Shoup's mode: q = floor(a b_shoup / 2^64)
    formed exactly from digits, then r = a b - q p (in [0, 2p)) from the
    low three digits."""
    ad = to_digits(a, 3)
    q = bits_of(normalize(mul_columns(ad, to_digits(b_shoup, 3)), 6), 64, 63)
    ab = normalize(mul_columns(ad, to_digits(b, 2)), 3)
    qp = normalize(mul_columns(to_digits(q, 3), m.p_digits), 3)
    r = normalize([ab[i] - qp[i] for i in range(3)], 3)
    r = r[0] + (r[1] << DIGIT_BITS) + (r[2] << (2 * DIGIT_BITS))
    return torch.where(r >= m.p, r - m.p, r)


# zq_mul's C entry point's argument types (csrc/zq_mul.cu tpufhe_zq_mul)
_ZQ_MUL_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p] + [ctypes.c_void_p] * 8


def _broadcast(shapes) -> tuple:
    """torch's broadcast of the shapes (torch.broadcast_shapes costs tens
    of microseconds a call, a launch's whole host time)."""
    n = max(len(s) for s in shapes)
    out = [1] * n
    for s in shapes:
        for i, d in enumerate(s, n - len(s)):
            if d != 1 and out[i] != d:
                if out[i] != 1:
                    raise ValueError(f"zq_mul: shapes {shapes} do not "
                                     f"broadcast")
                out[i] = d
    return tuple(out)


def _strides(t, dims: int) -> list:
    """t's element strides as a view of a `dims`-dimensional broadcast
    shape: 0 along each dimension t has not or holds once."""
    return [0] * (dims - t.dim()) + [0 if d == 1 else s for d, s in
                                     zip(t.shape, t.stride())]


def zq_mul_args(a, b, b_shoup, m: ModTable) -> tuple:
    """(out, args): a new contiguous int64 tensor of the operands'
    broadcast shape, and the arguments that tpufhe_zq_mul and
    tpufhe_zq_mul_plan take before their last (the stream, or the plan):
    the mode, the shape, the strides of a, b, b_shoup and the moduli as
    views of that shape (0 where broadcast), and the pointers."""
    ops = (a, b) if b_shoup is None else (a, b, b_shoup)
    shape = _broadcast([t.shape for t in ops] + [m.p.shape])
    out = torch.empty(shape, dtype=torch.int64, device=m.p.device)
    dims = len(shape)
    # p, lo and hi are made alike (ModTable._col), so they share p's strides
    strides = [s for t in (a, b, b_shoup, m.p)
               for s in ([0] * dims if t is None else _strides(t, dims))]
    if b_shoup is None:
        lo, hi = m.barrett
        consts = (None, m.p.data_ptr(), lo.data_ptr(), hi.data_ptr())
    else:
        consts = (b_shoup.data_ptr(), m.p.data_ptr(), None, None)
    return out, (int(b_shoup is not None), dims,
                 (ctypes.c_longlong * max(dims, 1))(*shape),
                 (ctypes.c_longlong * max(4 * dims, 1))(*strides),
                 a.data_ptr(), b.data_ptr(), *consts, out.data_ptr())


def mul_cuda(a, b, b_shoup, m: ModTable):
    """Launch zq_mul on int64 CUDA tensors: a b mod p by Shoup's method
    where b_shoup is given, else by Barrett's. a, b, b_shoup and m's
    constants broadcast against each other as torch broadcasts them; each
    is passed as a strided view of the result's shape (stride 0 where it
    is broadcast). Returns a new contiguous tensor of that shape."""
    ops = (a, b) if b_shoup is None else (a, b, b_shoup)
    kernels.require_cuda("zq_mul", torch.int64, *ops, m.p, contiguous=False)
    out, args = zq_mul_args(a, b, b_shoup, m)
    words = out.numel()
    if words == 0:
        return out
    if words >= 1 << 31:
        raise ValueError(f"zq_mul: {words} words, at most 2^31 - 1 a launch")
    kernels.launch("zq_mul", "tpufhe_zq_mul", _ZQ_MUL_ARGS, *args)
    return out


def mod_of_digits(digits: list, m: ModTable):
    """(sum_i digits[i] 2^(31 i)) mod p, by Horner's rule from the top."""
    count("glue.zq.mod_of_digits")
    two31 = torch.remainder(
        torch.full_like(m.p, 1 << DIGIT_BITS), m.p)
    r = torch.remainder(digits[-1], m.p)
    for d in reversed(digits[:-1]):
        r = torch.remainder(mul(r, two31, m) + d, m.p)
    return r
