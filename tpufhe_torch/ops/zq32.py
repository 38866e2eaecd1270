"""Z_q arithmetic for narrow moduli p < 2^30 on int32 residue tensors: the
port's copy of tpufhe/ops/zq32.py, the arithmetic of the w30 mode.

A narrow residue fits one 32-bit word, so a narrow context keeps its rows
as int32 tensors (..., k, N), half the bytes of the wide int64 words. These
functions are the glue of the narrow path (the tensor product, the
key-switch digits and accumulate, the adds of encryption and decryption)
on any device, and the arithmetic of the narrow plain versions.

- Sums of two residues stay below 2^31 and are formed in int32.
- Every product is formed in int64: two residues give less than 2^60, a
  residue times a Shoup constant (below 2^32, held as an int32 bit pattern
  and widened with ``& 0xFFFFFFFF``) less than 2^62.

``p`` is an int32 tensor of moduli shaped to broadcast against the data,
such as a context's (k, 1) ``p_col``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufhe_torch.utils.obs import count

_M32 = 0xFFFFFFFF


def add(a, b, p):
    """(a + b) mod p for a, b < p."""
    count("glue.zq32.add")
    s = a + b
    return torch.where(s >= p, s - p, s)


def sub(a, b, p):
    """(a - b) mod p for a, b < p."""
    count("glue.zq32.sub")
    d = a - b
    return torch.where(d < 0, d + p, d)


def neg(a, p):
    """(-a) mod p for a < p."""
    count("glue.zq32.neg")
    return torch.where(a == 0, a, p - a)


def mul(a, b, p):
    """(a * b) mod p for a, b < p, exact in int64."""
    count("glue.zq32.mul")
    return torch.remainder(a.long() * b.long(), p.long()).int()


def mul_shoup(a, b, b_shoup, p):
    """a * b mod p by Shoup's method with a 2^32-scaled constant, fully
    reduced: b < p, b_shoup = floor(b 2^32 / p) by bit pattern, a < 2^30.
    q = floor(a b_shoup / 2^32) is the quotient or one less, so
    a b - q p lies in [0, 2p)."""
    count("glue.zq32.mul_shoup")
    a64 = a.long()
    q = (a64 * (b_shoup.long() & _M32)) >> 32
    r = a64 * b.long() - q * p.long()
    return torch.where(r >= p, r - p, r).int()


def shoup_array(values: np.ndarray, moduli) -> np.ndarray:
    """floor(v * 2^32 / p) of canonical (..., k, N) residues, as int32 words
    with the bit pattern of the uint32 constant."""
    values = np.asarray(values).astype(np.uint64)
    out = np.empty(values.shape, dtype=np.uint64)
    for j, p in enumerate(moduli):
        out[..., j, :] = (values[..., j, :] << np.uint64(32)) // np.uint64(p)
    return out.astype(np.uint32).view(np.int32)
