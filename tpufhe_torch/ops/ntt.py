"""Negacyclic NTT: host tables, the plain torch transform, and kernel K1.

- ``NttOperator.new`` builds the same tables as tpufhe.ops.ntt (fhe.rs
  ntt/native.rs): the seeded-ChaCha8 primitive-root search, bit-reversed
  ``omegas`` / ``zetas_inv`` with Shoup constants, and n^{-1}.
- ``forward_plain`` / ``backward_plain`` run the same stages over int64
  tensors with canonical values at every stage (exact ``zq.mul``), so
  their outputs equal tpufhe's transforms word for word.
- ``ntt_transform`` is the wrapper of kernel K1 (csrc/ntt.cu): it launches
  the kernel for CUDA tensors and takes the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from tpufhe_torch import kernels
from tpufhe_torch.ops import zq
from tpufhe_torch.ops.zq import ModTable, Modulus
from tpufhe_torch.utils.primes import is_prime
from tpufhe_torch.utils.rngs import ChaChaRng, random_range_u64, seed_from_u64


def supports_ntt(p: int, n: int) -> bool:
    """p prime, p == 1 mod 2n, n >= 8 power of two (ntt/mod.rs:19-23)."""
    if n < 8 or (n & (n - 1)) != 0:
        return False
    return p % (2 * n) == 1 and is_prime(p)


def bitrev_indices(n: int) -> np.ndarray:
    """Bit-reversal permutation of 0..n-1."""
    nbits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for b in range(nbits):
        out |= ((idx >> b) & 1) << (nbits - 1 - b)
    return out


def primitive_root(n: int, q: Modulus) -> int:
    """2n-th primitive root of unity modulo q.p, by the reference's seeded
    search (native.rs:320-336): ChaCha8Rng::seed_from_u64(0), candidates
    from random_range(0..p) raised to (p-1)/2n."""
    p = q.p
    lam = (p - 1) // (2 * n)
    rng = ChaChaRng(seed_from_u64(0), rounds=8)
    for _ in range(100):
        root = pow(random_range_u64(rng, p), lam, p)
        if is_primitive_root(root, 2 * n, p):
            return root
    raise RuntimeError("Couldn't find primitive root")


def is_primitive_root(a: int, n: int, p: int) -> bool:
    """x^n == 1 and x^(n/2) != 1 (native.rs:341-348; n a power of two)."""
    return pow(a, n, p) == 1 and pow(a, n // 2, p) != 1


@dataclass(frozen=True)
class NttOperator:
    """NTT tables for one (modulus, size) pair, host-side uint64."""

    q: Modulus
    size: int
    omegas: np.ndarray  # (n,) bit-reversed forward twiddles
    omegas_shoup: np.ndarray
    zetas_inv: np.ndarray  # (n,) bit-reversed inverse twiddles
    zetas_inv_shoup: np.ndarray
    size_inv: int
    size_inv_shoup: int

    @staticmethod
    def new(q: Modulus, size: int) -> "NttOperator | None":
        return _new_operator(q.p, size)


@lru_cache(maxsize=None)
def _new_operator(p: int, size: int) -> NttOperator | None:
    q = Modulus(p)
    if not supports_ntt(p, size):
        return None
    size_inv = q.inv(size)
    if size_inv is None:
        return None
    omega = primitive_root(size, q)
    omega_inv = q.inv(omega)
    powers, powers_inv = [], []
    acc, acc_inv = 1, omega_inv
    for _ in range(size):
        powers.append(acc)
        powers_inv.append(acc_inv)
        acc = (acc * omega) % p
        acc_inv = (acc_inv * omega_inv) % p
    rev = bitrev_indices(size)
    omegas = [powers[i] for i in rev]
    zetas_inv = [powers_inv[i] for i in rev]

    def u64(vals):
        return np.array(vals, dtype=np.uint64)

    return NttOperator(
        q=q,
        size=size,
        omegas=u64(omegas),
        omegas_shoup=u64([(v << 64) // p for v in omegas]),
        zetas_inv=u64(zetas_inv),
        zetas_inv_shoup=u64([(v << 64) // p for v in zetas_inv]),
        size_inv=size_inv,
        size_inv_shoup=q.shoup(size_inv),
    )


@dataclass
class NttTables:
    """Per-limb tables of one context on one device, all int64 words (Shoup
    constants by bit pattern): (k, n) twiddles, (k,) scalars."""

    omegas: torch.Tensor
    omegas_shoup: torch.Tensor
    zetas_inv: torch.Tensor
    zetas_inv_shoup: torch.Tensor
    p: torch.Tensor
    barrett_lo: torch.Tensor
    barrett_hi: torch.Tensor
    ninv: torch.Tensor
    ninv_shoup: torch.Tensor
    mod: ModTable  # constants of the plain ops, shape (k, 1)

    @staticmethod
    def build(ops: list, device) -> "NttTables":
        def mat(attr):
            arr = np.stack([getattr(op, attr) for op in ops])
            return torch.from_numpy(zq.as_int64(arr)).to(device)

        def col(vals):
            return torch.from_numpy(zq.as_int64(
                np.array([int(v) for v in vals], dtype=np.uint64))).to(device)

        moduli = [op.q.p for op in ops]
        return NttTables(
            omegas=mat("omegas"),
            omegas_shoup=mat("omegas_shoup"),
            zetas_inv=mat("zetas_inv"),
            zetas_inv_shoup=mat("zetas_inv_shoup"),
            p=col(moduli),
            barrett_lo=col([op.q.barrett_lo for op in ops]),
            barrett_hi=col([op.q.barrett_hi for op in ops]),
            ninv=col([op.size_inv for op in ops]),
            ninv_shoup=col([op.size_inv_shoup for op in ops]),
            mod=ModTable(moduli, device),
        )


# ---------------------------------------------------------------------------
# Plain version (int64 torch ops, canonical values at every stage)
# ---------------------------------------------------------------------------


def forward_plain(x: torch.Tensor, omegas: torch.Tensor, mod: ModTable):
    """Forward negacyclic NTT of canonical (..., k, n) rows; omegas (k, n)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    m3 = mod.view((len(mod.moduli), 1, 1))
    l, m = n >> 1, 1
    while l > 0:
        x = x.reshape(lead + (m, 2, l))
        xl, xr = x[..., 0, :], x[..., 1, :]
        t = zq.mul(xr, omegas[:, m:2 * m, None], m3)
        x = torch.stack([zq.add(xl, t, m3), zq.sub(xl, t, m3)], dim=-2)
        x = x.reshape(lead + (n,))
        l >>= 1
        m <<= 1
    return x


def backward_plain(x: torch.Tensor, zetas_inv: torch.Tensor,
                   ninv: torch.Tensor, mod: ModTable):
    """Inverse negacyclic NTT with the n^{-1} fold; ninv (k,)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    m3 = mod.view((len(mod.moduli), 1, 1))
    l, k = 1, 0
    while l < n:
        m = n // (2 * l)
        x = x.reshape(lead + (m, 2, l))
        xl, xr = x[..., 0, :], x[..., 1, :]
        new_l = zq.add(xl, xr, m3)
        new_r = zq.mul(zq.sub(xl, xr, m3), zetas_inv[:, k:k + m, None], m3)
        x = torch.stack([new_l, new_r], dim=-2).reshape(lead + (n,))
        k += m
        l <<= 1
    return zq.mul(x, ninv[:, None], mod)


# ---------------------------------------------------------------------------
# Kernel K1 (csrc/ntt.cu)
# ---------------------------------------------------------------------------

_NTT_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def ntt_cuda(x: torch.Tensor, tables: NttTables, limb_slice: slice,
             inverse: bool) -> torch.Tensor:
    """Launch K1 on (..., k_sel, n) canonical residues of a CUDA tensor."""
    kernels.require_cuda_int64("ntt", x)
    k_ctx, n = tables.omegas.shape
    start, stop, _ = limb_slice.indices(k_ctx)
    k_sel = stop - start
    if x.shape[-1] != n or x.shape[-2] != k_sel:
        raise ValueError(f"ntt: shape {tuple(x.shape)} does not match "
                         f"{k_sel} limbs of degree {n}")
    if n * 8 > kernels.SMEM_BYTES:
        raise ValueError(f"ntt: degree {n} does not fit in shared memory")
    y = torch.empty_like(x)
    rows = x.numel() // n
    if rows == 0:
        return y
    tw = tables.zetas_inv if inverse else tables.omegas
    tws = tables.zetas_inv_shoup if inverse else tables.omegas_shoup
    fn = kernels.function("ntt", "tpufhe_ntt", _NTT_ARGS)
    kernels.count("ntt")
    err = fn(kernels.ptr(x), kernels.ptr(y), rows, k_sel, n, kernels.ptr(tw),
             kernels.ptr(tws), kernels.ptr(tables.p), kernels.ptr(tables.ninv),
             kernels.ptr(tables.ninv_shoup), start, int(inverse),
             kernels.stream())
    kernels.check(err, "ntt")
    return y


def ntt_transform(x: torch.Tensor, tables: NttTables,
                  limb_slice: slice | None = None,
                  inverse: bool = False) -> torch.Tensor:
    """Forward (or inverse) NTT of canonical (..., k_sel, n) rows; canonical
    output. limb_slice selects the context limbs the rows belong to."""
    sl = slice(None) if limb_slice is None else limb_slice
    if x.device.type == "cuda":
        return ntt_cuda(x, tables, sl, inverse)
    if x.device.type != "cpu":
        raise ValueError(f"ntt: unsupported device {x.device}")
    mod = tables.mod[sl]
    if inverse:
        return backward_plain(x, tables.zetas_inv[sl], tables.ninv[sl], mod)
    return forward_plain(x, tables.omegas[sl], mod)
