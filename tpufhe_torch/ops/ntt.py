"""Negacyclic NTT: host tables, the plain torch transforms, and kernels K1
(wide) and K9 (narrow).

- ``NttOperator.new`` builds the same tables as tpufhe.ops.ntt (fhe.rs
  ntt/native.rs): the seeded-ChaCha8 primitive-root search, bit-reversed
  ``omegas`` / ``zetas_inv`` with Shoup constants, and n^{-1}.
- ``forward_plain`` / ``backward_plain`` run the same stages over int64
  tensors with canonical values at every stage (exact ``zq.mul``), so
  their outputs equal tpufhe's transforms word for word.
- ``forward32_plain`` / ``backward32_plain`` do the same for narrow
  (w30) int32 rows, tpufhe's forward32 / backward32.
- ``ntt_transform`` is the wrapper of kernels K1 (csrc/ntt.cu) and K9
  (csrc/ntt32.cu): it launches the kernel of the tables' mode for CUDA
  tensors and takes the plain version for CPU tensors. A lazy forward
  (tpufhe's ``lazy`` flag) leaves the kernel's words below 4p, congruent
  to the canonical output; the plain versions return canonical words,
  which are valid lazy words.
- ``NttTables.pass_twiddles`` is the (twiddle, Shoup) table in the order
  the transform passes of K1, K3, K4, K5, K8 and K9 read it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from tpufhe_torch import kernels
from tpufhe_torch.ops import zq, zq32
from tpufhe_torch.ops.zq import ModTable, Modulus
from tpufhe_torch.utils.obs import uncounted
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

    # exact host transforms on Python ints, the tests' oracle (tpufhe
    # ntt.py:127-158)

    def forward_host(self, a) -> np.ndarray:
        """Forward negacyclic NTT of n residues, bit-reversed output."""
        a = [int(x) for x in a]
        p, n = self.q.p, self.size
        l, k = n >> 1, 1
        while l > 0:
            for start in range(0, n, 2 * l):
                w = int(self.omegas[k])
                k += 1
                for j in range(start, start + l):
                    x, y = a[j], a[j + l]
                    a[j] = (x + w * y) % p
                    a[j + l] = (x - w * y) % p
            l >>= 1
        return np.array(a, dtype=np.uint64)

    def backward_host(self, a) -> np.ndarray:
        """Inverse negacyclic NTT with the n^{-1} fold."""
        a = [int(x) for x in a]
        p, n = self.q.p, self.size
        l, k = 1, 0
        while l < n:
            for start in range(0, n, 2 * l):
                z = int(self.zetas_inv[k])
                k += 1
                for j in range(start, start + l):
                    x, y = a[j], a[j + l]
                    a[j] = (x + y) % p
                    a[j + l] = ((x - y) * z) % p
            l <<= 1
        return np.array([(x * self.size_inv) % p for x in a], dtype=np.uint64)


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
    """Per-limb tables of one context on one device: (k, n) twiddles, (k,)
    scalars. Wide tables are int64 words with 2^64-scaled Shoup constants;
    narrow (w30) tables are int32 words with 2^32-scaled ones (tpufhe's
    ctx.dev.om32 / oms32 / zi32 / zis32 / ninv32 / ninvs32) and no Barrett
    constants. Shoup constants are stored by bit pattern."""

    omegas: torch.Tensor
    omegas_shoup: torch.Tensor
    zetas_inv: torch.Tensor
    zetas_inv_shoup: torch.Tensor
    p: torch.Tensor
    barrett_lo: torch.Tensor | None
    barrett_hi: torch.Tensor | None
    ninv: torch.Tensor
    ninv_shoup: torch.Tensor
    mod: ModTable  # constants of the plain ops, shape (k, 1)
    narrow: bool = False
    _passes: dict = field(default_factory=dict, init=False, repr=False,
                          compare=False)

    @staticmethod
    def build(ops: list, device, narrow: bool = False) -> "NttTables":
        moduli = [op.q.p for op in ops]
        if narrow:
            def mat(attr):
                arr = np.stack([getattr(op, attr) for op in ops])
                return arr.astype(np.int32), zq32.shoup_array(arr, moduli)

            def col(vals):
                return torch.from_numpy(np.array(
                    [int(v) for v in vals], dtype=np.uint32).view(np.int32)
                ).to(device)

            om, om_s = mat("omegas")
            zi, zi_s = mat("zetas_inv")
            return NttTables(
                omegas=torch.from_numpy(om).to(device),
                omegas_shoup=torch.from_numpy(om_s).to(device),
                zetas_inv=torch.from_numpy(zi).to(device),
                zetas_inv_shoup=torch.from_numpy(zi_s).to(device),
                p=col(moduli), barrett_lo=None, barrett_hi=None,
                ninv=col([op.size_inv for op in ops]),
                ninv_shoup=col([op.q.shoup32(op.size_inv) for op in ops]),
                mod=ModTable(moduli, device), narrow=True)

        def mat(attr):
            arr = np.stack([getattr(op, attr) for op in ops])
            return torch.from_numpy(zq.as_int64(arr)).to(device)

        def col(vals):
            return torch.from_numpy(zq.as_int64(
                np.array([int(v) for v in vals], dtype=np.uint64))).to(device)

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

    @property
    def dtype(self) -> torch.dtype:
        """The word type of the rows these tables transform."""
        return torch.int32 if self.narrow else torch.int64

    def pass_twiddles(self, inverse: bool,
                      split: bool | None = None) -> torch.Tensor:
        """(k, n, 2) words: limb j's omegas (inverse: zetas_inv) and their
        Shoup constants side by side in the order the transform passes read
        them (kernels.forward_twiddle_order / inverse_twiddle_order), so
        that each pair is one load (16 bytes wide, 8 narrow) and a unit's
        pairs lie together. Wide tables: K1's split order where it splits
        the row (split None), else the whole row's; narrow tables: K9's
        passes of kernels.NARROW_PASS_STAGES stages over whole rows. Built
        once per direction and order."""
        n = self.omegas.shape[-1]
        if self.narrow:
            split, per = False, kernels.NARROW_PASS_STAGES
        else:
            split = kernels.ntt_split(n) if split is None else split
            per = kernels.PASS_STAGES
        key = (inverse, split)
        if key not in self._passes:
            order = (kernels.inverse_twiddle_order if inverse
                     else kernels.forward_twiddle_order)(n, split, per)
            tw, tws = ((self.zetas_inv, self.zetas_inv_shoup) if inverse
                       else (self.omegas, self.omegas_shoup))
            idx = torch.tensor(order, device=tw.device)
            self._passes[key] = torch.stack(
                (tw[:, idx], tws[:, idx]), -1).contiguous()
        return self._passes[key]


# ---------------------------------------------------------------------------
# Plain version (int64 torch ops, canonical values at every stage)
# ---------------------------------------------------------------------------


@uncounted
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


@uncounted
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
# Plain version of K9: the narrow transforms (int32 rows, int64 inside)
# ---------------------------------------------------------------------------


@uncounted
def forward32_plain(x: torch.Tensor, omegas: torch.Tensor, p: torch.Tensor):
    """Forward negacyclic NTT of canonical int32 (..., k, n) rows, p < 2^30;
    omegas (k, n), p (k,). The stages of tpufhe.ops.ntt.forward32 with
    canonical values at every stage ((a w) % p, products below 2^60), so
    the output equals its canonical output word for word."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    p3 = p.long()[:, None, None]
    w = omegas.long()
    x = x.long()
    l, m = n >> 1, 1
    while l > 0:
        x = x.reshape(lead + (m, 2, l))
        xl, xr = x[..., 0, :], x[..., 1, :]
        t = torch.remainder(xr * w[:, m:2 * m, None], p3)
        x = torch.stack([zq32.add(xl, t, p3), zq32.sub(xl, t, p3)], dim=-2)
        x = x.reshape(lead + (n,))
        l >>= 1
        m <<= 1
    return x.int()


@uncounted
def backward32_plain(x: torch.Tensor, zetas_inv: torch.Tensor,
                     ninv: torch.Tensor, p: torch.Tensor):
    """Inverse narrow NTT with the n^{-1} fold (tpufhe.ops.ntt.backward32),
    canonical at every stage; ninv, p (k,)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    p3 = p.long()[:, None, None]
    z = zetas_inv.long()
    x = x.long()
    l, k = 1, 0
    while l < n:
        m = n // (2 * l)
        x = x.reshape(lead + (m, 2, l))
        xl, xr = x[..., 0, :], x[..., 1, :]
        new_r = torch.remainder(zq32.sub(xl, xr, p3) * z[:, k:k + m, None], p3)
        x = torch.stack([zq32.add(xl, xr, p3), new_r], dim=-2)
        x = x.reshape(lead + (n,))
        k += m
        l <<= 1
    return torch.remainder(x * ninv.long()[:, None], p.long()[:, None]).int()


# ---------------------------------------------------------------------------
# Kernels K1 (csrc/ntt.cu) and K9 (csrc/ntt32.cu)
# ---------------------------------------------------------------------------

_NTT_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 2
             + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_NTT32_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 2
               + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _rows(name: str, x: torch.Tensor, tables: NttTables,
          limb_slice: slice, inverse: bool, lazy: bool) -> tuple[int, int]:
    """The checks K1 and K9 make on (..., k_sel, n) rows: (first limb,
    k_sel)."""
    if inverse and lazy:
        raise ValueError(f"{name}: the inverse transform has no lazy output")
    kernels.require_cuda(name, tables.dtype, x)
    k_ctx, n = tables.omegas.shape
    start, stop, _ = limb_slice.indices(k_ctx)
    k_sel = stop - start
    if x.shape[-1] != n or x.shape[-2] != k_sel:
        raise ValueError(f"{name}: shape {tuple(x.shape)} does not match "
                         f"{k_sel} limbs of degree {n}")
    return start, k_sel


def ntt_cuda(x: torch.Tensor, tables: NttTables, limb_slice: slice,
             inverse: bool, lazy: bool = False) -> torch.Tensor:
    """Launch K1 on (..., k_sel, n) canonical int64 residues of a CUDA
    tensor: one CTA a row, or at n = 16384 a cluster of two CTAs holding
    half a row each (kernels.ntt_plan). lazy: a forward whose words are
    left below 4p (read as unsigned: for a 62-bit p an int64 word may be
    negative)."""
    start, k_sel = _rows("ntt", x, tables, limb_slice, inverse, lazy)
    n = x.shape[-1]
    cluster, threads, _ = kernels.ntt_plan(n)  # raises above two CTAs
    if x.data_ptr() % 16:
        raise ValueError("ntt: rows are not 16-byte aligned")
    y = torch.empty_like(x)
    rows = x.numel() // n
    if rows == 0:
        return y
    tw = tables.pass_twiddles(inverse)
    fn = kernels.function("ntt", "tpufhe_ntt", _NTT_ARGS)
    kernels.count("ntt")
    err = fn(kernels.ptr(x), kernels.ptr(y), rows, k_sel, n, kernels.ptr(tw),
             kernels.ptr(tables.p), kernels.ptr(tables.ninv),
             kernels.ptr(tables.ninv_shoup), start, int(inverse), int(lazy),
             cluster, threads, kernels.stream())
    kernels.check(err, "ntt")
    return y


def ntt32_cuda(x: torch.Tensor, tables: NttTables, limb_slice: slice,
               inverse: bool, lazy: bool = False) -> torch.Tensor:
    """Launch K9 on (..., k_sel, n) canonical int32 residues (p < 2^30) of
    a CUDA tensor, with a narrow context's tables: one CTA a row
    (kernels.ntt32_plan). lazy: a forward whose words are left below 4p
    (read as unsigned: an int32 word may be negative)."""
    start, k_sel = _rows("ntt32", x, tables, limb_slice, inverse, lazy)
    n = x.shape[-1]
    if n * x.element_size() > kernels.SMEM_BYTES:
        raise ValueError(f"ntt32: degree {n} does not fit in shared memory")
    if x.data_ptr() % 16:
        raise ValueError("ntt32: rows are not 16-byte aligned")
    _, threads, _ = kernels.ntt32_plan(n)
    y = torch.empty_like(x)
    rows = x.numel() // n
    if rows == 0:
        return y
    tw = tables.pass_twiddles(inverse)
    fn = kernels.function("ntt32", "tpufhe_ntt32", _NTT32_ARGS)
    kernels.count("ntt32")
    err = fn(kernels.ptr(x), kernels.ptr(y), rows, k_sel, n, kernels.ptr(tw),
             kernels.ptr(tables.p), kernels.ptr(tables.ninv),
             kernels.ptr(tables.ninv_shoup), start, int(inverse), int(lazy),
             threads, kernels.stream())
    kernels.check(err, "ntt32")
    return y


def ntt_transform(x: torch.Tensor, tables: NttTables,
                  limb_slice: slice | None = None,
                  inverse: bool = False, lazy: bool = False) -> torch.Tensor:
    """Forward (or inverse) NTT of canonical (..., k_sel, n) rows; canonical
    output. limb_slice selects the context limbs the rows belong to. Narrow
    tables take int32 rows (K9 on the card), wide ones int64 rows (K1).
    lazy (forward only): the output words are below 4p and congruent to
    the canonical ones, as tpufhe's lazy forward leaves them; the plain
    version returns the canonical words, one valid lazy output."""
    sl = slice(None) if limb_slice is None else limb_slice
    if x.device.type == "cuda":
        launch = ntt32_cuda if tables.narrow else ntt_cuda
        return launch(x, tables, sl, inverse, lazy)
    if x.device.type != "cpu":
        raise ValueError(f"ntt: unsupported device {x.device}")
    if inverse and lazy:
        raise ValueError("ntt: the inverse transform has no lazy output")
    if x.dtype != tables.dtype:
        raise ValueError(f"ntt: dtype {x.dtype}, expected {tables.dtype}")
    if tables.narrow:
        if inverse:
            return backward32_plain(x, tables.zetas_inv[sl], tables.ninv[sl],
                                    tables.p[sl])
        return forward32_plain(x, tables.omegas[sl], tables.p[sl])
    mod = tables.mod[sl]
    if inverse:
        return backward_plain(x, tables.zetas_inv[sl], tables.ninv[sl], mod)
    return forward_plain(x, tables.omegas[sl], mod)
