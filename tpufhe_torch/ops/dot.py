"""Ciphertext x plaintext dot products with deferred 128-bit accumulation
(kernel ct_pt_dot, csrc/ct_pt_dot.cu).

For every part p, column j, batch row b, row r and coefficient c:

    r[p, j, b, r, c] = sum_{i < n} db[i, j, r, c] e_p[i, b, r, c]
                       mod q_(r mod k)

on canonical NTT-domain residues, canonical out. tpufhe forms these sums
in XLA (make_ct_pt_dot, tpufhe/pipeline.py:1091-1162; rq.dot_product,
tpufhe/ops/rq.py:1337-1368) with one Barrett reduction per window of
``dot_window`` 128-bit products; the result is canonical, so the plain
version here (one modular product and add per term) gives the same
integers.
"""

from __future__ import annotations

import ctypes

import torch

from tpufhe_torch import kernels
from tpufhe_torch.errors import UnsupportedOperation
from tpufhe_torch.ops import zq

# the kernel's limit on parts (csrc/ct_pt_dot.cu DOT_MAX_PARTS)
MAX_PARTS = 8

_DOT_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 4)


def dot_window(ctx) -> int:
    """Products the kernel sums in 128 bits before a reduction: tpufhe's
    min_l 2^(2 lz(q_l)) - 2 (14 for 62-bit moduli), at least 1."""
    return max(1, min(1 << (2 * q.leading_zeros) for q in ctx.q) - 2)


def _check(name: str, ctx, parts: list, db: torch.Tensor) -> tuple:
    """(n, m, B, R): the shapes every version takes. parts: P tensors of
    (>= n, B, R, N); db: (n, m, R, N); R a multiple of the context's k."""
    if ctx.narrow:
        raise UnsupportedOperation(
            f"{name}: narrow (w30) contexts have no ct x pt dot kernel")
    k, n_deg = ctx.k, ctx.degree
    if db.dim() != 4 or db.shape[-1] != n_deg or db.shape[2] % k:
        raise ValueError(f"{name}: db shape {tuple(db.shape)}, expected "
                         f"(n, m, R, {n_deg}) with R a multiple of {k}")
    n, m, r = db.shape[:3]
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"{name}: {len(parts)} parts, expected 1 to "
                         f"{MAX_PARTS}")
    shape = tuple(parts[0].shape)
    for e in parts:
        if (e.dim() != 4 or tuple(e.shape[1:]) != shape[1:] or e.shape[0] < n
                or e.shape[2:] != (r, n_deg)):
            raise ValueError(f"{name}: part shape {tuple(e.shape)}, expected "
                             f"(>= {n}, B, {r}, {n_deg}) alike")
    if n < 1 or m < 1:
        raise ValueError(f"{name}: no terms or no columns")
    return n, m, shape[1], r


def ct_pt_dot_plain(ctx, parts: list, db: torch.Tensor) -> torch.Tensor:
    """The plain version of ct_pt_dot: one zq.mul and zq.add per term, the
    rows folded as (..., R / k, k, N) against the context's (k, 1)
    constants. Returns (P, m, B, R, N)."""
    n, m, b, r = _check("ct_pt_dot", ctx, parts, db)
    k, n_deg = ctx.k, ctx.degree
    mod = ctx.mod
    out = []
    for e in parts:
        x = e[:n].reshape(n, 1, b, r // k, k, n_deg)
        y = db.reshape(n, m, 1, r // k, k, n_deg)
        acc = zq.mul(x[0], y[0], mod)
        for i in range(1, n):
            acc = zq.add(acc, zq.mul(x[i], y[i], mod), mod)
        out.append(acc.reshape(m, b, r, n_deg))
    return torch.stack(out)


def ct_pt_dot_cuda(ctx, parts: list, db: torch.Tensor) -> torch.Tensor:
    """Launch ct_pt_dot on int64 CUDA tensors: one thread per output word of
    a part, all columns. Returns (P, m, B, R, N)."""
    kernels.require_cuda("ct_pt_dot", torch.int64, db, *parts)
    n, m, b, r = _check("ct_pt_dot", ctx, parts, db)
    n_deg = ctx.degree
    out = torch.empty((len(parts), m, b, r, n_deg), dtype=torch.int64,
                      device=db.device)
    plane = b * r * n_deg
    if plane == 0:
        return out
    tb = ctx.tables
    ptrs = (ctypes.c_void_p * len(parts))(*(e.data_ptr() for e in parts))
    fn = kernels.function("ct_pt_dot", "tpufhe_ct_pt_dot", _DOT_ARGS)
    kernels.count("ct_pt_dot")
    err = fn(ctypes.cast(ptrs, ctypes.c_void_p), len(parts), kernels.ptr(db),
             kernels.ptr(out), plane, r * n_deg, n, m, ctx.k, n_deg,
             min(dot_window(ctx), n), kernels.ptr(tb.p),
             kernels.ptr(tb.barrett_lo), kernels.ptr(tb.barrett_hi),
             kernels.stream())
    kernels.check(err, "ct_pt_dot")
    return out


def ct_pt_dot(ctx, parts: list, db: torch.Tensor) -> torch.Tensor:
    """Sum over i < n of db[i] times rows i of every part (see the module
    docstring); a wide (int64) context only."""
    if db.device.type == "cuda":
        return ct_pt_dot_cuda(ctx, parts, db)
    if db.device.type != "cpu":
        raise ValueError(f"ct_pt_dot: unsupported device {db.device}")
    return ct_pt_dot_plain(ctx, parts, db)
