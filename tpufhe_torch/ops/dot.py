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

_DOT_ARGS = ([ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
             + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4)
# what does not change between calls: the launcher per loader (argument
# types set once), and per context its window and table pointers
_LAUNCHERS: dict = {}
_WINDOWS: dict = {}
_TABLES: dict = {}


def dot_window(ctx) -> int:
    """Products the kernel sums in 128 bits before a reduction: tpufhe's
    min_l 2^(2 lz(q_l)) - 2 (14 for 62-bit moduli), at least 1."""
    win = _WINDOWS.get(ctx)
    if win is None:
        win = _WINDOWS[ctx] = max(
            1, min(1 << (2 * q.leading_zeros) for q in ctx.q) - 2)
    return win


def _check(name: str, ctx, parts: list, db: torch.Tensor) -> tuple:
    """(n, m, B, R): the shapes every version takes. parts: P tensors of
    (>= n, B, R, N); db: (n, m, R, N); R a multiple of the context's k."""
    if ctx.narrow:
        raise UnsupportedOperation(
            f"{name}: narrow (w30) contexts have no ct x pt dot kernel")
    n_deg = ctx.degree
    shape = db.shape
    if len(shape) != 4 or shape[3] != n_deg or shape[2] % ctx.k:
        raise ValueError(f"{name}: db shape {tuple(shape)}, expected "
                         f"(n, m, R, {n_deg}) with R a multiple of {ctx.k}")
    n, m, r, _ = shape
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"{name}: {len(parts)} parts, expected 1 to "
                         f"{MAX_PARTS}")
    first = parts[0].shape
    b = first[1] if len(first) == 4 else None
    for e in parts:
        s = e.shape
        if (len(s) != 4 or s[0] < n or s[1] != b or s[2] != r
                or s[3] != n_deg):
            raise ValueError(f"{name}: part shape {tuple(s)}, expected "
                             f"(>= {n}, B, {r}, {n_deg}) alike")
    if n < 1 or m < 1:
        raise ValueError(f"{name}: no terms or no columns")
    return n, m, b, r


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


def _launcher():
    """The kernel's C entry point, its argument types set once for each
    loader (kernels.function, or one put in its place)."""
    fn = _LAUNCHERS.get(kernels.function)
    if fn is None:
        fn = _LAUNCHERS[kernels.function] = kernels.function(
            "ct_pt_dot", "tpufhe_ct_pt_dot", _DOT_ARGS)
    return fn


def _tables(ctx) -> tuple:
    """(moduli, Barrett lo, Barrett hi) pointers of a context's tables."""
    c = _TABLES.get(ctx)
    if c is None:
        tb = ctx.tables
        c = _TABLES[ctx] = (tb.p.data_ptr(), tb.barrett_lo.data_ptr(),
                            tb.barrett_hi.data_ptr())
    return c


def ct_pt_dot_cuda(ctx, parts: list, db: torch.Tensor) -> torch.Tensor:
    """Launch ct_pt_dot on int64 CUDA tensors: a thread serves every part
    and up to 8 columns of its output word, the terms streamed through a
    ring in shared memory. Returns (P, m, B, R, N)."""
    kernels.require_cuda("ct_pt_dot", torch.int64, db, *parts)
    n, m, b, r = _check("ct_pt_dot", ctx, parts, db)
    n_deg = ctx.degree
    out = torch.empty((len(parts), m, b, r, n_deg), dtype=torch.int64,
                      device=db.device)
    plane = b * r * n_deg
    if plane == 0:
        return out
    p, b_lo, b_hi = _tables(ctx)
    fn = _launcher()
    ptrs = (ctypes.c_void_p * len(parts))(*[e.data_ptr() for e in parts])
    kernels.count("ct_pt_dot")
    err = fn(ptrs, len(parts), db.data_ptr(), out.data_ptr(), plane,
             r * n_deg, n, m, ctx.k, n_deg, min(dot_window(ctx), n), p,
             b_lo, b_hi, kernels.stream())
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
