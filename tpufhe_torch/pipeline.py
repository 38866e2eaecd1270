"""End-to-end BFV programs over raw coefficient tensors: the fused
multiply + relinearize (default HPS strategy and strategy 2), the square +
relinearize, the Galois rotation, inner sum and oblivious expansion, the
symmetric and public-key encryption cores, the decryption core, the
ciphertext add and the ct x pt dot products (kernel ct_pt_dot, ops/dot.py),
the MulPIR server response (expansion, two dot-product dimensions, one
relinearization), and the key switch behind RelinearizationKey.relinearizes,
also for keys below the ciphertext's level (kernel ks_tail, the key switch
alone, where the fused tails run). The port of the matching parts of
tpufhe/pipeline.py.

A default mul+relin step runs six kernel launches, in tpufhe's structure
(pipeline.py:509-569):

1. K1 inverse NTT of the four input parts (k limbs);
2. K2 extend: HPS conversion by 1 into the k_mul - k new limbs;
3. K1 forward NTT of the new limbs (limb_slice = k .. k_mul);
4. K3 tensor product + inverse NTT over the k_mul-limb basis;
5. K2 down-scale by t/q into the k ciphertext limbs;
6. K4 relin tail: forward NTT of c0, c1 and the Garner digits of c2,
   key-switch accumulate, and the two adds.

With ``ext_fuse=True`` K8 (ops/intt_scale.py) replaces each extend's K1
inverse + K2 pair. Strategy 2 (``strategy2_primes=kP``) extends the lhs
exactly into q + P (P the product of kP new 62-bit primes) and scales the
rhs by P/q into the whole basis, then down-scales the tensor by t/P
(pipeline.py:446-471, 522-538). The square (pipeline.py:584-621) extends
one ciphertext and forms its tensor with K7 before the inverse NTT.

A rotation step (pipeline.py:756-781) gathers both parts by the Galois
permutation (plain torch, as tpufhe's XLA take), then runs two launches:
K1 inverse NTT of the substituted c1, and K5 rotate tail: forward NTT of
its Garner digits, key-switch accumulate and the add of the substituted c0.

K3, K4 and K5 run a cluster of one-row CTAs per (batch row, limb). Where
three rows do not fit one block (``kernels.tail_fits``, the route rule,
false at N = 16384), the programs take
tpufhe's unfused composition for all three, chosen when they are built
(tpufhe pipeline.py:476-486, 545-569, 763-779): K7 then K1 inverse over
the multiplication basis in place of K3; one K1 forward of the stacked
rows (c0, c1 and the Garner digits of c2, or the digits alone for a
rotation) then the ``ks_accumulate`` kernel in place of K4 and K5. A
default mul+relin or square then runs ntt 4, rns_scale 2, tensor 1,
ks_accumulate 1; a rotation ntt 2, ks_accumulate 1.

On narrow (w30) parameters, whose moduli are all below 2^30, the rows are
int32 and every transform is K9 (ops/ntt.py ntt32_cuda); the extend and
down-scale stay K2, on int32 rows. tpufhe turns its other kernels off for
narrow contexts, and so does the port: the programs take the unfused
composition, with the tensor product (``tensor32``) as zq32 glue and the
key-switch accumulate and adds as ``ks_accumulate`` on int32 words.
Launches: ntt32 4, rns_scale 2 and ks_accumulate 1 per mul+relin or
square, ntt32 2 and ks_accumulate 1 per rotation.

Tensors are (..., k, N) on the parameters' device, int64 (int32 when
narrow); leading dimensions are the batch. K3, K4, K5, K7 and
ks_accumulate sit in this module beside their plain versions.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import partial
from types import SimpleNamespace

import numpy as np
import torch

from tpufhe_torch import kernels
from tpufhe_torch.bfv.encoding import SIMD, Encoding
from tpufhe_torch.bfv.keys.key_switching_key import decomposition_digits
from tpufhe_torch.bfv.parameters import BfvParameters
from tpufhe_torch.errors import SimdNotSupported, UnsupportedOperation
from tpufhe_torch.ops import zq
from tpufhe_torch.ops.dot import ct_pt_dot
from tpufhe_torch.ops.intt_scale import intt_scale, intt_scale_fits
from tpufhe_torch.ops.ntt import backward_plain, forward_plain
from tpufhe_torch.ops.rns import RnsScaler, ScalingFactor
from tpufhe_torch.ops.rq import (
    Context,
    Scaler,
    SubstitutionExponent,
    ntt_backward,
    ntt_forward,
    scale_into,
    substitute,
    switch_down_to,
)
from tpufhe_torch.utils import obs
from tpufhe_torch.utils.obs import uncounted
from tpufhe_torch.utils.primes import generate_prime

# ---------------------------------------------------------------------------
# Key-switch helpers (plain torch glue)
# ---------------------------------------------------------------------------


def _ksk_digits(ctx: Context, c2_pb: torch.Tensor) -> torch.Tensor:
    """Garner decomposition rows of power-basis c2 (..., k, N): row i is
    c2's limb i reduced modulo every limb modulus p_j, canonical.
    Returns (k, ..., k, N), contiguous (a kernel's input on the narrow
    path)."""
    rows = torch.movedim(c2_pb, -2, 0)[..., None, :]  # (k, ..., 1, N)
    return torch.remainder(rows, ctx.p_col).contiguous()


def ksk_rows(ctx: Context, c2_pb: torch.Tensor, ksk) -> torch.Tensor:
    """The decomposition rows of power-basis c2 (..., k, N) for `ksk`: a
    single-modulus key's base-2^log_base digits, else the Garner digits.
    Returns (rows, ..., k, N)."""
    if ksk.log_base:
        return decomposition_digits(c2_pb, ksk.log_base, ksk.c0.shape[0])
    return _ksk_digits(ctx, c2_pb)


def _ksk_accumulate(ctx: Context, lifted: torch.Tensor, ksk):
    """sum_i d_i ksk.c{0,1}_i with Shoup products on NTT-domain rows
    (key_switching_key.rs:227-239); the plain version of the accumulate
    of K4, K5 and ks_accumulate."""
    acc0 = acc1 = None
    for i in range(ksk.c0.shape[0]):
        t0 = ctx.mul_shoup(lifted[i], ksk.c0[i], ksk.c0_shoup[i])
        t1 = ctx.mul_shoup(lifted[i], ksk.c1[i], ksk.c1_shoup[i])
        acc0 = t0 if acc0 is None else ctx.add(acc0, t0)
        acc1 = t1 if acc1 is None else ctx.add(acc1, t1)
    return acc0, acc1


def _check_key(name: str, ksk, k: int, n: int, digits: int | None = None
               ) -> None:
    """Raise unless the key's four tables are (digits, k, n), digits = k
    (the Garner rows) unless given."""
    digits = k if digits is None else digits
    for t in (ksk.c0, ksk.c0_shoup, ksk.c1, ksk.c1_shoup):
        if tuple(t.shape) != (digits, k, n):
            raise ValueError(f"{name}: key shape {tuple(t.shape)}, "
                             f"expected ({digits}, {k}, {n})")


# ---------------------------------------------------------------------------
# The narrow (w30) glue: zq32 on int32 rows, any device
# ---------------------------------------------------------------------------


def tensor32(ctx: Context, a0, a1, b0, b1) -> torch.Tensor:
    """NTT-domain (..., k, N) int32 parts of a narrow context -> stacked
    (3, ..., k, N) (a0 b0, a0 b1 + a1 b0, a1 b1): tpufhe's narrow tensor
    (pipeline.py:129-148, _tensor_for)."""
    c1 = ctx.add(ctx.mul(a0, b1), ctx.mul(a1, b0))
    return torch.stack([ctx.mul(a0, b0), c1, ctx.mul(a1, b1)])


# ---------------------------------------------------------------------------
# K7: tensor product (csrc/tensor.cu)
# ---------------------------------------------------------------------------

_TENSOR_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int] + [ctypes.c_void_p] * 4


@uncounted
def tensor_plain(ctx: Context, a0, a1, b0, b1) -> torch.Tensor:
    """NTT-domain (..., k, N) parts -> stacked (3, ..., k, N)
    (a0 b0, a0 b1 + a1 b0, a1 b1), the plain version of K7."""
    mod = ctx.mod
    c0 = zq.mul(a0, b0, mod)
    c1 = zq.add(zq.mul(a0, b1, mod), zq.mul(a1, b0, mod), mod)
    c2 = zq.mul(a1, b1, mod)
    return torch.stack([c0, c1, c2])


def tensor_cuda(ctx: Context, a0, a1, b0, b1) -> torch.Tensor:
    """Launch K7 on (..., k, n) rows: whole rows (n = N) or a shard's
    coefficient block of them (parallel/seq_pipeline.py)."""
    kernels.require_cuda("tensor", torch.int64, a0, a1, b0, b1)
    k, n = ctx.k, a0.shape[-1]
    shapes = [tuple(t.shape) for t in (a0, a1, b0, b1)]
    if shapes[0][-2:] != (k, n) or len(set(shapes)) != 1:
        raise ValueError(f"tensor: shapes {shapes}, expected four of "
                         f"(..., {k}, {n})")
    out = torch.empty((3,) + a0.shape, dtype=torch.int64, device=a0.device)
    rows_k = a0.numel() // n
    if rows_k == 0:
        return out
    tb = ctx.tables
    fn = kernels.function("tensor", "tpufhe_tensor", _TENSOR_ARGS)
    kernels.count("tensor")
    err = fn(kernels.ptr(a0), kernels.ptr(a1), kernels.ptr(b0), kernels.ptr(b1),
             kernels.ptr(out), rows_k, k, n, kernels.ptr(tb.p),
             kernels.ptr(tb.barrett_lo), kernels.ptr(tb.barrett_hi),
             kernels.stream())
    kernels.check(err, "tensor")
    return out


def tensor(ctx: Context, a0, a1, b0, b1) -> torch.Tensor:
    if a0.device.type == "cuda":
        return tensor_cuda(ctx, a0, a1, b0, b1)
    if a0.device.type != "cpu":
        raise ValueError(f"tensor: unsupported device {a0.device}")
    return tensor_plain(ctx, a0, a1, b0, b1)


# ---------------------------------------------------------------------------
# K3: tensor product + inverse NTT (csrc/tensor_intt.cu)
# ---------------------------------------------------------------------------

_TENSOR_INTT_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p])


@uncounted
def tensor_intt_plain(ctx_mul: Context, ext: torch.Tensor) -> torch.Tensor:
    """(4, ..., k, N) NTT-domain (a0, a1, b0, b1) -> (3, ..., k, N) power
    basis (a0 b0, a0 b1 + a1 b0, a1 b1), the plain version of K3."""
    tb = ctx_mul.tables
    return backward_plain(tensor_plain(ctx_mul, *ext), tb.zetas_inv, tb.ninv,
                          ctx_mul.mod)


def tensor_intt_cuda(ctx_mul: Context, ext: torch.Tensor) -> torch.Tensor:
    """Launch K3: a cluster of three CTAs per (row, limb), one per output
    part (kernels.tensor_intt_plan)."""
    kernels.require_cuda("tensor_intt", torch.int64, ext)
    k, n = ctx_mul.k, ctx_mul.degree
    if ext.shape[0] != 4 or ext.shape[-2:] != (k, n):
        raise ValueError(f"tensor_intt: shape {tuple(ext.shape)}, expected "
                         f"(4, ..., {k}, {n})")
    if not kernels.tail_fits(n):
        raise ValueError(f"tensor_intt: degree {n} does not fit in shared memory")
    out = torch.empty((3,) + ext.shape[1:], dtype=torch.int64, device=ext.device)
    rows_k = ext[0].numel() // n
    if rows_k == 0:
        return out
    tb = ctx_mul.tables
    tz = tb.pass_twiddles(True)
    cluster, threads, _ = kernels.tensor_intt_plan(n)
    fn = kernels.function("tensor_intt", "tpufhe_tensor_intt", _TENSOR_INTT_ARGS)
    kernels.count("tensor_intt")
    err = fn(kernels.ptr(ext), kernels.ptr(out), rows_k, k, n, kernels.ptr(tz),
             kernels.ptr(tb.p), kernels.ptr(tb.barrett_lo),
             kernels.ptr(tb.barrett_hi), kernels.ptr(tb.ninv),
             kernels.ptr(tb.ninv_shoup), cluster, threads, kernels.stream())
    kernels.check(err, "tensor_intt")
    return out


def tensor_intt(ctx_mul: Context, ext: torch.Tensor) -> torch.Tensor:
    if ext.device.type == "cuda":
        return tensor_intt_cuda(ctx_mul, ext)
    if ext.device.type != "cpu":
        raise ValueError(f"tensor_intt: unsupported device {ext.device}")
    return tensor_intt_plain(ctx_mul, ext)


# ---------------------------------------------------------------------------
# K4: relin tail (csrc/relin_tail.cu)
# ---------------------------------------------------------------------------

_RELIN_TAIL_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                    + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 9)


@uncounted
def relin_tail_plain(ctx: Context, dsc: torch.Tensor, ksk):
    """(3, ..., k, N) power-basis (c0, c1, c2) -> NTT-domain
    (c0 + ks0, c1 + ks1): the stacked forward NTT, _ksk_accumulate and the
    adds of tpufhe pipeline.py:559-569, the plain version of K4."""
    mod = ctx.mod
    tb = ctx.tables
    digits = _ksk_digits(ctx, dsc[2])
    ntts = forward_plain(torch.cat([dsc[:2], digits]), tb.omegas, mod)
    ks0, ks1 = _ksk_accumulate(ctx, ntts[2:], ksk)
    return zq.add(ntts[0], ks0, mod), zq.add(ntts[1], ks1, mod)


def relin_tail_cuda(ctx: Context, dsc: torch.Tensor, ksk):
    """Launch K4; returns the two output parts."""
    kernels.require_cuda("relin_tail", torch.int64, dsc, ksk.c0,
                         ksk.c0_shoup, ksk.c1, ksk.c1_shoup)
    k, n = ctx.k, ctx.degree
    if dsc.shape[0] != 3 or dsc.shape[-2:] != (k, n):
        raise ValueError(f"relin_tail: shape {tuple(dsc.shape)}, expected "
                         f"(3, ..., {k}, {n})")
    _check_key("relin_tail", ksk, k, n)
    if not kernels.tail_fits(n):
        raise ValueError(f"relin_tail: degree {n} does not fit in shared memory")
    out = torch.empty((2,) + dsc.shape[1:], dtype=torch.int64, device=dsc.device)
    rows_k = dsc[0].numel() // n
    if rows_k == 0:
        return out[0], out[1]
    tb = ctx.tables
    tw = tb.pass_twiddles(False)
    cluster, threads, _ = kernels.tail_plan(k + 2, n)
    fn = kernels.function("relin_tail", "tpufhe_relin_tail", _RELIN_TAIL_ARGS)
    kernels.count("relin_tail")
    err = fn(kernels.ptr(dsc), kernels.ptr(out), rows_k, k, n, cluster,
             threads, kernels.ptr(ksk.c0), kernels.ptr(ksk.c0_shoup),
             kernels.ptr(ksk.c1), kernels.ptr(ksk.c1_shoup),
             kernels.ptr(tw), kernels.ptr(tb.p), kernels.ptr(tb.barrett_lo),
             kernels.ptr(tb.barrett_hi), kernels.stream())
    kernels.check(err, "relin_tail")
    return out[0], out[1]


def relin_tail(ctx: Context, dsc: torch.Tensor, ksk):
    if dsc.device.type == "cuda":
        return relin_tail_cuda(ctx, dsc, ksk)
    if dsc.device.type != "cpu":
        raise ValueError(f"relin_tail: unsupported device {dsc.device}")
    return relin_tail_plain(ctx, dsc, ksk)


# ---------------------------------------------------------------------------
# K5: rotate tail (csrc/rotate_tail.cu)
# ---------------------------------------------------------------------------

_ROTATE_TAIL_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                     + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 9)


@uncounted
def rotate_tail_plain(ctx: Context, s0: torch.Tensor, c2_pb: torch.Tensor, ksk):
    """NTT-domain s0 and power-basis c2, both (..., k, N) -> NTT-domain
    (s0 + ks0, ks1): the Garner digits of c2, their forward NTT,
    _ksk_accumulate and the add (tpufhe pipeline.py:778-779 with
    _key_switch_batched), the plain version of K5."""
    mod = ctx.mod
    digits = _ksk_digits(ctx, c2_pb)
    ks0, ks1 = _ksk_accumulate(
        ctx, forward_plain(digits, ctx.tables.omegas, mod), ksk)
    return zq.add(s0, ks0, mod), ks1


def rotate_tail_cuda(ctx: Context, s0: torch.Tensor, c2_pb: torch.Tensor, ksk):
    """Launch K5; returns the two output parts."""
    kernels.require_cuda("rotate_tail", torch.int64, s0, c2_pb, ksk.c0,
                         ksk.c0_shoup, ksk.c1, ksk.c1_shoup)
    k, n = ctx.k, ctx.degree
    if s0.shape != c2_pb.shape or s0.shape[-2:] != (k, n):
        raise ValueError(f"rotate_tail: shapes {tuple(s0.shape)} and "
                         f"{tuple(c2_pb.shape)}, expected (..., {k}, {n})")
    _check_key("rotate_tail", ksk, k, n)
    if not kernels.tail_fits(n):
        raise ValueError(f"rotate_tail: degree {n} does not fit in shared memory")
    out = torch.empty((2,) + s0.shape, dtype=torch.int64, device=s0.device)
    rows_k = s0.numel() // n
    if rows_k == 0:
        return out[0], out[1]
    tb = ctx.tables
    tw = tb.pass_twiddles(False)
    cluster, threads, _ = kernels.tail_plan(k, n)
    fn = kernels.function("rotate_tail", "tpufhe_rotate_tail", _ROTATE_TAIL_ARGS)
    kernels.count("rotate_tail")
    err = fn(kernels.ptr(s0), kernels.ptr(c2_pb), kernels.ptr(out), rows_k, k, n,
             cluster, threads, kernels.ptr(ksk.c0), kernels.ptr(ksk.c0_shoup),
             kernels.ptr(ksk.c1), kernels.ptr(ksk.c1_shoup),
             kernels.ptr(tw), kernels.ptr(tb.p), kernels.ptr(tb.barrett_lo),
             kernels.ptr(tb.barrett_hi), kernels.stream())
    kernels.check(err, "rotate_tail")
    return out[0], out[1]


def rotate_tail(ctx: Context, s0: torch.Tensor, c2_pb: torch.Tensor, ksk):
    if s0.device.type == "cuda":
        return rotate_tail_cuda(ctx, s0, c2_pb, ksk)
    if s0.device.type != "cpu":
        raise ValueError(f"rotate_tail: unsupported device {s0.device}")
    return rotate_tail_plain(ctx, s0, c2_pb, ksk)


# ---------------------------------------------------------------------------
# ks_tail: the key switch alone (csrc/relin_tail.cu, tpufhe's mode ks_only)
# ---------------------------------------------------------------------------

_KS_TAIL_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 9)


@uncounted
def ks_tail_plain(ctx: Context, c2_pb: torch.Tensor, ksk) -> torch.Tensor:
    """Power-basis c2 (..., d, N) -> stacked NTT-domain (ks0, ks1), each
    (..., k, N) over the key's context ctx: the Garner rows of c2 reduced
    modulo every key modulus, their canonical forward NTT and the
    accumulate (key_switching_key.rs:214-241), the plain version of
    ks_tail."""
    lifted = forward_plain(ksk_rows(ctx, c2_pb, ksk), ctx.tables.omegas,
                           ctx.mod)
    return ks_accumulate_plain(ctx, lifted, ksk)


def ks_tail_cuda(ctx: Context, c2_pb: torch.Tensor, ksk) -> torch.Tensor:
    """Launch ks_tail: a Garner key's d = ksk.c0.shape[0] digit rows (the
    limbs of c2, of the key's ciphertext context) over the k >= d limbs of
    the key's context ctx, one cluster of d CTAs per (row, limb). The
    ciphertext's moduli must be the first d of ctx's: the kernel reads
    digit i's modulus from ctx's limb i."""
    kernels.require_cuda("ks_tail", torch.int64, c2_pb, ksk.c0, ksk.c0_shoup,
                         ksk.c1, ksk.c1_shoup)
    k, n, d = ctx.k, ctx.degree, c2_pb.shape[-2]
    if c2_pb.shape[-1] != n or not 1 <= d <= k:
        raise ValueError(f"ks_tail: c2 {tuple(c2_pb.shape)} for a key over "
                         f"({k}, {n})")
    if ksk.log_base or tuple(ksk.ctx_ciphertext.moduli) != ctx.moduli[:d]:
        raise ValueError("ks_tail: the key is not a Garner key whose "
                         "ciphertext moduli lead its own")
    _check_key("ks_tail", ksk, k, n, d)
    if not kernels.tail_fits(n):
        raise ValueError(f"ks_tail: degree {n} does not fit in shared memory")
    out = torch.empty((2,) + c2_pb.shape[:-2] + (k, n), dtype=torch.int64,
                      device=c2_pb.device)
    rows_k = c2_pb.numel() // (d * n) * k
    if rows_k == 0:
        return out
    tb = ctx.tables
    tw = tb.pass_twiddles(False)
    cluster, threads, _ = kernels.tail_plan(d, n)
    fn = kernels.function("ks_tail", "tpufhe_ks_tail", _KS_TAIL_ARGS)
    kernels.count("ks_tail")
    err = fn(kernels.ptr(c2_pb), kernels.ptr(out), rows_k, d, k, n, cluster,
             threads, kernels.ptr(ksk.c0), kernels.ptr(ksk.c0_shoup),
             kernels.ptr(ksk.c1), kernels.ptr(ksk.c1_shoup), kernels.ptr(tw),
             kernels.ptr(tb.p), kernels.ptr(tb.barrett_lo),
             kernels.ptr(tb.barrett_hi), kernels.stream())
    kernels.check(err, "ks_tail")
    return out


def ks_tail(ctx: Context, c2_pb: torch.Tensor, ksk) -> torch.Tensor:
    if c2_pb.device.type == "cuda":
        return ks_tail_cuda(ctx, c2_pb, ksk)
    if c2_pb.device.type != "cpu":
        raise ValueError(f"ks_tail: unsupported device {c2_pb.device}")
    return ks_tail_plain(ctx, c2_pb, ksk)


# ---------------------------------------------------------------------------
# The unfused tails: ks_accumulate (csrc/ks_accumulate.cu)
# ---------------------------------------------------------------------------

_KS_ACCUMULATE_ARGS = ([ctypes.c_void_p] * 4
                       + [ctypes.c_longlong] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p])


@uncounted
def ks_accumulate_plain(ctx: Context, lifted: torch.Tensor, ksk, add0=None,
                        add1=None) -> torch.Tensor:
    """NTT-domain digit rows (d, ..., k, N) (d = k Garner rows, or a
    single-modulus key's base-2^log_base digits) -> stacked (2, ..., k, N)
    (add0 + sum_i d_i ksk0_i, add1 + sum_i d_i ksk1_i), no add where an
    addend is None: _ksk_accumulate and the adds, the plain version of
    ks_accumulate."""
    ks0, ks1 = _ksk_accumulate(ctx, lifted, ksk)
    if add0 is not None:
        ks0 = ctx.add(add0, ks0)
    if add1 is not None:
        ks1 = ctx.add(add1, ks1)
    return torch.stack([ks0, ks1])


def ks_accumulate_cuda(ctx: Context, lifted: torch.Tensor, ksk, add0=None,
                       add1=None) -> torch.Tensor:
    """Launch ks_accumulate on the context's words (int64, or int32 for a
    narrow context), on whole rows or on a shard's coefficient block of
    them with the key's matching column block."""
    addends = [t for t in (add0, add1) if t is not None]
    kernels.require_cuda("ks_accumulate", ctx.dtype, lifted, ksk.c0,
                         ksk.c0_shoup, ksk.c1, ksk.c1_shoup, *addends)
    k, n, digits = ctx.k, lifted.shape[-1], ksk.c0.shape[0]
    if lifted.shape[0] != digits or lifted.shape[-2:] != (k, n):
        raise ValueError(f"ks_accumulate: shape {tuple(lifted.shape)}, "
                         f"expected ({digits}, ..., {k}, {n})")
    if any(t.shape != lifted.shape[1:] for t in addends):
        raise ValueError("ks_accumulate: addends must be "
                         f"{tuple(lifted.shape[1:])}")
    _check_key("ks_accumulate", ksk, k, n, digits)
    out = torch.empty((2,) + lifted.shape[1:], dtype=ctx.dtype,
                      device=lifted.device)
    plane = lifted[0].numel()
    if plane == 0:
        return out
    fn = kernels.function("ks_accumulate", "tpufhe_ks_accumulate",
                          _KS_ACCUMULATE_ARGS)
    kernels.count("ks_accumulate")
    err = fn(kernels.ptr(lifted),
             None if add0 is None else kernels.ptr(add0),
             None if add1 is None else kernels.ptr(add1), kernels.ptr(out),
             plane, digits, k, n, kernels.ptr(ksk.c0),
             kernels.ptr(ksk.c0_shoup),
             kernels.ptr(ksk.c1), kernels.ptr(ksk.c1_shoup),
             kernels.ptr(ctx.tables.p), lifted.element_size(),
             kernels.stream())
    kernels.check(err, "ks_accumulate")
    return out


def ks_accumulate(ctx: Context, lifted: torch.Tensor, ksk, add0=None,
                  add1=None) -> torch.Tensor:
    if lifted.device.type == "cuda":
        return ks_accumulate_cuda(ctx, lifted, ksk, add0, add1)
    if lifted.device.type != "cpu":
        raise ValueError(f"ks_accumulate: unsupported device {lifted.device}")
    return ks_accumulate_plain(ctx, lifted, ksk, add0, add1)


def relin_tail_unfused(ctx: Context, dsc: torch.Tensor, ksk,
                       ntt_fwd=ntt_forward):
    """What K4 computes, unfused: the decomposition rows of c2 (Garner, or
    a single-modulus key's digits), one forward NTT of the stacked (c0, c1,
    rows) and the accumulate with the two adds, as tpufhe merges them
    (pipeline.py:559-569). ntt_fwd: the transform (make_mul_relin's
    hook)."""
    digits = ksk_rows(ctx, dsc[2], ksk)
    ntts = ntt_fwd(ctx, torch.cat([dsc[:2], digits]))
    c0, c1 = ks_accumulate(ctx, ntts[2:], ksk, ntts[0], ntts[1])
    return c0, c1


def key_switch(ctx: Context, c2_pb: torch.Tensor, ksk, add0=None,
               add1=None) -> torch.Tensor:
    """(add0 + ks0, add1 + ks1) stacked, (ks0, ks1) the key switch of
    power-basis c2 (..., d, N) by a key over ctx (key_switching_key.rs:
    214-289 with the adds of relinearization_key.rs:71-98 and
    galois_key.rs:62-87). Either key mode. With no addends, a Garner key
    where the fused tails run (_fused_tail) and whose ciphertext moduli
    lead ctx's (d <= k: a key at or below the ciphertext's level) takes
    ks_tail, one launch; otherwise the forward NTT of the decomposition
    rows (K1, or K9 when narrow) and ks_accumulate."""
    if (add0 is None and add1 is None and c2_pb.shape[-2] <= ctx.k
            and _fused_tail(ctx, ksk)):
        return ks_tail(ctx, c2_pb.contiguous(), ksk)
    lifted = ntt_forward(ctx, ksk_rows(ctx, c2_pb, ksk))
    return ks_accumulate(ctx, lifted, ksk, add0, add1)


def key_switch_down(ctx: Context, c2_pb: torch.Tensor, ksk) -> torch.Tensor:
    """The key switch (ks0, ks1) of power-basis c2 (..., k, N) of ctx by a
    key in the larger context ksk.ctx_ksk, switched down to ctx and
    stacked (2, ..., k, N) in ctx's NTT domain (tpufhe
    _rotate_step_leveled, pipeline.py:784-812, and the switch-down of
    relinearization_key.rs:71-98 and galois_key.rs:62-87): key_switch in
    the key's context (c2's Garner digits reduced modulo every key
    modulus: ks_tail, or K1 and ks_accumulate where the fused tails do not
    run), K1 inverse, the switch-down (plain torch) and K1 forward. The
    key's extra moduli divide the key-switch noise."""
    ks_pb = _key_switch_up(c2_pb, ksk)
    return ntt_forward(ctx, switch_down_to(ksk.ctx_ksk, ctx, ks_pb))


def _key_switch_up(c2_pb: torch.Tensor, ksk) -> torch.Tensor:
    """key_switch_down's first half: the key switch in the key's context
    ksk.ctx_ksk and its K1 inverse, power-basis (2, ..., k_ksk, N)."""
    ctx_ksk = ksk.ctx_ksk
    return ntt_backward(ctx_ksk, key_switch(ctx_ksk, c2_pb, ksk))


def rotate_tail_unfused(ctx: Context, s0: torch.Tensor, c2_pb: torch.Tensor,
                        ksk):
    """What K5 computes, unfused: the forward NTT of c2's decomposition
    rows and the accumulate with the add of s0 (tpufhe pipeline.py:778-779,
    _key_switch_batched)."""
    c0, c1 = key_switch(ctx, c2_pb, ksk, s0)
    return c0, c1


def relinearize(ctx: Context, ksk, c0: torch.Tensor, c1: torch.Tensor,
                c2_pb: torch.Tensor) -> tuple:
    """(c0 + ks0, c1 + ks1) for NTT-domain c0, c1 and power-basis c2
    (relinearization_key.rs:71-98). A Garner key where kernels.tail_fits
    holds: K5 forms c0 + ks0 and ks1 (the rotate tail's computation on
    s0 = c0), then one add; otherwise key_switch with both adds."""
    c0, c1 = c0.contiguous(), c1.contiguous()  # a user's parts, kernel inputs
    if _fused_tail(ctx, ksk):
        r0, ks1 = rotate_tail(ctx, c0, c2_pb, ksk)
        return r0, ctx.add(c1, ks1)
    c = key_switch(ctx, c2_pb, ksk, c0, c1)
    return c[0], c[1]


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------


def _fused_tail(ctx: Context, ksk=None) -> bool:
    """Whether the programs over ctx run the fused kernels K3, K4 and K5:
    wide rows whose three rows of N words fit one block (K3's need; the
    tails follow the same route). The tails K4 and K5 form Garner digits,
    so a single-modulus key (ksk.log_base) takes the unfused tail."""
    if ksk is not None and ksk.log_base:
        return False
    return not ctx.narrow and kernels.tail_fits(ctx.degree)


@dataclass(frozen=True)
class MulBasis:
    """The multiplication basis of one level and the scalers of a product:
    ``ext`` q -> the basis's new limbs (factor 1), ``rhs`` q -> the whole
    basis (factor P/q, strategy 2 only) and ``down`` the basis -> q
    (factor t/q, or t/P for strategy 2)."""

    ctx_mul: Context
    ext: RnsScaler
    rhs: RnsScaler | None
    down: RnsScaler


def mul_basis(par: BfvParameters, level: int = 0,
              strategy2_primes: int | None = None) -> MulBasis:
    """The default basis of mul_params, or strategy 2's q + P with P the
    product of `strategy2_primes` 62-bit primes == 1 mod 2N taken downward
    from 2^62, skipping the ciphertext moduli (tpufhe pipeline.py:458-471)."""
    ctx_lvl = par.context_level_at(level)
    ctx = ctx_lvl.poly_context
    if strategy2_primes is None:
        mp = ctx_lvl.mul_params()
        assert mp.extender.number_common_moduli == ctx.k
        return MulBasis(mp.to_ctx, mp.extender.rns_scaler, None,
                        mp.down_scaler.rns_scaler)
    if ctx.narrow:
        # tpufhe builds a wide 62-bit basis here, which its narrow scaler
        # cannot target (pipeline.py:458-466, rns.py:456)
        raise UnsupportedOperation(
            "strategy 2 is not defined for narrow (w30) parameters")
    basis = list(ctx.moduli)
    upper = 1 << 62
    p_prod = 1
    while len(basis) != ctx.k + strategy2_primes:
        upper = generate_prime(62, 2 * par.degree(), upper)
        if upper not in basis:
            basis.append(upper)
            p_prod *= upper
    ctx_mul = Context(tuple(basis), par.degree(), ctx.device)
    return MulBasis(
        ctx_mul,
        Scaler(ctx, ctx_mul, ScalingFactor.one()).rns_scaler,
        Scaler(ctx, ctx_mul, ScalingFactor(p_prod, ctx.modulus())).rns_scaler,
        Scaler(ctx_mul, ctx,
               ScalingFactor(par.plaintext.value, p_prod)).rns_scaler)


def _key_block(ksk, const_slice) -> SimpleNamespace:
    """The key's four tables cut by const_slice (a shard's column block,
    contiguous), with its decomposition mode."""
    return SimpleNamespace(log_base=ksk.log_base, **{
        name: const_slice(getattr(ksk, name)).contiguous()
        for name in ("c0", "c0_shoup", "c1", "c1_shoup")})


def make_mul_relin(par: BfvParameters, rk, level: int = 0,
                   strategy2_primes: int | None = None,
                   ext_fuse: bool = False, ntt_fwd=None, ntt_bwd=None,
                   const_slice=None):
    """(a0, a1, b0, b1) -> (c0, c1): multiply + relinearize
    (ops/mod.rs:259-341 then key_switching_key.rs:214-241). Inputs are
    NTT-domain (..., k, N) parts of two ciphertext batches.

    The hooks of tpufhe's build_mul_relin_step (pipeline.py:411-413):
    ntt_fwd(ctx, x, limb_slice=None) and ntt_bwd(ctx, x) replace every
    forward and inverse transform of the step, const_slice(arr) cuts each
    per-coefficient constant (the key's (digits, k, N) tables) to the
    columns the step's rows hold, once, when the program is built. A given
    hook turns the fused kernels off, as in tpufhe (pipeline.py:477, 485,
    497): the step takes the unfused route (K7, the inverse, K2, one
    forward of the stacked (c0, c1, digits) and ks_accumulate), and
    ext_fuse raises UnsupportedOperation. parallel/seq_pipeline.py gives
    the distributed transforms here.

    strategy2_primes=kP selects the second HPS strategy of eprint 2021/204
    over q + P (see mul_basis). ext_fuse=True runs each extend as one K8
    launch; it raises UnsupportedOperation where intt_scale_fits is false.
    Launches per step: default 6 (ntt 2, rns_scale 2, tensor_intt 1,
    relin_tail 1), fused 5; strategy 2 split 8 (ntt 3, rns_scale 3), fused
    7 (intt_scale 2, ntt 2, rns_scale 1). Where kernels.tail_fits is false
    (N = 16384) K7 + K1 inverse and K1 forward + ks_accumulate replace K3
    and K4: default 8 (ntt 4, rns_scale 2, tensor 1, ks_accumulate 1).

    On narrow (w30) parameters the default strategy runs as tpufhe's narrow
    composition (pipeline.py:509-569 with its tail, tensor+iNTT and fused
    extend kernels off): K9 inverse, K2 extend, K9 forward of the new
    limbs, tensor32, K9 inverse over the basis, K2 down-scale, then
    relin_tail_unfused (one K9 forward, ks_accumulate): ntt32 4,
    rns_scale 2, ks_accumulate 1. Strategy 2 and ext_fuse raise UnsupportedOperation there
    (K8 is a wide kernel).

    A step is a ``mul_relin`` span holding two device-timed spans, the
    stages the route rule (kernels.tail_fits) chooses between, on every
    route: ``mul_relin.tensor``, the tensor product and its inverse NTT
    (K3 fused; K7 and the K1 inverse over the basis unfused), and
    ``mul_relin.relin``, the tail (K4 fused; the decomposition rows, one K1
    forward of the stacked rows and ks_accumulate unfused). The extend and
    the down-scale lie outside both."""
    ctx = par.context_at_level(level)
    ksk = rk.ksk
    assert ksk.ciphertext_level == level and ksk.ksk_level == level
    if ext_fuse and ctx.narrow:
        raise UnsupportedOperation(
            "the fused extend is not defined for narrow (w30) parameters")
    mb = mul_basis(par, level, strategy2_primes)
    ctx_mul = mb.ctx_mul
    k, k_mul = ctx.k, ctx_mul.k
    if ext_fuse and not intt_scale_fits(k, ctx.degree):
        raise UnsupportedOperation(
            f"the fused extend does not take {k} limbs of degree {ctx.degree}")
    hooked = not (ntt_fwd is None and ntt_bwd is None and const_slice is None)
    if hooked and ext_fuse:
        raise UnsupportedOperation("the fused extend takes no transform hooks")
    fwd = ntt_forward if ntt_fwd is None else ntt_fwd
    bwd = ntt_backward if ntt_bwd is None else ntt_bwd
    fused = _fused_tail(ctx) and not hooked
    key = ksk if const_slice is None else _key_block(ksk, const_slice)
    if hooked:
        tail = partial(relin_tail_unfused, ntt_fwd=fwd)
    else:
        tail = relin_tail if _fused_tail(ctx, ksk) else relin_tail_unfused
    square = tensor32 if ctx.narrow else tensor

    def new_limbs(x, x_pb):
        """The extend's new limbs k .. k_mul of x in the NTT domain, from
        the power basis x_pb unless the extend is fused."""
        if not ext_fuse:
            return scale_into(ctx_mul, mb.ext, x_pb, k, k_mul - k, ntt=True,
                              ntt_fwd=fwd)
        rows = intt_scale(ctx, mb.ext, x, k, k_mul - k)
        return ntt_forward(ctx_mul, rows, limb_slice=slice(k, k_mul))

    @obs.span("mul_relin")
    def step(a0, a1, b0, b1):
        x = torch.stack([a0, a1, b0, b1])  # (4, ..., k, N)
        x_pb = None if ext_fuse else bwd(ctx, x)
        # extend to the multiplication basis (ops/mod.rs:307-317)
        if mb.rhs is None:
            ext = torch.cat([x, new_limbs(x, x_pb)], dim=-2)
        else:
            # strategy 2: the lhs extends exactly, the rhs is scaled by P/q
            # into every limb of the basis
            lhs_pb = None if x_pb is None else x_pb[:2]
            lhs = torch.cat([x[:2], new_limbs(x[:2], lhs_pb)], dim=-2)
            if ext_fuse:
                rhs = intt_scale(ctx, mb.rhs, x[2:], 0, k_mul)
            else:
                rhs = mb.rhs.scale(x_pb[2:], starting_index=0, size=k_mul)
            ext = torch.cat([lhs, fwd(ctx_mul, rhs)])
        # tensor product + inverse NTT, the down-scale, then the tail
        with obs.span("mul_relin.tensor", device=True):
            if fused:
                t_pb = tensor_intt(ctx_mul, ext)
            else:
                t_pb = bwd(ctx_mul, square(ctx_mul, *ext))
        dsc = mb.down.scale(t_pb, starting_index=0, size=k)
        with obs.span("mul_relin.relin", device=True):
            return tail(ctx, dsc, key)

    return step


def make_square_relin(par: BfvParameters, rk, level: int = 0):
    """(a0, a1) -> (c0, c1): square + relinearize (tpufhe
    pipeline.py:584-621) in seven launches: K1 inverse of (a0, a1), K2
    extend, K1 forward of the new limbs, K7 on (a0, a1, a0, a1), K1 inverse
    of the three parts over k_mul, K2 down-scale, then the K4 tail (the
    function of tpufhe's forward NTT + accumulate + adds there). Where
    kernels.tail_fits is false, relin_tail_unfused takes K4's place: ntt 4,
    rns_scale 2, tensor 1, ks_accumulate 1. On narrow parameters tensor32
    and relin_tail_unfused take the places of K7 and K4: ntt32 4,
    rns_scale 2, ks_accumulate 1."""
    ctx = par.context_at_level(level)
    ksk = rk.ksk
    assert ksk.ciphertext_level == level and ksk.ksk_level == level
    mb = mul_basis(par, level)
    ctx_mul = mb.ctx_mul
    k, k_mul = ctx.k, ctx_mul.k
    square = tensor32 if ctx.narrow else tensor
    tail = relin_tail if _fused_tail(ctx, ksk) else relin_tail_unfused

    def step(a0, a1):
        x = torch.stack([a0, a1])
        new_rows = scale_into(ctx_mul, mb.ext, ntt_backward(ctx, x), k,
                              k_mul - k, ntt=True)
        ext = torch.cat([x, new_rows], dim=-2)
        t = square(ctx_mul, ext[0], ext[1], ext[0], ext[1])
        dsc = mb.down.scale(ntt_backward(ctx_mul, t), starting_index=0, size=k)
        return tail(ctx, dsc, ksk)

    return step


def make_decrypt_phase(par: BfvParameters, sk, level: int = 0):
    """(c0, c1) -> plaintext-context residues (..., k_plain, N) in power
    basis: the phase c0 + c1 s, its inverse NTT and the t/q scaling. The
    small mod-t fold stays with the caller (secret_key.rs:233-260)."""
    ctx = par.context_at_level(level)
    scaler = par.context_level_at(level).cipher_plain_context.scaler
    s = sk.s_ntt(ctx).clone()  # SecretKey.zeroize scrubs the key's own copy

    def step(c0, c1):
        phase = ctx.add(c0, ctx.mul(c1, s))
        return scaler.rns_scaler.scale(ntt_backward(ctx, phase))

    return step


def make_encrypt_with_seed_expansion(par: BfvParameters, sk, level: int = 0):
    """(a, e, m) -> b = NTT(e) - a s + m, with a the seed-expanded uniform
    part (NTT domain), e the power-basis error and m the NTT-domain message
    (secret_key.rs:102-137)."""
    ctx = par.context_at_level(level)
    s = sk.s_ntt(ctx).clone()  # SecretKey.zeroize scrubs the key's own copy

    def step(a, e_pb, m):
        e = ntt_forward(ctx, e_pb)
        return ctx.add(ctx.sub(e, ctx.mul(a, s)), m)

    return step


def make_pk_encrypt(par: BfvParameters, level: int = 0):
    """(u, e1, e2, m, pk0, pk1) -> (u pk0 + e1 + m, u pk1 + e2): the
    public-key encryption core (public_key.rs:24-37, tpufhe
    pipeline.py:677-697), the three power-basis samples forward-NTT'd in
    one launch (K1, or K9 when narrow); m and the key in the NTT domain."""
    ctx = par.context_at_level(level)

    def step(u_pb, e1_pb, e2_pb, m, pk0, pk1):
        u, e1, e2 = ntt_forward(ctx, torch.stack([u_pb, e1_pb, e2_pb]))
        c0 = ctx.add(ctx.add(ctx.mul(u, pk0), e1), m)
        return c0, ctx.add(ctx.mul(u, pk1), e2)

    return step


def make_add(par: BfvParameters, level: int = 0):
    """(a0, a1, b0, b1) -> (a0 + b0, a1 + b1) of NTT-domain parts (tpufhe
    pipeline.py:1165-1173)."""
    ctx = par.context_at_level(level)

    def step(a0, a1, b0, b1):
        return ctx.add(a0, b0), ctx.add(a1, b1)

    return step


def make_ct_pt_dot(par: BfvParameters, n: int, m: int, level: int = 0):
    """(e0, e1, db) -> (r0, r1), r_p[j] = sum_{i < n} db[i, j] e_p[i]: m
    ciphertext x plaintext dot products over n terms (tpufhe
    pipeline.py:1091-1162), one ct_pt_dot launch. e0, e1: (>= n, B, k, N)
    NTT-domain parts; db: (n, m, k, N) plaintext NTT residues; returns two
    (m, B, k, N) tensors. Raises NotImplementedError on narrow parameters,
    as tpufhe does."""
    ctx = par.context_at_level(level)
    if ctx.narrow:
        raise NotImplementedError("narrow (w30) ct-pt dot path")

    def step(e0, e1, db):
        if tuple(db.shape[:2]) != (n, m):
            raise ValueError(f"make_ct_pt_dot: db shape {tuple(db.shape)}, "
                             f"expected ({n}, {m}, ...)")
        r = ct_pt_dot(ctx, [e0, e1], db)
        return r[0], r[1]

    return step


def _rotate_step(ctx: Context, exp: SubstitutionExponent, ksk):
    """(c0, c1) -> the Galois-rotated ciphertext (galois_key.rs:62-87):
    substitute both parts, inverse NTT of the substituted c1 (K1), then
    the key switch and the add of the substituted c0 (K5). Where K5 does
    not fit (kernels.tail_fits false) and on a narrow context, the key
    switch is tpufhe's unfused composition (_key_switch_batched,
    pipeline.py:778-779): the Garner digits, their forward NTT (K1, or K9
    when narrow) and ks_accumulate. A key below the ciphertext's level
    (a larger context) takes key_switch_down, unfused, as K5 takes a key
    of the ciphertext's context only (tpufhe _rotate_step_leveled):
    ntt 4, ks_accumulate 1."""
    keyswitch, down, finish = _rotate_stages(ctx, exp, ksk)

    def rot(c0, c1):
        return finish(down(keyswitch(c0, c1)))

    return rot


def _same(state):
    return state


def _rotate_stages(ctx: Context, exp: SubstitutionExponent, ksk) -> tuple:
    """_rotate_step in three stages, (c0, c1) -> keyswitch -> down ->
    finish -> the rotated (c0, c1), which make_expand times apart. A
    leveled key: keyswitch substitutes both parts and runs the K1 inverse,
    key_switch_down's key switch and its K1 inverse; down is its
    switch-down; finish its K1 forward and the add of the substituted c0.
    Otherwise keyswitch is the whole rotation, and down and finish pass it
    on."""
    if ksk.ctx_ciphertext is not ctx:
        raise ValueError(f"rotation: the key is for {ksk.ctx_ciphertext}, "
                         f"not {ctx}")
    if ksk.ksk_level != ksk.ciphertext_level:
        def keyswitch(c0, c1):
            s0 = substitute(c0, exp, ntt=True)
            c2_pb = ntt_backward(ctx, substitute(c1, exp, ntt=True))
            return s0, _key_switch_up(c2_pb, ksk)

        def down(state):
            return state[0], switch_down_to(ksk.ctx_ksk, ctx, state[1])

        def finish(state):
            ks = ntt_forward(ctx, state[1])
            return ctx.add(state[0], ks[0]), ks[1]

        return keyswitch, down, finish
    tail = rotate_tail if _fused_tail(ctx, ksk) else rotate_tail_unfused

    def rot(c0, c1):
        s0 = substitute(c0, exp, ntt=True)
        c2_pb = ntt_backward(ctx, substitute(c1, exp, ntt=True))
        return tail(ctx, s0, c2_pb, ksk)

    return rot, _same, _same


def make_rotate(par: BfvParameters, gk, level: int = 0):
    """(c0, c1) -> Galois rotation of NTT-domain (..., k, N) parts by the
    key's element: two launches per call, K1 then K5. Where
    kernels.tail_fits is false: ntt 2, ks_accumulate 1; on narrow
    parameters ntt32 2, ks_accumulate 1."""
    return _rotate_step(par.context_at_level(level), gk.element, gk.ksk)


def make_inner_sum(par: BfvParameters, ek, level: int = 0):
    """(c0, c1) -> inner sum: log2(N/2) column rotations then the row
    rotation, each followed by an add (evaluation_key.rs:56-82). Spans:
    ``inner_sum``, with a ``rotate`` for each rotation and its adds."""
    if not ek.supports_inner_sum():
        raise UnsupportedOperation("This key does not support the inner sum")
    ctx = par.context_at_level(level)
    n = par.degree()
    exps = [ek.rot_to_gk_exponent[1 << i] for i in range(n.bit_length() - 2)]
    rots = [_rotate_step(ctx, ek.gk[e].element, ek.gk[e].ksk)
            for e in exps + [2 * n - 1]]

    def step(c0, c1):
        with obs.span("inner_sum"):
            for rot in rots:
                with obs.span("rotate"):
                    r0, r1 = rot(c0, c1)
                    c0, c1 = ctx.add(c0, r0), ctx.add(c1, r1)
        return c0, c1

    return step


def make_expand(par: BfvParameters, ek, level_count: int, level: int = 0):
    """Oblivious expansion (Angel et al., evaluation_key.rs:153-193) into
    2^level_count ciphertexts: at doubling level l all 2^l live ciphertexts
    rotate in one batched step, and the monomial x^{-2^l} fold is one
    Shoup multiply. (c0, c1) of shape (B, k, N) -> a pair of
    (2^level_count, B, k, N) tensors, equal to EvaluationKey.expands.
    Each rotation takes its key's route (_rotate_step): leveled keys, as
    MulPIR builds them, key-switch in their larger context and switch
    back down (tpufhe build_expand_step, pipeline.py:843-885). On narrow
    parameters the rows are int32: a doubling runs ntt32 2 and
    ks_accumulate 1 (ntt32 4 with a leveled key), and the fold's Shoup
    product takes the monomials' shoup32 constants.

    Spans: ``expand`` (device-timed) holds one ``expand.doubling`` a level,
    tiled by its three device-timed stages: ``keyswitch`` (the rotation's
    substitutions, K1 inverse, key switch and, with a leveled key, its K1
    inverse), ``switch_down`` (the leveled key's switch-down) and ``fold``
    (the leveled key's K1 forward and add, then the fold's subtractions,
    Shoup products by the monomial, adds and ``cat``)."""
    ctx = par.context_at_level(level)
    if not ek.supports_expansion(level_count):
        raise UnsupportedOperation(
            "This key does not support expansion at this level")
    n = par.degree()
    levels = []
    for l in range(level_count):
        gk = ek.gk[(n >> l) + 1]
        mono, mono_shoup = ek.monomials[l]
        levels.append((_rotate_stages(ctx, gk.element, gk.ksk), mono,
                       mono_shoup))

    def step(c0, c1):
        with obs.span("expand", device=True):
            cur0, cur1 = c0[None], c1[None]
            for (keyswitch, down, finish), mono, mono_shoup in levels:
                with obs.span("expand.doubling"):
                    with obs.span("keyswitch", device=True):
                        state = keyswitch(cur0, cur1)
                    with obs.span("switch_down", device=True):
                        state = down(state)
                    with obs.span("fold", device=True):
                        sub0, sub1 = finish(state)
                        new0 = ctx.mul_shoup(ctx.sub(cur0, sub0), mono,
                                             mono_shoup)
                        new1 = ctx.mul_shoup(ctx.sub(cur1, sub1), mono,
                                             mono_shoup)
                        cur0 = torch.cat([ctx.add(cur0, sub0), new0])
                        cur1 = torch.cat([ctx.add(cur1, sub1), new1])
        return cur0, cur1

    return step


# ---------------------------------------------------------------------------
# MulPIR server response (examples/mulpir.rs:163-183)
# ---------------------------------------------------------------------------


def encode_pir_database(par: BfvParameters, values, encoding: Encoding
                        ) -> torch.Tensor:
    """Plaintext rows (..., N) of values in [0, t) (numpy uint64 or an int64
    tensor) -> their NTT residues (..., k, N) at the encoding's level, each
    row equal to Plaintext.try_encode(row, encoding, par).poly_ntt, all rows
    in one batched lift and forward NTT (K1): the database of the PIR
    programs. SIMD rows are first permuted into the slots and inverse-
    transformed over t (K1), as PlaintextVec.try_encode does."""
    ctx = par.context_at_level(encoding.level)
    if isinstance(values, np.ndarray):
        values = torch.from_numpy(zq.as_int64(values.astype(np.uint64)))
    v = values.to(device=ctx.device, dtype=torch.int64)
    if v.shape[-1] != ctx.degree:
        raise ValueError(f"encode_pir_database: rows of {v.shape[-1]} values, "
                         f"expected {ctx.degree}")
    if encoding.encoding == SIMD:
        if par.ntt_operator is None:
            raise SimdNotSupported("no plaintext NTT for these parameters")
        slots = torch.empty_like(v)
        slots[..., torch.from_numpy(par.matrix_reps_index_map).to(v.device)] = v
        v = ntt_backward(par.ntt_operator, slots[..., None, :])[..., 0, :]
    rows = torch.remainder(v[..., None, :], ctx.mod.p).to(ctx.dtype)
    return ntt_forward(ctx, rows)


def _second_dimension(ctx_mul: Context, ext: torch.Tensor) -> torch.Tensor:
    """sum_j sel_j (x) resp_j in the NTT domain of the multiplication basis,
    (3, B, k_mul, N): ext is (4, dim2, B, k_mul, N) in the order (s1, s0,
    r0, r1), so every operand is a view with the batch folded into the
    rows. Row 0 = sum_j s0_j r0_j and row 2 = sum_j s1_j r1_j are dot
    products of dim2 terms, row 1 = sum_j s1_j r0_j + s0_j r1_j one of
    2 dim2 terms: three ct_pt_dot launches. The residues are canonical, so
    the sums equal tpufhe's deferred 128-bit ones (pipeline.py:1060-1075)."""
    d2, n = ext.shape[1], ctx_mul.degree
    s1, s0, r0, r1 = (x.reshape(d2, 1, -1, n) for x in ext)
    pairs = ((s0, r0), (ext[:2].reshape(2 * d2, 1, -1, n),
                        ext[2:].reshape(2 * d2, 1, -1, n)), (s1, r1))
    rows = [ct_pt_dot(ctx_mul, [e], d)[0, 0, 0] for e, d in pairs]
    return torch.stack(rows).reshape((3,) + ext.shape[2:])


def make_pir_response_db(par: BfvParameters, rk, dim1: int, dim2: int,
                         level: int = 0):
    """(e0, e1, db) -> (c0, c1): the MulPIR server response on an expanded
    query (tpufhe pipeline.py:974-1088). e0, e1: (>= dim1 + dim2, B, k, N)
    NTT-domain parts from make_expand; db: (dim1, dim2, k, N) plaintext NTT
    residues (encode_pir_database). Launches per call:

    - the first dimension, resp_j = sum_i db[i, j] exp_i: one ct_pt_dot
      of both parts over all dim2 columns;
    - the extend of the selectors exp_{dim1 + j} and the responses into
      the multiplication basis: K1 inverse, K2, K1 forward of the new
      limbs (scale_into);
    - the second dimension, sum_j sel_j (x) resp_j, summed in the
      multiplication basis before the one down-scale: three ct_pt_dot
      (_second_dimension);
    - the down-scale (K1 inverse, K2) and one relinearization: K4 where
      kernels.tail_fits holds, else K1 forward + ks_accumulate.

    The relinearization key is at the ciphertexts' level. Raises
    NotImplementedError on narrow parameters, as tpufhe does. Spans:
    ``pir_response`` (device-timed), with a child for each of the five
    stages above."""
    ctx = par.context_at_level(level)
    if ctx.narrow:
        raise NotImplementedError("narrow (w30) PIR response path")
    ksk = rk.ksk
    assert ksk.ciphertext_level == level and ksk.ksk_level == level
    mb = mul_basis(par, level)
    ctx_mul = mb.ctx_mul
    k, k_mul = ctx.k, ctx_mul.k
    tail = relin_tail if _fused_tail(ctx, ksk) else relin_tail_unfused

    def step(e0, e1, db):
        if e0.shape[0] < dim1 + dim2 or tuple(db.shape[:2]) != (dim1, dim2):
            raise ValueError(f"make_pir_response_db: {e0.shape[0]} expanded "
                             f"ciphertexts and db {tuple(db.shape)} for dims "
                             f"({dim1}, {dim2})")
        with obs.span("pir_response", device=True):
            with obs.span("pir_response.dim1"):
                resp = ct_pt_dot(ctx, [e0, e1], db)  # (2, dim2, B, k, N)
            with obs.span("pir_response.extend"):
                sel = torch.stack([e1[dim1:dim1 + dim2],
                                   e0[dim1:dim1 + dim2]])
                both = torch.cat([sel, resp])  # (s1, s0, r0, r1)
                new_rows = scale_into(ctx_mul, mb.ext,
                                      ntt_backward(ctx, both), k, k_mul - k,
                                      ntt=True)
            with obs.span("pir_response.dim2"):
                t = _second_dimension(ctx_mul,
                                      torch.cat([both, new_rows], dim=-2))
            with obs.span("pir_response.down_scale"):
                dsc = mb.down.scale(ntt_backward(ctx_mul, t),
                                    starting_index=0, size=k)
            with obs.span("pir_response.relin"):
                return tail(ctx, dsc, ksk)

    return step


def make_pir_response(par: BfvParameters, ek, rk, db: torch.Tensor,
                      dim1: int, dim2: int, level: int = 0):
    """(c0, c1) -> (c0, c1): the MulPIR server response to a query of
    shape (B, k, N) (tpufhe pipeline.py:891-971): make_expand into
    2^L ciphertexts, L = bit length of dim1 + dim2 - 1, then
    make_pir_response_db on the database `db` (dim1, dim2, k, N), held by
    the step on the parameters' device."""
    respond = make_pir_response_db(par, rk, dim1, dim2, level)
    expand = make_expand(par, ek, (dim1 + dim2 - 1).bit_length(), level)
    db = db.to(par.device)

    def step(c0, c1):
        return respond(*expand(c0, c1), db)

    return step
