"""The inverse NTT fused with the HPS scale (kernel K8), the counterpart of
tpufhe/ops/pallas/intt_scale_kernel.py.

``intt_scale(ctx, scaler, x, starting_index, size)`` equals
``scaler.scale(ntt_backward(ctx, x), starting_index, size)``: NTT-domain
(..., k_in, N) residues of ``ctx`` in, power-basis (..., size, N) residues
of the scaler's ``to`` basis out. On the card it is one launch of
csrc/intt_scale.cu, a cluster of CTAs per batch row that together hold the
row's k_in limbs in shared memory (``kernels.intt_scale_plan``); where they
do not fit, ``intt_scale_fits`` is false and the caller must not ask for
the fused form (tpufhe falls back to the split launches there; the port
refuses instead).
"""

from __future__ import annotations

import ctypes

import torch

from tpufhe_torch import kernels
from tpufhe_torch.ops.ntt import backward_plain
from tpufhe_torch.ops.rns import RnsScaler
from tpufhe_torch.utils.obs import uncounted

_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
          ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
         + [ctypes.c_void_p])


def intt_scale_fits(k_in: int, n: int) -> bool:
    """Whether K8 takes k_in limbs of degree n: a row's k_in n words must
    fit in one block's shared memory (3 x 8192 words do, 4 do not), the
    rule of K8's first design, which held a row in one block; the route
    stays as tpufhe's."""
    return 1 <= k_in and k_in * n * 8 <= kernels.SMEM_BYTES


@uncounted
def intt_scale_plain(ctx, scaler: RnsScaler, x: torch.Tensor,
                     starting_index: int, size: int) -> torch.Tensor:
    """The plain version of K8: the plain inverse NTT, then the plain scaler."""
    tb = ctx.tables
    return scaler.scale_plain(backward_plain(x, tb.zetas_inv, tb.ninv, tb.mod),
                              starting_index, size)


def _check(ctx, scaler: RnsScaler, x: torch.Tensor, starting_index: int,
           size: int) -> None:
    k, n = ctx.k, ctx.degree
    if x.shape[-2:] != (k, n):
        raise ValueError(f"intt_scale: shape {tuple(x.shape)}, expected "
                         f"(..., {k}, {n})")
    if tuple(scaler.from_ctx.moduli_u64) != tuple(ctx.moduli):
        raise ValueError("intt_scale: the scaler's input basis is not ctx's")
    scaler.check_rows(x, starting_index, size)


def intt_scale_cuda(ctx, scaler: RnsScaler, x: torch.Tensor,
                    starting_index: int, size: int) -> torch.Tensor:
    """Launch K8."""
    kernels.require_cuda("intt_scale", torch.int64, x)
    _check(ctx, scaler, x, starting_index, size)
    k, n = ctx.k, ctx.degree
    if not intt_scale_fits(k, n):
        raise ValueError(f"intt_scale: {k} limbs of degree {n} do not fit in "
                         f"shared memory")
    if x.data_ptr() % 16:
        raise ValueError("intt_scale: rows are not 16-byte aligned")
    y = torch.empty(x.shape[:-2] + (size, n), dtype=torch.int64,
                    device=x.device)
    rows = x.numel() // (k * n)
    if rows == 0 or size == 0:
        return y
    tb = ctx.tables
    cluster, threads, _ = kernels.intt_scale_plan(k, n)
    tz = tb.pass_twiddles(True, split=kernels.intt_scale_split(k, n))
    fn = kernels.function("intt_scale", "tpufhe_intt_scale", _ARGS)
    host = scaler.table_host(starting_index, size)
    tab = scaler.table(x.device, starting_index, size)
    kernels.count("intt_scale")
    err = fn(kernels.ptr(x), kernels.ptr(y), rows, k, n, kernels.ptr(tz),
             kernels.ptr(tb.p), kernels.ptr(tb.ninv), kernels.ptr(tb.ninv_shoup),
             kernels.ptr(tab), ctypes.c_void_p(host.ctypes.data), host.size,
             size, scaler.theta_garner_shift, int(scaler.factor.is_one),
             int(scaler.theta_gamma_sign), cluster, threads, kernels.stream())
    kernels.check(err, "intt_scale")
    return y


def intt_scale(ctx, scaler: RnsScaler, x: torch.Tensor, starting_index: int,
               size: int) -> torch.Tensor:
    """rns_scale(ntt_backward(x)) on ctx's (..., k, N) NTT-domain rows."""
    _check(ctx, scaler, x, starting_index, size)
    if x.device.type == "cuda":
        return intt_scale_cuda(ctx, scaler, x, starting_index, size)
    if x.device.type != "cpu":
        raise ValueError(f"intt_scale: unsupported device {x.device}")
    return intt_scale_plain(ctx, scaler, x, starting_index, size)
