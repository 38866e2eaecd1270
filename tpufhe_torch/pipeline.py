"""End-to-end BFV programs over raw coefficient tensors: the fused
multiply + relinearize (default HPS strategy), and the encryption and
decryption cores. The port of the matching parts of tpufhe/pipeline.py.

A mul+relin step runs six kernel launches, in tpufhe's structure
(pipeline.py:509-569):

1. K1 inverse NTT of the four input parts (k limbs);
2. K2 extend: HPS conversion by 1 into the k_mul - k new limbs;
3. K1 forward NTT of the new limbs (limb_slice = k .. k_mul);
4. K3 tensor product + inverse NTT over the k_mul-limb basis;
5. K2 down-scale by t/q into the k ciphertext limbs;
6. K4 relin tail: forward NTT of c0, c1 and the Garner digits of c2,
   key-switch accumulate, and the two adds.

Tensors are int64 (..., k, N) on the parameters' device; leading dimensions
are the batch. K3 and K4 sit in this module beside their plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from tpufhe_torch import kernels
from tpufhe_torch.bfv.parameters import BfvParameters
from tpufhe_torch.ops import zq
from tpufhe_torch.ops.ntt import backward_plain, forward_plain
from tpufhe_torch.ops.rq import Context, ntt_backward, ntt_forward

# ---------------------------------------------------------------------------
# Key-switch helpers (plain torch glue)
# ---------------------------------------------------------------------------


def _ksk_digits(ctx: Context, c2_pb: torch.Tensor) -> torch.Tensor:
    """Garner decomposition rows of power-basis c2 (..., k, N): row i is
    c2's limb i reduced modulo every limb modulus p_j, canonical.
    Returns (k, ..., k, N)."""
    rows = torch.movedim(c2_pb, -2, 0)[..., None, :]  # (k, ..., 1, N)
    return torch.remainder(rows, ctx.mod.p)


def _ksk_accumulate(ctx: Context, lifted: torch.Tensor, ksk):
    """sum_i d_i ksk.c{0,1}_i with Shoup products on NTT-domain rows
    (key_switching_key.rs:227-239); the plain version of K4's
    accumulate."""
    mod = ctx.mod
    acc0 = acc1 = None
    for i in range(ksk.c0.shape[0]):
        t0 = zq.mul_shoup(lifted[i], ksk.c0[i], ksk.c0_shoup[i], mod)
        t1 = zq.mul_shoup(lifted[i], ksk.c1[i], ksk.c1_shoup[i], mod)
        acc0 = t0 if acc0 is None else zq.add(acc0, t0, mod)
        acc1 = t1 if acc1 is None else zq.add(acc1, t1, mod)
    return acc0, acc1


# ---------------------------------------------------------------------------
# K3: tensor product + inverse NTT (csrc/tensor_intt.cu)
# ---------------------------------------------------------------------------

_TENSOR_INTT_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8


def tensor_intt_plain(ctx_mul: Context, ext: torch.Tensor) -> torch.Tensor:
    """(4, ..., k, N) NTT-domain (a0, a1, b0, b1) -> (3, ..., k, N) power
    basis (a0 b0, a0 b1 + a1 b0, a1 b1), the plain version of K3."""
    mod = ctx_mul.mod
    tb = ctx_mul.tables
    a0, a1, b0, b1 = ext[0], ext[1], ext[2], ext[3]
    c0 = zq.mul(a0, b0, mod)
    c1 = zq.add(zq.mul(a0, b1, mod), zq.mul(a1, b0, mod), mod)
    c2 = zq.mul(a1, b1, mod)
    return backward_plain(torch.stack([c0, c1, c2]), tb.zetas_inv, tb.ninv, mod)


def tensor_intt_cuda(ctx_mul: Context, ext: torch.Tensor) -> torch.Tensor:
    """Launch K3."""
    kernels.require_cuda_int64("tensor_intt", ext)
    k, n = ctx_mul.k, ctx_mul.degree
    if ext.shape[0] != 4 or ext.shape[-2:] != (k, n):
        raise ValueError(f"tensor_intt: shape {tuple(ext.shape)}, expected "
                         f"(4, ..., {k}, {n})")
    if 3 * n * 8 > kernels.SMEM_BYTES:
        raise ValueError(f"tensor_intt: degree {n} does not fit in shared memory")
    out = torch.empty((3,) + ext.shape[1:], dtype=torch.int64, device=ext.device)
    rows_k = ext[0].numel() // n
    if rows_k == 0:
        return out
    tb = ctx_mul.tables
    fn = kernels.function("tensor_intt", "tpufhe_tensor_intt", _TENSOR_INTT_ARGS)
    kernels.count("tensor_intt")
    err = fn(kernels.ptr(ext), kernels.ptr(out), rows_k, k, n,
             kernels.ptr(tb.zetas_inv), kernels.ptr(tb.zetas_inv_shoup),
             kernels.ptr(tb.p), kernels.ptr(tb.barrett_lo),
             kernels.ptr(tb.barrett_hi), kernels.ptr(tb.ninv),
             kernels.ptr(tb.ninv_shoup), kernels.stream())
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

_RELIN_TAIL_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10


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
    kernels.require_cuda_int64("relin_tail", dsc, ksk.c0, ksk.c0_shoup,
                               ksk.c1, ksk.c1_shoup)
    k, n = ctx.k, ctx.degree
    if dsc.shape[0] != 3 or dsc.shape[-2:] != (k, n):
        raise ValueError(f"relin_tail: shape {tuple(dsc.shape)}, expected "
                         f"(3, ..., {k}, {n})")
    for t in (ksk.c0, ksk.c0_shoup, ksk.c1, ksk.c1_shoup):
        if tuple(t.shape) != (k, k, n):
            raise ValueError(f"relin_tail: key shape {tuple(t.shape)}, "
                             f"expected ({k}, {k}, {n})")
    if 3 * n * 8 > kernels.SMEM_BYTES:
        raise ValueError(f"relin_tail: degree {n} does not fit in shared memory")
    out = torch.empty((2,) + dsc.shape[1:], dtype=torch.int64, device=dsc.device)
    rows_k = dsc[0].numel() // n
    if rows_k == 0:
        return out[0], out[1]
    tb = ctx.tables
    fn = kernels.function("relin_tail", "tpufhe_relin_tail", _RELIN_TAIL_ARGS)
    kernels.count("relin_tail")
    err = fn(kernels.ptr(dsc), kernels.ptr(out), rows_k, k, n,
             kernels.ptr(ksk.c0), kernels.ptr(ksk.c0_shoup),
             kernels.ptr(ksk.c1), kernels.ptr(ksk.c1_shoup),
             kernels.ptr(tb.omegas), kernels.ptr(tb.omegas_shoup),
             kernels.ptr(tb.p), kernels.ptr(tb.barrett_lo),
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
# Programs
# ---------------------------------------------------------------------------


def make_mul_relin(par: BfvParameters, rk, level: int = 0):
    """(a0, a1, b0, b1) -> (c0, c1): multiply + relinearize with the default
    HPS strategy (ops/mod.rs:259-341 then key_switching_key.rs:214-241).
    Inputs are NTT-domain (..., k, N) parts of two ciphertext batches."""
    ctx_lvl = par.context_level_at(level)
    ctx = ctx_lvl.poly_context
    ksk = rk.ksk
    assert ksk.ciphertext_level == level and ksk.ksk_level == level
    mp = ctx_lvl.mul_params()
    ctx_mul = mp.extender.to_ctx
    ext_rns = mp.extender.rns_scaler
    down_rns = mp.down_scaler.rns_scaler
    assert mp.extender.number_common_moduli == ctx.k
    k, k_mul = ctx.k, ctx_mul.k

    def step(a0, a1, b0, b1):
        x = torch.stack([a0, a1, b0, b1])  # (4, ..., k, N)
        # extend to the multiplication basis (ops/mod.rs:307-317)
        x_pb = ntt_backward(ctx, x)
        new_rows = ext_rns.scale(x_pb, starting_index=k, size=k_mul - k)
        new_rows = ntt_forward(ctx_mul, new_rows, limb_slice=slice(k, k_mul))
        ext = torch.cat([x, new_rows], dim=-2)
        # tensor product + inverse NTT, then the t/q down-scale
        t_pb = tensor_intt(ctx_mul, ext)
        dsc = down_rns.scale(t_pb, starting_index=0, size=k)
        return relin_tail(ctx, dsc, ksk)

    return step


def make_decrypt_phase(par: BfvParameters, sk, level: int = 0):
    """(c0, c1) -> plaintext-context residues (..., k_plain, N) in power
    basis: the phase c0 + c1 s, its inverse NTT and the t/q scaling. The
    small mod-t fold stays with the caller (secret_key.rs:233-260)."""
    ctx = par.context_at_level(level)
    scaler = par.context_level_at(level).cipher_plain_context.scaler
    s = sk.s_ntt(ctx)
    mod = ctx.mod

    def step(c0, c1):
        phase = zq.add(c0, zq.mul(c1, s, mod), mod)
        return scaler.rns_scaler.scale(ntt_backward(ctx, phase))

    return step


def make_encrypt_with_seed_expansion(par: BfvParameters, sk, level: int = 0):
    """(a, e, m) -> b = NTT(e) - a s + m, with a the seed-expanded uniform
    part (NTT domain), e the power-basis error and m the NTT-domain message
    (secret_key.rs:102-137)."""
    ctx = par.context_at_level(level)
    s = sk.s_ntt(ctx)
    mod = ctx.mod

    def step(a, e_pb, m):
        e = ntt_forward(ctx, e_pb)
        return zq.add(zq.sub(e, zq.mul(a, s, mod), mod), m, mod)

    return step
