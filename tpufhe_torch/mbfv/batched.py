"""Batched all-parties multiparty programs (tpufhe's mbfv/batched.py).

The object API (protocols.py) runs each party's share on its own; these
programs compute one share type for ALL parties at once, the party axis
leading every tensor, and fold the aggregation (the share sum,
mbfv/aggregate.rs:4-22) into the same call: one batched K1 launch (K9 when
narrow) for the parties' secrets and one for their errors. Sampling stays
on the host, through the ChaCha8 / CBD sampler, in the object API's order,
so the results are bit-identical to running the per-party protocol objects
on the same stream (tests/test_torch_mbfv_batched.py).

For parties spread over processes, ``psum_mod`` maps the aggregation onto
a torch.distributed all_reduce: residues split into 31-bit planes whose
integer sums are exact for up to 2^32 addends, then recombined mod p --
the ``Aggregate = psum`` mapping of tpufhe's mesh version, which sums
16-bit planes over a parties mesh axis.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpufhe_torch.bfv.ciphertext import Ciphertext
from tpufhe_torch.bfv.keys.public_key import PublicKey
from tpufhe_torch.bfv.keys.secret_key import scaled_plaintext
from tpufhe_torch.bfv.plaintext import Plaintext
from tpufhe_torch.mbfv.protocols import collective_relinearization_key
from tpufhe_torch.ops import zq
from tpufhe_torch.ops.rns import RnsContext
from tpufhe_torch.ops.rq import ntt_backward, ntt_forward
from tpufhe_torch.utils.sampling import sample_vec_cbd

_PLANE_BITS = 31
_PLANE_MASK = (1 << _PLANE_BITS) - 1


def _rows(coeff_rows: np.ndarray, ctx) -> torch.Tensor:
    """Signed (..., N) coefficient rows reduced into every limb of ctx:
    (..., k, N) power basis of the context's word type, on its device."""
    t = torch.from_numpy(np.ascontiguousarray(coeff_rows, dtype=np.int64))
    return torch.remainder(t.to(ctx.device)[..., None, :], ctx.mod.p
                           ).to(ctx.dtype)


def _secrets(sk_shares, ctx) -> torch.Tensor:
    """Every party's secret in the NTT domain of ctx, (P, k, N): one launch."""
    s_rows = np.stack([np.asarray(sk.coeffs, dtype=np.int64)
                       for sk in sk_shares])
    return ntt_forward(ctx, _rows(s_rows, ctx))


def _errors(n_rows: int, par, ctx, rng) -> torch.Tensor:
    """n_rows CBD error rows drawn in order, in the NTT domain of ctx,
    (n_rows, k, N): one launch."""
    e_rows = np.stack([sample_vec_cbd(ctx.degree, par.variance, rng)
                       for _ in range(n_rows)])
    return ntt_forward(ctx, _rows(e_rows, ctx))


def sum_parties(x: torch.Tensor, ctx) -> torch.Tensor:
    """The sum mod p of (P, ..., k, N) residues over the party axis
    (tpufhe's _sum_parties_mod): one modular add a party."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = ctx.add(acc, x[i])
    return acc


def batched_public_key(sk_shares, crp, rng) -> PublicKey:
    """EncKeyGen for all parties at once: every p0_i = -a s_i + e_i and
    their sum (public_key_gen.rs:33-79), one K1 launch for the s_i and one
    for the e_i."""
    par = sk_shares[0].par
    ctx = par.context_at_level(0)
    s = _secrets(sk_shares, ctx)
    e = _errors(len(sk_shares), par, ctx, rng)
    a = crp.poly.coeffs
    p0 = ctx.add(ctx.mul(ctx.neg(a), s), e)  # (P, k, N)
    return PublicKey(par, Ciphertext.new([sum_parties(p0, ctx), a], par))


def batched_decryption(sk_shares, ct: Ciphertext, rng) -> Plaintext:
    """Collective decryption at once: every party's h_i = s_i c1 + e_i,
    their sum, + c0, the inverse NTT and the t/q scale
    (secret_key_switch.rs:39-193): ntt 3 (K1: s, e, the phase's inverse),
    rns_scale 1 (K2)."""
    par = sk_shares[0].par
    ctx = par.context_at_level(ct.level)
    scaler = par.context_level_at(ct.level).cipher_plain_context.scaler
    s = _secrets(sk_shares, ctx)
    e = _errors(len(sk_shares), par, ctx, rng)
    h = ctx.add(ctx.mul(s, ct[1]), e)
    c0 = ctx.add(ct[0], sum_parties(h, ctx))
    d = scaler.rns_scaler.scale(ntt_backward(ctx, c0))
    return scaled_plaintext(par, d, ct.level)


def batched_relin_keygen(sk_shares, crp_vec, rng):
    """The 2-round RelinKeyGen for all parties, each round one batched
    computation of every party's shares and their aggregation
    (relin_key_gen.rs:19-358): the secrets, the u and round 1's errors in
    one K1 launch each, round 2's errors in one.

    The stream is drawn in the object API's order, so the key is
    bit-identical: u for every party first (RelinKeyGenerator's
    constructor), then party by party round 1's k h0 errors followed by its
    k h1 errors, then the same P * 2 * k rows for round 2.
    """
    par = sk_shares[0].par
    ctx = par.context_at_level(0)
    k, n, parties = ctx.k, ctx.degree, len(sk_shares)
    rns = RnsContext(list(par.moduli[:k]))
    garner = torch.tensor([[rns.get_garner(i) % m for m in ctx.moduli]
                           for i in range(k)], dtype=ctx.dtype,
                          device=ctx.device)[..., None]  # (k, k, 1)

    u = _errors(parties, par, ctx, rng)
    e = _errors(parties * 2 * k, par, ctx, rng).reshape(parties, 2, k, k, n)
    s = _secrets(sk_shares, ctx)
    h0_sum, h1_sum = [], []
    for i in range(k):
        a = crp_vec[i].poly.coeffs
        h0 = ctx.add(ctx.add(ctx.mul(ctx.neg(a), u), ctx.mul(s, garner[i])),
                     e[:, 0, i])
        h1 = ctx.add(ctx.mul(a, s), e[:, 1, i])
        h0_sum.append(sum_parties(h0, ctx))
        h1_sum.append(sum_parties(h1, ctx))

    f = _errors(parties * 2 * k, par, ctx, rng).reshape(parties, 2, k, k, n)
    u_s = ctx.sub(u, s)
    c0 = []
    for i in range(k):
        agg0 = sum_parties(ctx.add(ctx.mul(h0_sum[i], s), f[:, 0, i]), ctx)
        agg1 = sum_parties(ctx.add(ctx.mul(h1_sum[i], u_s), f[:, 1, i]), ctx)
        c0.append(ctx.add(agg0, agg1))
    return collective_relinearization_key(par, torch.stack(c0),
                                          torch.stack(h1_sum))


# ---------------------------------------------------------------------------
# Aggregation across processes
# ---------------------------------------------------------------------------


def psum_mod(coeffs: torch.Tensor, ctx, group=None, dim: int | None = None
             ) -> torch.Tensor:
    """The exact sum mod p of canonical (..., k, N) residues of ctx over the
    ranks of `group` (torch.distributed, the default group when None), and
    first over axis `dim` of this rank's tensor when given.

    Wide residues (< 2^62) split into two 31-bit planes, narrow ones
    (< 2^30) are one plane; the planes' int64 sums are exact for up to
    2^32 addends in all, one all_reduce carries them, and
    (hi mod p) 2^31 + (lo mod p) mod p recombines them. Raises if the
    process group is not initialized: it never falls back to a local sum.
    The port of tpufhe's psum_mod, which sums 16-bit planes over a mesh
    axis."""
    x = coeffs.long()
    planes = [x] if ctx.narrow else [x & _PLANE_MASK, x >> _PLANE_BITS]
    if dim is not None:
        planes = [p.sum(dim) for p in planes]
    sums = torch.stack(planes)
    dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
    m = ctx.mod
    lo = torch.remainder(sums[0], m.p)
    if ctx.narrow:
        return lo.to(ctx.dtype)
    hi = torch.remainder(sums[1], m.p)
    two31 = torch.remainder(torch.full_like(m.p, 1 << _PLANE_BITS), m.p)
    return zq.add(zq.mul(hi, two31, m), lo, m)


def make_sharded_pk_aggregation(par, group=None):
    """The aggregation of EncKeyGen shares across processes: each rank
    holds the p0 shares of its parties, (P_rank, k, N) (any P_rank), and
    every rank gets the collective p0, (k, N), through psum_mod over
    `group`.

    The one signature of the port that differs from tpufhe's: tpufhe's
    make_sharded_pk_aggregation(par, mesh, parties_axis) takes a device
    mesh and one party a device; this takes a torch.distributed process
    group (None: the default group), which the caller initializes."""
    ctx = par.context_at_level(0)

    def run(p0_local: torch.Tensor) -> torch.Tensor:
        return psum_mod(p0_local, ctx, group, dim=0)

    return run
