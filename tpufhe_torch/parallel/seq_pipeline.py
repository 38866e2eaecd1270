"""Multiply + relinearize with the degree axis sharded over a mesh's
`seq` axis (or a process group): the port of
tpufhe/parallel/seq_pipeline.py.

Every stage of the HPS step but the transforms is coefficient-local: the
extend and the down-scale (K2), the tensor product (K7), the Garner
digits and the key-switch accumulate (ks_accumulate) mix limbs, never
coefficients. So the sharded step is make_mul_relin with
parallel/ntt_dist.py's shard transforms as its ntt_fwd / ntt_bwd hooks and
the key's column block as its const_slice; each transform exchanges once.
Each rank holds the (B_local, k, N / D) block of coefficients
[e N / D, (e + 1) N / D) of its batch rows, and its outputs are the same
block of the product, equal word for word to make_mul_relin's. Per rank and
step: ntt 4, ntt_dist 4, rns_scale 2, tensor 1, ks_accumulate 1 (strategy
2: ntt 5, ntt_dist 5, rns_scale 3).
"""

from __future__ import annotations

import torch.distributed as dist

from tpufhe_torch.bfv.parameters import BfvParameters
from tpufhe_torch.errors import UnsupportedOperation
from tpufhe_torch.parallel.ntt_dist import (
    DistNttPlan,
    axis_group,
    dist_backward_shard,
    dist_forward_shard,
)
from tpufhe_torch.pipeline import make_mul_relin


def make_seq_sharded_mul_relin(par: BfvParameters, rk, mesh,
                               seq_axis: str = "seq", level: int = 0,
                               batch_axis: str | None = None,
                               strategy2_primes: int | None = None):
    """(a0, a1, b0, b1) -> (c0, c1) on this rank's (B_local, k, N / D)
    blocks of NTT-domain parts, the coefficients sharded over `seq_axis`
    of the DeviceMesh `mesh` (or over the process group `mesh`) and the
    batch, where `batch_axis` names one, over that axis (no collective
    runs over it). strategy2_primes as make_mul_relin's. Raises
    UnsupportedOperation on narrow (w30) parameters, as tpufhe asserts a
    wide context, and RuntimeError without a process group."""
    ctx = par.context_at_level(level)
    if ctx.narrow:
        raise UnsupportedOperation(
            "sequence sharding takes wide (62-bit) contexts only")
    group = axis_group(mesh, seq_axis)
    if batch_axis is not None:
        axis_group(mesh, batch_axis)
    shards, rank = dist.get_world_size(group), dist.get_rank(group)
    plans: dict = {}

    def plan(c):
        if c not in plans:
            plans[c] = DistNttPlan.new(c, shards, rank)
        return plans[c]

    plan(ctx)  # raises here where the shards do not fit the degree
    block = ctx.degree // shards

    def fwd(c, x, limb_slice=None):
        return dist_forward_shard(x, plan(c), group, limb_slice)

    def bwd(c, x):
        return dist_backward_shard(x, plan(c), group)

    def const_slice(arr):
        return arr[..., rank * block:(rank + 1) * block]

    return make_mul_relin(par, rk, level, strategy2_primes=strategy2_primes,
                          ntt_fwd=fwd, ntt_bwd=bwd, const_slice=const_slice)
