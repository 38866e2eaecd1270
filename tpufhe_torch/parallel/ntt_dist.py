"""The negacyclic NTT with the degree axis sharded over the ranks of a
torch.distributed group: one all_gather a transform, the port of
tpufhe/parallel/ntt_dist.py on its own plan.

tpufhe distributes its four-step MXU plan (int8 digit-plane matrices for
the TPU's matrix unit). The port splits its butterfly network instead. With
D shards, B = N / D and shard e holding coefficients [e B, (e + 1) B):

- forward: the first log2 D Cooley-Tukey stages pair whole blocks with one
  twiddle each, so they are one D x D matrix W per limb,
  y_e = sum_d W[e][d] x_d mod p; the remaining stages are the size-B
  network on block e with the gathered table
  T_e[m + g] = omega[m D + e m + g] (m = 1, 2, ..., B / 2), which kernel K1
  runs unchanged at n = B;
- inverse: the size-B Gentleman-Sande stages first, on block e with
  zeta_inv gathered the same way stage by stage (K1 inverse with
  n^{-1} = 1), then one D x D matrix W_inv with N^{-1} folded in.

Each transform exchanges once: every rank gathers the D blocks
(all_gather) and applies its row of W (kernel ntt_dist, csrc/ntt_dist.cu).
That moves (D - 1) / D N words per limb per rank, the volume of tpufhe's
all_to_all (ntt_dist.py:21-23). The output is canonical and in the
single-device bit-reversed order: the D blocks side by side equal K1's
transform of the whole row word for word.

Each shard function is split at its collective into two module-level
halves, ``forward_pre`` / ``forward_post`` and ``backward_pre`` /
``backward_post``, so that D ranks can also run in one process with the
exchange done by stacking. Without an initialized process group the
collective raises; nothing falls back to a single-device transform.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpufhe_torch import kernels
from tpufhe_torch.ops import zq
from tpufhe_torch.ops.ntt import NttOperator, NttTables, ntt_transform
from tpufhe_torch.ops.zq import ModTable, Modulus
from tpufhe_torch.utils.obs import uncounted

# K1's shortest row (csrc/ntt.cu): the smallest block a shard may hold
MIN_BLOCK = 8


# ---------------------------------------------------------------------------
# The plan: host constants, built once
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def shard_indices(n: int, shards: int, rank: int) -> tuple:
    """Indices into a limb's bit-reversed omegas and zetas_inv (length n)
    that make shard `rank`'s size-B tables, (forward, inverse), each B long:
    forward[m + g] = m D + rank m + g for m = 1, 2, ..., B / 2 (entry 0
    pads with omega 1); inverse, for the stage of half-width l, at the
    size-B network's running offset B - B / l plus g < B / (2 l):
    N - N / l + rank B / (2 l) + g (entry B - 1 pads with index N - 1)."""
    b = n // shards
    fwd = np.zeros(b, dtype=np.int64)
    m = 1
    while m < b:
        fwd[m:2 * m] = shards * m + rank * m + np.arange(m)
        m *= 2
    inv = np.full(b, n - 1, dtype=np.int64)
    l = 1
    while l < b:
        groups = b // (2 * l)
        start = b - b // l
        inv[start:start + groups] = (n - n // l + rank * groups
                                     + np.arange(groups))
        l *= 2
    return fwd, inv


@lru_cache(maxsize=None)
def cross_matrices(p: int, n: int, shards: int) -> tuple:
    """(W, W_inv) of modulus p at degree n over `shards` blocks, as D x D
    tuples of Python ints: W[e][d] is the weight of input block d in the
    forward's block e after its first log2 D stages, W_inv[e][d] that of
    the inverse's last log2 D stages times N^{-1}."""
    op = NttOperator.new(Modulus(p), n)
    omegas = [int(v) for v in op.omegas]
    zetas = [int(v) for v in op.zetas_inv]
    eye = [[int(i == j) for j in range(shards)] for i in range(shards)]

    fwd = [row[:] for row in eye]
    m = 1
    while m < shards:  # Cooley-Tukey stage of m groups
        half = shards // (2 * m)
        for g in range(m):
            w = omegas[m + g]
            for j in range(half):
                a, b = 2 * g * half + j, 2 * g * half + j + half
                t = [w * v % p for v in fwd[b]]
                fwd[a], fwd[b] = ([(x + y) % p for x, y in zip(fwd[a], t)],
                                  [(x - y) % p for x, y in zip(fwd[a], t)])
        m *= 2

    inv = [row[:] for row in eye]
    blk = n // shards
    lb = 1
    while lb < shards:  # Gentleman-Sande stage of half-width lb blocks
        offset = n - n // (lb * blk)
        for g in range(shards // (2 * lb)):
            z = zetas[offset + g]
            for j in range(lb):
                a, b = 2 * g * lb + j, 2 * g * lb + j + lb
                pairs = list(zip(inv[a], inv[b]))
                inv[a] = [(x + y) % p for x, y in pairs]
                inv[b] = [(x - y) * z % p for x, y in pairs]
        lb *= 2
    inv = [[v * op.size_inv % p for v in row] for row in inv]
    return tuple(map(tuple, fwd)), tuple(map(tuple, inv))


@dataclass
class DistNttPlan:
    """One shard's constants for the wide limbs of one context: ``tables``,
    the size-B forward and inverse tables of shard ``rank`` with their
    Shoup words (n^{-1} = 1), which K1 and its plain version take as they
    are; ``w`` / ``w_inv``, (k, D) row ``rank`` of each limb's W and W_inv,
    with their Shoup words. A rank holds only its own shard's plan, as
    each TPU device holds only its M1 column block and twiddle row block
    (tpufhe ntt_dist.py:136-138)."""

    n: int
    shards: int
    rank: int
    tables: NttTables
    w: torch.Tensor
    w_shoup: torch.Tensor
    w_inv: torch.Tensor
    w_inv_shoup: torch.Tensor

    @property
    def block(self) -> int:
        return self.n // self.shards

    @staticmethod
    def new(ctx, shards: int, rank: int) -> "DistNttPlan":
        n = ctx.degree
        if ctx.narrow:
            raise ValueError("the distributed NTT takes wide (62-bit) "
                             "contexts only")
        if shards < 1 or n % shards:
            raise ValueError(f"{shards} shards do not divide degree {n}")
        if n // shards < MIN_BLOCK:
            raise ValueError(f"blocks of {n // shards} coefficients are "
                             f"below K1's shortest row ({MIN_BLOCK})")
        if not 0 <= rank < shards:
            raise ValueError(f"rank {rank} is not one of {shards} shards")
        fwd, inv = shard_indices(n, shards, rank)
        whole = ctx.tables
        dev = whole.p.device

        def words(vals):
            return torch.from_numpy(zq.as_int64(
                np.array(vals, dtype=np.uint64))).to(dev)

        mats = [cross_matrices(p, n, shards) for p in ctx.moduli]
        w = [m[0][rank] for m in mats]
        w_inv = [m[1][rank] for m in mats]

        def shoup(rows):
            return [[(v << 64) // p for v in row]
                    for row, p in zip(rows, ctx.moduli)]

        fi, ii = (torch.from_numpy(i).to(dev) for i in (fwd, inv))
        k = ctx.k
        tables = NttTables(
            omegas=whole.omegas[:, fi].contiguous(),
            omegas_shoup=whole.omegas_shoup[:, fi].contiguous(),
            zetas_inv=whole.zetas_inv[:, ii].contiguous(),
            zetas_inv_shoup=whole.zetas_inv_shoup[:, ii].contiguous(),
            p=whole.p, barrett_lo=whole.barrett_lo,
            barrett_hi=whole.barrett_hi,
            ninv=torch.ones(k, dtype=torch.int64, device=dev),
            ninv_shoup=words([Modulus(p).shoup(1) for p in ctx.moduli]),
            mod=whole.mod)
        return DistNttPlan(n, shards, rank, tables, words(w), words(shoup(w)),
                           words(w_inv), words(shoup(w_inv)))


# ---------------------------------------------------------------------------
# The cross step: plain version and kernel ntt_dist (csrc/ntt_dist.cu)
# ---------------------------------------------------------------------------

_NTT_DIST_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                  + [ctypes.c_int, ctypes.c_void_p])


@uncounted
def cross_plain(blocks: torch.Tensor, w: torch.Tensor, w_shoup: torch.Tensor,
                mod: ModTable) -> torch.Tensor:
    """sum_d w[:, d] blocks[d] mod p of (D, ..., k, B) words (any value
    below 2^64) with (k, D) weights: the plain version of ntt_dist."""
    acc = None
    for d in range(blocks.shape[0]):
        t = zq.mul_shoup(zq.reduce_u64(blocks[d], mod), w[:, d, None],
                         w_shoup[:, d, None], mod)
        acc = t if acc is None else zq.add(acc, t, mod)
    return acc


def cross_cuda(blocks: torch.Tensor, w: torch.Tensor, w_shoup: torch.Tensor,
               p: torch.Tensor, limb0: int) -> torch.Tensor:
    """Launch ntt_dist on (D, ..., k_sel, B) int64 words of a CUDA tensor;
    w, w_shoup (k_ctx, D), p (k_ctx,), rows of limb limb0 + j."""
    kernels.require_cuda("ntt_dist", torch.int64, blocks, w, w_shoup, p)
    shards, k_sel, b = blocks.shape[0], blocks.shape[-2], blocks.shape[-1]
    if w.shape[-1] != shards or limb0 + k_sel > w.shape[0]:
        raise ValueError(f"ntt_dist: weights {tuple(w.shape)} do not match "
                         f"{shards} blocks of limbs {limb0}..{limb0 + k_sel}")
    y = torch.empty(blocks.shape[1:], dtype=torch.int64, device=blocks.device)
    plane = y.numel()
    if plane == 0:
        return y
    fn = kernels.function("ntt_dist", "tpufhe_ntt_dist", _NTT_DIST_ARGS)
    kernels.count("ntt_dist")
    err = fn(kernels.ptr(blocks), kernels.ptr(y), plane, shards, k_sel, b,
             kernels.ptr(w), kernels.ptr(w_shoup), kernels.ptr(p), limb0,
             kernels.stream())
    kernels.check(err, "ntt_dist")
    return y


def cross(blocks: torch.Tensor, plan: DistNttPlan, limb_slice: slice,
          inverse: bool) -> torch.Tensor:
    """The rank's block of the cross step over the D gathered blocks (D,
    ..., k_sel, B) of the limbs `limb_slice`: W's row (W_inv's when
    inverse)."""
    w, ws = ((plan.w_inv, plan.w_inv_shoup) if inverse
             else (plan.w, plan.w_shoup))
    k_ctx = w.shape[0]
    start, stop, _ = limb_slice.indices(k_ctx)
    if (blocks.shape[0] != plan.shards or blocks.shape[-1] != plan.block
            or blocks.shape[-2] != stop - start):
        raise ValueError(f"ntt_dist: blocks {tuple(blocks.shape)}, expected "
                         f"({plan.shards}, ..., {stop - start}, {plan.block})")
    if blocks.device.type == "cuda":
        return cross_cuda(blocks, w, ws, plan.tables.p, start)
    if blocks.device.type != "cpu":
        raise ValueError(f"ntt_dist: unsupported device {blocks.device}")
    return cross_plain(blocks, w[limb_slice], ws[limb_slice],
                       plan.tables.mod[limb_slice])


# ---------------------------------------------------------------------------
# The halves of each shard function, split at the collective
# ---------------------------------------------------------------------------


def _limbs(limb_slice):
    return slice(None) if limb_slice is None else limb_slice


def _block(x_local: torch.Tensor, plan: DistNttPlan) -> torch.Tensor:
    if x_local.shape[-1] != plan.block:
        raise ValueError(f"dist NTT: block of {x_local.shape[-1]} "
                         f"coefficients, expected {plan.block}")
    return x_local.contiguous()


def forward_pre(x_local: torch.Tensor, plan: DistNttPlan,
                limb_slice: slice | None = None) -> torch.Tensor:
    """The forward before the exchange: the block to send, (..., k_sel, B)
    words in [0, 4p) (the cross step reduces them)."""
    return _block(x_local, plan)


def forward_post(blocks: torch.Tensor, plan: DistNttPlan,
                 limb_slice: slice | None = None,
                 lazy: bool = False) -> torch.Tensor:
    """The forward after the exchange, on the D gathered blocks (D, ...,
    k_sel, B): the cross step (ntt_dist), then K1 at n = B on the shard's
    tables. Returns the rank's canonical block of the transform, or with
    lazy K1's lazy words, below 4p."""
    sl = _limbs(limb_slice)
    return ntt_transform(cross(blocks, plan, sl, inverse=False), plan.tables,
                         sl, lazy=lazy)


def backward_pre(x_local: torch.Tensor, plan: DistNttPlan,
                 limb_slice: slice | None = None) -> torch.Tensor:
    """The inverse before the exchange: K1 inverse at n = B on the shard's
    tables (n^{-1} = 1) of canonical (..., k_sel, B) words."""
    return ntt_transform(_block(x_local, plan), plan.tables,
                         _limbs(limb_slice), inverse=True)


def backward_post(blocks: torch.Tensor, plan: DistNttPlan,
                  limb_slice: slice | None = None) -> torch.Tensor:
    """The inverse after the exchange: the rank's block of W_inv (N^{-1}
    folded in) over the D gathered blocks."""
    return cross(blocks, plan, _limbs(limb_slice), inverse=True)


# ---------------------------------------------------------------------------
# The exchange and the shard functions
# ---------------------------------------------------------------------------


def axis_group(mesh_or_group, axis: str):
    """The process group of `axis` of a DeviceMesh, or the group itself
    (None: the default group). Raises if torch.distributed has no
    initialized process group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("the parallel programs need an initialized "
                           "torch.distributed process group")
    if isinstance(mesh_or_group, DeviceMesh):
        return mesh_or_group.get_group(axis)
    return dist.group.WORLD if mesh_or_group is None else mesh_or_group


def gather_blocks(x: torch.Tensor, group) -> torch.Tensor:
    """(D, *x.shape): every rank's x over `group`, in rank order, by one
    all_gather (NCCL, or gloo, which also takes CUDA tensors and moves
    them through the host)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("gather_blocks needs an initialized "
                           "torch.distributed process group")
    x = x.contiguous()
    out = torch.empty((dist.get_world_size(group),) + tuple(x.shape),
                      dtype=x.dtype, device=x.device)
    dist.all_gather(list(out.unbind(0)), x, group=group)
    return out


def dist_forward_shard(x_local: torch.Tensor, plan: DistNttPlan, group,
                       limb_slice: slice | None = None,
                       lazy: bool = False) -> torch.Tensor:
    """Forward NTT of the rank's (..., k_sel, B) block of rows whose
    coefficients are sharded over `group` (tpufhe ntt_dist.py:99-116);
    lazy: output words below 4p, as tpufhe's lazy flag leaves them."""
    send = forward_pre(x_local, plan, limb_slice)
    return forward_post(gather_blocks(send, group), plan, limb_slice, lazy)


def dist_backward_shard(x_local: torch.Tensor, plan: DistNttPlan, group,
                        limb_slice: slice | None = None) -> torch.Tensor:
    """Inverse NTT (with the N^{-1} fold) of the rank's block (tpufhe
    ntt_dist.py:119-129)."""
    send = backward_pre(x_local, plan, limb_slice)
    return backward_post(gather_blocks(send, group), plan, limb_slice)


class DistNtt:
    """Forward and inverse NTT of one context over the `seq_axis` of a
    DeviceMesh, or over a process group. Inputs and outputs are the rank's
    (..., k, N / D) blocks, one word per residue, rank e of the group
    holding coefficients [e B, (e + 1) B). The forward takes words in
    [0, 4p) and returns canonical ones, as tpufhe's does for its lazy
    inputs (tests/test_ntt_dist.py, bound 4), or with lazy=True words
    below 4p (tpufhe's lazy flag, ntt_dist.py:208); the inverse takes
    canonical words. Raises ValueError where D does not divide N or B is below K1's
    shortest row, and RuntimeError without a process group."""

    def __init__(self, ctx, mesh_or_group=None, seq_axis: str = "seq"):
        self.ctx = ctx
        self.group = axis_group(mesh_or_group, seq_axis)
        self.mesh = mesh_or_group if isinstance(mesh_or_group,
                                                DeviceMesh) else None
        self.seq_axis = seq_axis
        self.n_shards = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.plan = DistNttPlan.new(ctx, self.n_shards, self.rank)

    def forward(self, x_local: torch.Tensor,
                limb_slice: slice | None = None,
                lazy: bool = False) -> torch.Tensor:
        return dist_forward_shard(x_local, self.plan, self.group, limb_slice,
                                  lazy)

    def backward(self, x_local: torch.Tensor,
                 limb_slice: slice | None = None) -> torch.Tensor:
        return dist_backward_shard(x_local, self.plan, self.group, limb_slice)

    def sharding(self, nlead: int) -> tuple:
        """The DTensor placements of (..., k, N) data with `nlead` leading
        dimensions: sharded along the coefficients over the seq axis (the
        counterpart of tpufhe's NamedSharding)."""
        from torch.distributed.tensor import Replicate, Shard

        if self.mesh is None:
            return (Shard(nlead + 1),)
        return tuple(Shard(nlead + 1) if name == self.seq_axis else Replicate()
                     for name in self.mesh.mesh_dim_names)
