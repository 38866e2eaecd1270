"""Batch x limb sharding of ciphertext batches over a torch.distributed
DeviceMesh: the port of tpufhe/parallel/sharding.py, whose jax Mesh and
GSPMD annotations become a DeviceMesh with dims ("batch", "limb") and an
explicit gather of the limbs."""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tpufhe_torch.bfv.parameters import BfvParameters
from tpufhe_torch.parallel.ntt_dist import axis_group, gather_blocks
from tpufhe_torch.pipeline import make_mul_relin


def batch_limb_mesh(n_batch: int, n_limb: int) -> DeviceMesh:
    """A (batch, limb) DeviceMesh over the n_batch n_limb ranks of the
    initialized default process group: of device type "cuda" over NCCL,
    else "cpu" (gloo, also where its ranks hold CUDA tensors)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("batch_limb_mesh needs an initialized "
                           "torch.distributed process group")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_batch, n_limb),
                            mesh_dim_names=("batch", "limb"))


def ct_sharding(mesh: DeviceMesh, limb_sharded: bool = True) -> tuple:
    """The DTensor placements of (B, k, N) ciphertext-batch arrays on the
    (batch, limb) mesh: B sharded over batch, k over limb or replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Shard(1) if limb_sharded else Replicate())


def _chunk(x: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    """Part `index` of x split along dim as DTensor's Shard splits it
    (torch.chunk: ceil-sized parts, the last ones shorter or empty)."""
    size = -(-x.shape[dim] // parts)
    lo = min(x.shape[dim], index * size)
    return x.narrow(dim, lo, min(x.shape[dim], lo + size) - lo)


def shard_ciphertext(mesh: DeviceMesh, arr: torch.Tensor,
                     limb_sharded: bool = True) -> torch.Tensor:
    """This rank's block of a (B, k, N) array under ct_sharding."""
    coord = mesh.get_coordinate()
    out = _chunk(arr, 0, mesh.size(0), coord[0])
    if limb_sharded:
        out = _chunk(out, 1, mesh.size(1), coord[1])
    return out.contiguous()


def make_sharded_mul_relin(par: BfvParameters, rk, mesh: DeviceMesh,
                           level: int = 0, limb_sharded: bool = True):
    """Multiply + relinearize over a (batch, limb) mesh: each rank passes
    its shard_ciphertext blocks of (B, k, N) NTT-domain parts. The rank's
    batch rows run make_mul_relin unchanged (the fused kernels K1, K2, K3,
    K4); where limbs are sharded, the four parts' limbs are first gathered
    over the limb axis (one all_gather), and the rank's limbs of the
    product returned. Equal to tpufhe's GSPMD program word for word.
    Raises RuntimeError without a process
    group."""
    step = make_mul_relin(par, rk, level)
    group = axis_group(mesh, "limb")
    k = par.context_at_level(level).k
    limbs, index = mesh.size(1), mesh.get_coordinate()[1]
    size = -(-k // limbs)

    def gather(x):
        """(4, B_local, k_local, N) -> all k limbs of the four parts."""
        pad = size - x.shape[-2]
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[:-2] + (pad, x.shape[-1]))],
                          dim=-2)
        blocks = gather_blocks(x, group)
        return torch.cat(list(blocks.unbind(0)), dim=-2)[..., :k, :]

    def run(a0, a1, b0, b1):
        if not limb_sharded:
            return step(a0, a1, b0, b1)
        c0, c1 = step(*gather(torch.stack([a0, a1, b0, b1])))
        return (_chunk(c0, -2, limbs, index).contiguous(),
                _chunk(c1, -2, limbs, index).contiguous())

    return run
