"""Multi-GPU programs over torch.distributed (the port of tpufhe.parallel):

- ``batch``: independent ciphertexts, pure data parallelism;
- ``limb``: the RNS limb axis, gathered before each rank's step
  (sharding.py);
- ``seq``: the degree axis, every stage coefficient-local but the
  transforms, which exchange once each (ntt_dist.py, seq_pipeline.py).

Every entry point raises without an initialized process group.
"""

from tpufhe_torch.parallel.sharding import (
    batch_limb_mesh,
    ct_sharding,
    make_sharded_mul_relin,
    shard_ciphertext,
)

__all__ = [
    "batch_limb_mesh",
    "ct_sharding",
    "shard_ciphertext",
    "make_sharded_mul_relin",
]
