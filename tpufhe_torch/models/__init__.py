"""The example applications (the reference's examples/ directory; tpufhe's
models package):

- bfv_basic: encrypt / add / mul / decrypt walkthrough (examples/bfv_basic.rs)
- bfv_ops: weighted sums, inner products, polynomial evaluation with and
  without SIMD (examples/bfv_ops.rs)
- rgsw: RGSW external product + mod switching (examples/rgsw.rs)
- pir: SealPIR and MulPIR private information retrieval
  (examples/{seal,mul}pir.rs)
- voting: multiparty private voting (examples/voting.rs)
"""

from tpufhe_torch.models.bfv_basic import run_bfv_basic
from tpufhe_torch.models.bfv_ops import run_bfv_ops
from tpufhe_torch.models.pir import run_mulpir, run_sealpir
from tpufhe_torch.models.rgsw import run_rgsw
from tpufhe_torch.models.voting import run_voting

__all__ = [
    "run_mulpir",
    "run_sealpir",
    "run_voting",
    "run_bfv_basic",
    "run_bfv_ops",
    "run_rgsw",
]
