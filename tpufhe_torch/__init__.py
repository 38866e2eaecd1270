"""tpufhe_torch: the PyTorch / CUDA port of tpufhe (leveled HPS RNS-BFV).

Residues are torch.int64 tensors shaped (..., k, N), one canonical residue
per word. Entry points run on the CUDA card by default; device="cpu" runs
the plain torch versions of the kernels. The hand-written kernels live in
csrc/ and are built with nvcc at first use (tpufhe_torch.kernels).
"""

__version__ = "0.1.0"
