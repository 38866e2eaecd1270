"""BFV ciphertexts (fhe/src/bfv/ciphertext.rs).

A ciphertext is a list of NTT-domain parts, each an int64 tensor (k, N)
(leading batch dimensions are allowed), at a level, with the optional
32-byte seed that regenerates the last part of a fresh ciphertext
(ciphertext.rs:22-29).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpufhe_torch.bfv.parameters import BfvParameters
from tpufhe_torch.errors import TooFewValues


@dataclass
class Ciphertext:
    par: BfvParameters
    c: list  # list[torch.Tensor], NTT domain
    level: int
    seed: bytes | None = None

    def __post_init__(self):
        if len(self.c) < 2:
            raise TooFewValues(len(self.c), 2)

    def __len__(self):
        return len(self.c)

    def __getitem__(self, i) -> torch.Tensor:
        return self.c[i]
