"""BFV ciphertexts (fhe/src/bfv/ciphertext.rs).

A ciphertext is a list of NTT-domain parts, each a (k, N) tensor of the
level's word type (leading batch dimensions are allowed), at a level, with
the optional 32-byte seed that regenerates the last part of a fresh
ciphertext (ciphertext.rs:22-29). As in tpufhe, the list may be empty:
``Ciphertext.zero`` is the identity of ct_add and ct_sub, the start of a
running sum; ``Ciphertext.new`` checks for at least two parts.
``switch_down`` divides every part by the last modulus of its level and
rounds (K1 inverse, the switch-down of ops/rq.py, K1 forward), moving the
ciphertext one level down the modulus chain.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpufhe_torch.bfv.parameters import BfvParameters
from tpufhe_torch.errors import InvalidCiphertext, InvalidLevel, TooFewValues
from tpufhe_torch.ops.rq import ntt_backward, ntt_forward, switch_down


@dataclass
class Ciphertext:
    par: BfvParameters
    c: list  # list[torch.Tensor], NTT domain
    level: int
    seed: bytes | None = None

    @staticmethod
    def new(c: list, par: BfvParameters) -> "Ciphertext":
        """At least two parts of one shape, whose limbs are those of one
        level's context; the level is that context's (tpufhe
        ciphertext.py:24-33)."""
        if len(c) < 2:
            raise TooFewValues(len(c), 2)
        level = len(par.moduli) - c[0].shape[-2]
        if not 0 <= level <= par.max_level():
            raise InvalidCiphertext("inconsistent contexts")
        ctx = par.context_at_level(level)
        for ci in c:
            if (ci.shape != c[0].shape or ci.shape[-1] != ctx.degree
                    or ci.dtype != ctx.dtype):
                raise InvalidCiphertext("inconsistent contexts")
        return Ciphertext(par, list(c), level)

    @staticmethod
    def zero(par: BfvParameters) -> "Ciphertext":
        return Ciphertext(par, [], 0)

    def __len__(self):
        return len(self.c)

    def __getitem__(self, i) -> torch.Tensor:
        return self.c[i]

    def __setitem__(self, i, v):
        self.c[i] = v
        self.seed = None

    def truncate(self, n: int):
        self.c = self.c[:n]

    def clone(self) -> "Ciphertext":
        return Ciphertext(self.par, list(self.c), self.level, self.seed)

    def max_switchable_level(self) -> int:
        return self.par.max_level()

    def switch_down(self):
        """Every part divided by the last modulus and rounded, one level
        down; a no-op at the last level (ciphertext.rs:86-97)."""
        if self.level < self.max_switchable_level():
            self.seed = None
            if self.c:
                ctx = self.par.context_at_level(self.level)
                x = switch_down(ctx, ntt_backward(ctx, torch.stack(self.c)))
                self.c = list(ntt_forward(ctx.next_context, x))
            self.level += 1

    def switch_to_level(self, target: int):
        if target < self.level or target > self.max_switchable_level():
            raise InvalidLevel(target, self.level, self.max_switchable_level())
        while self.level < target:
            self.switch_down()

    # the operators of ops/mod.rs (impl Add/Sub/Neg/Mul for Ciphertext);
    # imported here to avoid the ciphertext <-> ops cycle
    def __add__(self, other):
        from tpufhe_torch.bfv import ops

        if isinstance(other, Ciphertext):
            return ops.ct_add(self, other)
        return ops.ct_add_pt(self, other)

    def __sub__(self, other):
        from tpufhe_torch.bfv import ops

        if isinstance(other, Ciphertext):
            return ops.ct_sub(self, other)
        return ops.ct_sub_pt(self, other)

    def __neg__(self):
        from tpufhe_torch.bfv import ops

        return ops.ct_neg(self)

    def __mul__(self, other):
        from tpufhe_torch.bfv import ops

        if isinstance(other, Ciphertext):
            return ops.ct_mul(self, other)
        return ops.ct_mul_pt(self, other)
