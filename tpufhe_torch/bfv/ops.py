"""Ciphertext addition and subtraction (fhe/src/bfv/ops/mod.rs; the
ct_add / ct_sub of tpufhe/bfv/ops.py). The rest of tpufhe's bfv/ops.py is
not ported yet."""

from __future__ import annotations

from tpufhe_torch.bfv.ciphertext import Ciphertext
from tpufhe_torch.errors import ContextMismatch, InvalidCiphertext


def _check(a: Ciphertext, b: Ciphertext):
    if a.par != b.par:
        raise ContextMismatch("Incompatible BFV parameters")
    if a.level != b.level or len(a) != len(b):
        raise InvalidCiphertext("the ciphertexts differ in level or size")
    return a.par.context_at_level(a.level)


def ct_add(a: Ciphertext, b: Ciphertext) -> Ciphertext:
    ctx = _check(a, b)
    return Ciphertext(a.par, [ctx.add(x, y) for x, y in zip(a.c, b.c)],
                      a.level)


def ct_sub(a: Ciphertext, b: Ciphertext) -> Ciphertext:
    ctx = _check(a, b)
    return Ciphertext(a.par, [ctx.sub(x, y) for x, y in zip(a.c, b.c)],
                      a.level)
