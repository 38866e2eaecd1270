"""The control and the faults that a cell's check has to catch, each a
context manager that breaks the program underneath a run of the harness:

- keygen_slip: the control. Every key-switching key draws its errors one
  row late in the ChaCha8 stream, a key that still decrypts and
  relinearizes but is not fhe.rs's for the seed: it breaks the
  configurations' stated guarantee that keys are fhe.rs's for the seed.
- answer_altered: one word of every answer changed where the program
  produces it (the last program of the cell's timed path).
- half_batch: the program serves the first half of a batch and hands
  the rest back unserved.
- level_kept: the MulPIR server sends its answers at the level it
  computed them, Ciphertext.switch_to_level doing nothing.
"""

from __future__ import annotations

import contextlib

import torch

from tpufhe_torch import pipeline
from tpufhe_torch.bfv import Ciphertext
from tpufhe_torch.bfv.keys import key_switching_key as ksk_mod
from tpufhe_torch.utils.sampling import sample_vec_cbd


@contextlib.contextmanager
def patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def keygen_slip():
    cls = ksk_mod.KeySwitchingKey
    orig = cls.__dict__["_generate_c0"]

    def slipped(sk, ctx, from_poly, c1, rng, scalars):
        sample_vec_cbd(ctx.degree, sk.par.variance, rng)
        return orig.__func__(sk, ctx, from_poly, c1, rng, scalars)

    cls._generate_c0 = staticmethod(slipped)
    try:
        yield
    finally:
        cls._generate_c0 = orig


def _bump(x: torch.Tensor) -> torch.Tensor:
    """x with its first word moved by one (mod nothing: a wrong residue)."""
    y = x.clone()
    y.view(-1)[0] ^= 1
    return y


# the last program of each driver's timed path, as the drivers import it
_LAST = {"mulrelin": "make_mul_relin", "innerprod": "make_inner_sum",
         "mulpir": "make_pir_response_db"}


@contextlib.contextmanager
def answer_altered(driver: str):
    def make(orig):
        def build(*args, **kwargs):
            step = orig(*args, **kwargs)
            return lambda *a: tuple(_bump(o) if i == 0 else o
                                    for i, o in enumerate(step(*a)))
        return build

    with patched(pipeline, _LAST[driver], make):
        yield


@contextlib.contextmanager
def half_batch(driver: str):
    """The batch axis is the leading one of the inputs of make_mul_relin
    and make_inner_sum, the second of make_pir_response_db's expanded
    ciphertexts."""
    def make(orig):
        def build(*args, **kwargs):
            step = orig(*args, **kwargs)
            if driver == "mulpir":
                def half(e0, e1, db):
                    b = e0.shape[1]
                    out = step(e0[:, :b // 2].contiguous(),
                               e1[:, :b // 2].contiguous(), db)
                    return tuple(torch.cat([o, o.new_zeros((b - o.shape[0],)
                                                           + o.shape[1:])])
                                 for o in out)
                return half

            def half(*parts):
                h = parts[0].shape[0] // 2
                out = step(*(p[:h] for p in parts))
                return tuple(torch.cat([o, p[h:]])
                             for o, p in zip(out, parts))
            return half
        return build

    with patched(pipeline, _LAST[driver], make):
        yield


@contextlib.contextmanager
def level_kept(driver: str):
    with patched(Ciphertext, "switch_to_level",
                 lambda orig: lambda self, target: None):
        yield


#: the faults each driver's cells can have
FAULTS = {"mulrelin": ("answer_altered", "half_batch"),
          "innerprod": ("answer_altered", "half_batch"),
          "mulpir": ("answer_altered", "half_batch", "level_kept")}
