"""Carry state between tpufhe and tpufhe_torch, through numpy arrays only.

tpufhe keeps residues as lane-folded uint32 (lo, hi) planes shaped
(..., k, 2, N/128, 128) (or (..., k, 2, 1, N) when N is not a multiple of
128), because TPU lanes are 32-bit, and the residues of a narrow (w30)
context as one plane, (..., k, 1, S, L). tpufhe_torch keeps one word per
residue, (..., k, N): int64, or int32 for a narrow context. These
functions convert between the two, and build tpufhe_torch key, ciphertext
and plaintext objects from the arrays of tpufhe's, so that both packages
can be fed the same keys; a narrow key's Shoup arrays (shoup32) convert
the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufhe_torch.ops.zq import as_int64

_LANES = 128


def _lane_shape(n: int) -> tuple:
    return (n // _LANES, _LANES) if n % _LANES == 0 else (1, n)


def lanes_to_words(arr: np.ndarray) -> np.ndarray:
    """uint32 (..., 2, S, L) lane-folded pairs -> int64 (..., N) words
    (the bit pattern of the uint64 value); a narrow single plane
    (..., 1, S, L) -> int32 (..., N) words (the bit pattern of the uint32
    value)."""
    arr = np.asarray(arr, dtype=np.uint32)
    flat = arr.reshape(arr.shape[:-2] + (arr.shape[-2] * arr.shape[-1],))
    if flat.shape[-2] == 1:
        return np.array(flat[..., 0, :]).view(np.int32)
    lo = flat[..., 0, :].astype(np.uint64)
    hi = flat[..., 1, :].astype(np.uint64)
    return as_int64(lo | (hi << np.uint64(32)))


def words_to_lanes(words: np.ndarray) -> np.ndarray:
    """int64 or uint64 (..., N) words -> uint32 (..., 2, S, L) pairs; int32
    words (narrow rows) -> a uint32 single plane (..., 1, S, L)."""
    words = np.ascontiguousarray(words)
    if words.dtype == np.int32:
        arr = words.view(np.uint32)[..., None, :]
    else:
        u = words.view(np.uint64)
        lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (u >> np.uint64(32)).astype(np.uint32)
        arr = np.stack([lo, hi], axis=-2)
    return arr.reshape(arr.shape[:-1] + _lane_shape(arr.shape[-1]))


def to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """tpufhe lane-folded residues -> a tpufhe_torch tensor on `device`."""
    return torch.from_numpy(lanes_to_words(arr)).to(device)


def from_tensor(t: torch.Tensor) -> np.ndarray:
    """A tpufhe_torch tensor -> tpufhe lane-folded uint32 residues."""
    return words_to_lanes(t.detach().cpu().numpy())


def secret_key(coeffs: np.ndarray, par):
    """A tpufhe_torch SecretKey from tpufhe's signed coefficients."""
    from tpufhe_torch.bfv.keys.secret_key import SecretKey

    return SecretKey(np.asarray(coeffs, dtype=np.int64), par)


def key_switching_key(par, seed: bytes, c0, c0_shoup, c1, c1_shoup,
                      level: int = 0, log_base: int = 0):
    """A tpufhe_torch KeySwitchingKey from tpufhe's ksk rows, ciphertext and
    key at `level`: each of c0, c0_shoup, c1, c1_shoup is a list (one per
    decomposition row) of lane-folded arrays, e.g.
    [np.asarray(p.coeffs) for p in ksk.c0]; log_base is tpufhe's
    ksk.log_base (nonzero for a single-modulus key)."""
    from tpufhe_torch.bfv.keys.key_switching_key import KeySwitchingKey

    def rows(arrs):
        return torch.from_numpy(
            np.stack([lanes_to_words(a) for a in arrs])).to(par.device)

    return KeySwitchingKey(par, seed, rows(c0), rows(c0_shoup), rows(c1),
                           rows(c1_shoup), level, level, log_base)



def relinearization_key(par, seed: bytes, c0, c0_shoup, c1, c1_shoup,
                        level: int = 0, log_base: int = 0):
    """A tpufhe_torch RelinearizationKey from tpufhe's ksk rows (as for
    key_switching_key)."""
    from tpufhe_torch.bfv.keys.relinearization_key import RelinearizationKey

    return RelinearizationKey(key_switching_key(
        par, seed, c0, c0_shoup, c1, c1_shoup, level, log_base))


def galois_key(par, exponent: int, seed: bytes, c0, c0_shoup, c1, c1_shoup,
               level: int = 0):
    """A tpufhe_torch GaloisKey for x -> x^exponent from tpufhe's ksk rows
    (as for relinearization_key), with ciphertext and key at `level`."""
    from tpufhe_torch.bfv.keys.galois_key import GaloisKey
    from tpufhe_torch.ops.rq import SubstitutionExponent

    element = SubstitutionExponent(par.context_at_level(level), exponent)
    return GaloisKey(element, key_switching_key(par, seed, c0, c0_shoup, c1,
                                                c1_shoup, level))


def evaluation_key(par, keys: dict, level: int = 0):
    """A tpufhe_torch EvaluationKey from tpufhe's Galois keys: `keys` maps
    each exponent to the arguments (seed, c0, c0_shoup, c1, c1_shoup) of
    galois_key. The monomials need no randomness and are rebuilt."""
    from tpufhe_torch.bfv.keys.evaluation_key import EvaluationKey, monomials

    gk = {e: galois_key(par, e, *args, level=level)
          for e, args in keys.items()}
    return EvaluationKey(par, level, level, gk,
                         EvaluationKey.construct_rot_to_gk_exponent(par),
                         monomials(par.context_at_level(level)))


def ciphertext(par, parts, level: int = 0, seed: bytes | None = None):
    """A tpufhe_torch Ciphertext from tpufhe's lane-folded parts."""
    from tpufhe_torch.bfv.ciphertext import Ciphertext

    return Ciphertext(par, [to_tensor(p, par.device) for p in parts], level,
                      seed)


def public_key(par, parts, level: int = 0):
    """A tpufhe_torch PublicKey from tpufhe's pk.c parts (lane-folded)."""
    from tpufhe_torch.bfv.keys.public_key import PublicKey

    return PublicKey(par, ciphertext(par, parts, level))


def plaintext(par, value, encoding, level: int = 0):
    """A tpufhe_torch Plaintext from tpufhe's pt.value (small t), its
    encoding (tpufhe's or the port's; None for none) and level."""
    from tpufhe_torch.bfv.encoding import Encoding
    from tpufhe_torch.bfv.plaintext import Plaintext

    enc = None if encoding is None else Encoding(encoding.encoding,
                                                 encoding.level)
    return Plaintext(par, np.asarray(value, dtype=np.uint64), enc, level)
