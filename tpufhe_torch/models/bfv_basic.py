"""Basic BFV walkthrough (examples/bfv_basic.rs; tpufhe's models/bfv_basic.py):
encrypt two SIMD vectors, add, multiply with relinearization, decrypt and
verify."""

from __future__ import annotations

import numpy as np

from tpufhe_torch.bfv import (
    Encoding,
    Plaintext,
    RelinearizationKey,
    SecretKey,
    ct_add,
    ct_mul,
)
from tpufhe_torch.models.util import default_parameters
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64


def run_bfv_basic(num_moduli=3, degree=16, seed=3, device=None,
                  plaintext_modulus=None):
    """Returns a dict of results, each a (got, want) pair, and the noise."""
    par = default_parameters(num_moduli, degree, device, plaintext_modulus)
    t = par.plaintext.value
    rng = ChaCha8Rng(seed_from_u64(seed))
    nprng = np.random.default_rng(seed)

    sk = SecretKey.random(par, rng)
    rk = RelinearizationKey.new(sk, rng)

    va = nprng.integers(0, t, size=degree, dtype=np.uint64)
    vb = nprng.integers(0, t, size=degree, dtype=np.uint64)
    ca = sk.try_encrypt(Plaintext.try_encode(va, Encoding.simd(), par), rng)
    cb = sk.try_encrypt(Plaintext.try_encode(vb, Encoding.simd(), par), rng)

    s = ct_add(ca, cb)
    got_sum = np.asarray(sk.try_decrypt(s).try_decode(Encoding.simd()))
    want_sum = ((va.astype(object) + vb.astype(object)) % t).astype(np.uint64)

    p = ct_mul(ca, cb)
    rk.relinearizes(p)
    got_prod = np.asarray(sk.try_decrypt(p).try_decode(Encoding.simd()))
    want_prod = ((va.astype(object) * vb.astype(object)) % t).astype(np.uint64)

    return {
        "add": (got_sum.tolist(), want_sum.tolist()),
        "mul_relin": (got_prod.tolist(), want_prod.tolist()),
        "noise_bits": sk.measure_noise(p),
    }
