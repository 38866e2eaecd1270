"""RGSW external-product walkthrough (examples/rgsw.rs; tpufhe's
models/rgsw.py): encrypt one
operand as RGSW, multiply noise-additively via the external product,
compare against the regular ciphertext product, then mod-switch down and
report noise/size."""

from __future__ import annotations

import numpy as np

from tpufhe_torch.bfv import (
    Encoding,
    Plaintext,
    RGSWCiphertext,
    SecretKey,
    ct_mul,
)
from tpufhe_torch.models.util import default_parameters
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64


def run_rgsw(num_moduli=3, degree=16, seed=6, device=None,
             plaintext_modulus=None):
    """Returns a dict of results (examples/rgsw.rs:14-57)."""
    par = default_parameters(num_moduli, degree, device, plaintext_modulus)
    t = par.plaintext.value
    rng = ChaCha8Rng(seed_from_u64(seed))
    sk = SecretKey.random(par, rng)

    v1 = [1, 2, 3, 4]
    v2 = [5, 6, 7, 8]
    pt1 = Plaintext.try_encode(v1, Encoding.simd(), par)
    pt2 = Plaintext.try_encode(v2, Encoding.simd(), par)
    ct1 = sk.try_encrypt(pt1, rng)
    ct2 = sk.try_encrypt(pt2, rng)
    ct2_rgsw = RGSWCiphertext.encrypt(sk, pt2, rng)

    product = ct2_rgsw.external_product(ct1)
    expected = ct_mul(ct1, ct2)

    noise_before = sk.measure_noise(product)
    size_before = len(product.to_bytes())

    product.switch_to_level(product.max_switchable_level())
    noise_after = sk.measure_noise(product)
    size_after = len(product.to_bytes())

    got = np.asarray(sk.try_decrypt(product).try_decode(Encoding.simd()))
    want_exp = np.asarray(sk.try_decrypt(expected).try_decode(Encoding.simd()))
    want = [(a * b) % t for a, b in zip(v1, v2)]

    return {
        "product": (list(int(x) for x in got[: len(v1)]), want),
        "matches_ct_mul": (
            list(int(x) for x in got),
            list(int(x) for x in want_exp),
        ),
        "noise_bits": (noise_before, noise_after),
        "bytes": (size_before, size_after),
    }


if __name__ == "__main__":
    res = run_rgsw()
    print(f"RGSW external product = {res['product'][0]} "
          f"(want {res['product'][1]})")
    print(f"noise before/after mod switch: {res['noise_bits']} bits")
    print(f"serialized size before/after: {res['bytes']} bytes")
    assert res["product"][0] == res["product"][1]
    assert res["matches_ct_mul"][0] == res["matches_ct_mul"][1]
