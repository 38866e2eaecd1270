"""Homomorphic-operations walkthrough (examples/bfv_ops.rs; tpufhe's
models/bfv_ops.py): weighted sums, inner products, and polynomial
evaluation, each both without SIMD (one value per ciphertext) and with
SIMD batching + inner sum."""

from __future__ import annotations

import numpy as np

from tpufhe_torch.bfv import (
    Ciphertext,
    Encoding,
    EvaluationKeyBuilder,
    Plaintext,
    PublicKey,
    RelinearizationKey,
    SecretKey,
    ct_add,
    ct_add_pt,
    ct_mul,
    ct_mul_pt,
)
from tpufhe_torch.models.util import default_parameters
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64


def _decrypt_first(sk, ct, encoding):
    pt = sk.try_decrypt(ct)
    return int(np.asarray(pt.try_decode(encoding))[0])


def run_bfv_ops(num_moduli=3, degree=16, seed=5, device=None,
                plaintext_modulus=None):
    """Returns dict mapping each sub-demo to a (got, want) pair
    (examples/bfv_ops.rs:50-160)."""
    par = default_parameters(num_moduli, degree, device, plaintext_modulus)
    t = par.plaintext.value
    rng = ChaCha8Rng(seed_from_u64(seed))

    sk = SecretKey.random(par, rng)
    pk = PublicKey.new(sk, rng)
    ek = EvaluationKeyBuilder(sk).enable_inner_sum().build(rng)
    rk = RelinearizationKey.new(sk, rng)

    out = {}

    # ----- weighted sum without SIMD (bfv_ops.rs:21-36) -----
    values = [1, 2, 3]
    weights = [4, 5, 6]
    cts = [
        pk.try_encrypt(Plaintext.try_encode([v], Encoding.poly(), par), rng)
        for v in values
    ]
    acc = Ciphertext.zero(par)
    for ct, w in zip(cts, weights):
        pt_w = Plaintext.try_encode([w], Encoding.poly(), par)
        acc = ct_add(acc, ct_mul_pt(ct, pt_w))
    want = sum(v * w for v, w in zip(values, weights)) % t
    out["weighted_sum_plain"] = (_decrypt_first(sk, acc, Encoding.poly()), want)

    # ----- weighted sum with SIMD + inner sum (bfv_ops.rs:38-48) -----
    pt_vals = Plaintext.try_encode(values, Encoding.simd(), par)
    ct_vals = pk.try_encrypt(pt_vals, rng)
    pt_ws = Plaintext.try_encode(weights, Encoding.simd(), par)
    summed = ek.computes_inner_sum(ct_mul_pt(ct_vals, pt_ws))
    out["weighted_sum_simd"] = (_decrypt_first(sk, summed, Encoding.simd()), want)

    # ----- inner product without SIMD (bfv_ops.rs:87-113) -----
    v1, v2 = [1, 2, 3], [7, 8, 9]
    ct_v1 = [
        pk.try_encrypt(Plaintext.try_encode([v], Encoding.poly(), par), rng)
        for v in v1
    ]
    ct_v2 = [
        pk.try_encrypt(Plaintext.try_encode([v], Encoding.poly(), par), rng)
        for v in v2
    ]
    acc = Ciphertext.zero(par)
    for a, b in zip(ct_v1, ct_v2):
        prod = ct_mul(a, b)
        rk.relinearizes(prod)
        acc = ct_add(acc, prod)
    want_ip = sum(a * b for a, b in zip(v1, v2)) % t
    out["inner_product_plain"] = (
        _decrypt_first(sk, acc, Encoding.poly()),
        want_ip,
    )

    # ----- inner product with SIMD (bfv_ops.rs:115-125) -----
    ct1 = pk.try_encrypt(Plaintext.try_encode(v1, Encoding.simd(), par), rng)
    ct2 = pk.try_encrypt(Plaintext.try_encode(v2, Encoding.simd(), par), rng)
    prod = ct_mul(ct1, ct2)
    rk.relinearizes(prod)
    summed = ek.computes_inner_sum(prod)
    out["inner_product_simd"] = (
        _decrypt_first(sk, summed, Encoding.simd()),
        want_ip,
    )

    # ----- polynomial evaluation 3x^2 + 2x + 1, no SIMD (bfv_ops.rs:127-142) --
    x = 3
    ct_x = pk.try_encrypt(Plaintext.try_encode([x], Encoding.poly(), par), rng)
    ct_x2 = ct_mul(ct_x, ct_x)
    rk.relinearizes(ct_x2)
    res = ct_mul_pt(ct_x2, Plaintext.try_encode([3], Encoding.poly(), par))
    res = ct_add(res, ct_mul_pt(ct_x, Plaintext.try_encode([2], Encoding.poly(), par)))
    res = ct_add_pt(res, Plaintext.try_encode([1], Encoding.poly(), par))
    out["poly_eval_plain"] = (
        _decrypt_first(sk, res, Encoding.poly()),
        (3 * x * x + 2 * x + 1) % t,
    )

    # ----- polynomial evaluation with SIMD (bfv_ops.rs:144-158) -----
    x_vec = [1, 2, 3, 4]
    ct_xv = pk.try_encrypt(
        Plaintext.try_encode(x_vec, Encoding.simd(), par), rng
    )
    ct_xv2 = ct_mul(ct_xv, ct_xv)
    rk.relinearizes(ct_xv2)
    n = len(x_vec)
    res = ct_mul_pt(
        ct_xv2, Plaintext.try_encode([3] * n, Encoding.simd(), par)
    )
    res = ct_add(
        res,
        ct_mul_pt(ct_xv, Plaintext.try_encode([2] * n, Encoding.simd(), par)),
    )
    res = ct_add_pt(res, Plaintext.try_encode([1] * n, Encoding.simd(), par))
    got_v = np.asarray(sk.try_decrypt(res).try_decode(Encoding.simd()))[:n]
    want_v = [(3 * v * v + 2 * v + 1) % t for v in x_vec]
    out["poly_eval_simd"] = (list(int(v) for v in got_v), want_v)

    return out


if __name__ == "__main__":
    for name, (got, want) in run_bfv_ops().items():
        status = "ok" if got == want else "MISMATCH"
        print(f"{name}: got={got} want={want} [{status}]")
