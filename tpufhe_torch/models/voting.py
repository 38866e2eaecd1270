"""Multiparty private voting (examples/voting.rs; tpufhe's models/voting.py):
a collective public key, encrypted ballots, a homomorphic tally and its
collective decryption."""

from __future__ import annotations

import numpy as np

from tpufhe_torch.bfv import (
    BfvParametersBuilder,
    Ciphertext,
    Encoding,
    Plaintext,
    SecretKey,
    ct_add,
)
from tpufhe_torch.mbfv import (
    CommonRandomPoly,
    DecryptionShare,
    PublicKeyShare,
    aggregate,
)
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64


def run_voting(num_voters=10, num_parties=3, degree=64,
               plaintext_modulus=1153, moduli=(4611686018326724609,), seed=7,
               device=None):
    """Returns (tally, expected_tally)."""
    par = (
        BfvParametersBuilder()
        .set_degree(degree)
        .set_plaintext_modulus(plaintext_modulus)
        .set_moduli(moduli)
        .set_device(device)
        .build()
    )
    rng = ChaCha8Rng(seed_from_u64(seed))
    crp = CommonRandomPoly.new(par, rng)

    parties = []
    for _ in range(num_parties):
        sk = SecretKey.random(par, rng)
        pk_share = PublicKeyShare.new(sk, crp, rng)
        parties.append((sk, pk_share))
    pk = aggregate([p[1] for p in parties])

    votes = [int(v) for v in
             np.random.default_rng(seed).integers(0, 2, size=num_voters)]
    tally = Ciphertext.zero(par)
    for v in votes:
        pt = Plaintext.try_encode([v], Encoding.poly(), par)
        ct = pk.try_encrypt(pt, rng)
        tally = ct if not tally.c else ct_add(tally, ct)

    shares = [DecryptionShare.new(sk, tally, rng) for sk, _ in parties]
    tally_pt = aggregate(shares)
    result = int(np.asarray(tally_pt.try_decode(Encoding.poly()))[0])
    return result, sum(votes)
