"""The port's multiparty protocols (tpufhe_torch.mbfv) against tpufhe's,
bit-exact (tolerance 0: equal residues, equal bytes), on parties, shares
and keys made by both packages from one ChaCha8 seed:

- the common random polynomial, every PublicKeyShare and the collective
  public key (Protocol 1);
- encryption under that key and every DecryptionShare and their aggregate
  (the key switch to the zero key and the t/q scale), small t and
  t = 2^127 - 1 (the CRT-lifted fold);
- SecretKeySwitchShare to a second set of party keys (Protocol 3) and
  PublicKeySwitchShare of a level-1 ciphertext to a one-party public key,
  the collective key switched down to level 1 (Protocol 4), each decrypted
  by its output key;
- the two rounds of RelinKeyGenerator (Protocol 2): u, both rounds' shares
  and aggregates, the collective key's rows, Shoup constants and bytes,
  and a product relinearized with it and decrypted collectively;
- the errors, each with tpufhe's class and message.

At degree 16, where tpufhe's object API runs quickly on the CPU.
"""

import numpy as np
import pytest
import torch

import tpufhe.bfv as JB
import tpufhe.mbfv as JM
from tpufhe import errors as JE
from tpufhe.bfv.ops import ct_mul as j_ct_mul
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed

import tpufhe_torch.bfv as TB
import tpufhe_torch.mbfv as TM
from tpufhe_torch import convert
from tpufhe_torch import errors as TE
from tpufhe_torch.bfv.ops import ct_mul as t_ct_mul
from tpufhe_torch.utils.rngs import ChaCha8Rng as TRng
from tpufhe_torch.utils.rngs import seed_from_u64 as t_seed

DEGREE = 16
PARTIES = 5
M127 = (1 << 127) - 1
SIDES = {"tpufhe": (JB, JM, JE, JRng, j_seed, j_ct_mul),
         "port": (TB, TM, TE, TRng, t_seed, t_ct_mul)}


def words(x) -> np.ndarray:
    """Residues of a poly, tensor or tpufhe array as (..., k, N) words."""
    c = getattr(x, "coeffs", x)
    if isinstance(c, torch.Tensor):
        return c.numpy()
    return convert.lanes_to_words(np.asarray(c))


def ct_words(ct) -> list:
    return [words(ct[i]) for i in range(len(ct))] + [ct.level]


def params(side, sizes, t=65537, degree=DEGREE):
    B = SIDES[side][0]
    b = (B.BfvParametersBuilder().set_degree(degree)
         .set_plaintext_modulus(t).set_moduli_sizes(sizes))
    return (b.set_device("cpu") if side == "port" else b).build()


def values(t, seed, n=DEGREE):
    return np.random.default_rng(seed).integers(0, t, n, dtype=np.uint64)


def protocols(side, seed=2041, sizes=(62, 62, 62), t=65537):
    """Every protocol once, in one stream; returns what each step made."""
    B, M, _, Rng, seed_from, ct_mul = SIDES[side]
    par = params(side, list(sizes), t)
    rng = Rng(seed_from(seed))
    sks = [B.SecretKey.random(par, rng) for _ in range(PARTIES)]
    out = {}
    crp = M.CommonRandomPoly.new(par, rng)
    pk_shares = [M.PublicKeyShare.new(sk, crp, rng) for sk in sks]
    pk = M.aggregate(pk_shares)
    out["crp"] = words(crp.poly)
    out["p0_shares"] = [words(s.p0_share) for s in pk_shares]
    out["pk"] = ct_words(pk.c)

    def decrypt(keys, ct, encoding):
        shares = [M.DecryptionShare.new(sk, ct, rng) for sk in keys]
        pt = M.aggregate(shares)
        return ([words(s.sks_share.h_share) for s in shares],
                np.asarray(pt.value).astype(np.uint64),
                np.asarray(pt.try_decode(encoding)))

    v = values(t, seed)
    ct = pk.try_encrypt(B.Plaintext.try_encode(v, B.Encoding.poly(), par), rng)
    out["ct"] = ct_words(ct)
    out["dec_shares"], out["dec_value"], out["dec"] = decrypt(
        sks, ct, B.Encoding.poly())

    # Protocol 3: to a second set of party keys
    outs = [B.SecretKey.random(par, rng) for _ in range(PARTIES)]
    sks_shares = [M.SecretKeySwitchShare.new(si, so, ct, rng)
                  for si, so in zip(sks, outs)]
    ct_sks = M.aggregate(sks_shares)
    out["sks_shares"] = [words(s.h_share) for s in sks_shares]
    out["sks"] = ct_words(ct_sks)
    out["sks_dec"] = decrypt(outs, ct_sks, B.Encoding.poly())[2]

    # Protocol 4: a level-1 ciphertext to a one-party public key
    sk_o = B.SecretKey.random(par, rng)
    pk_o = B.PublicKey.new(sk_o, rng)
    ct1 = pk.try_encrypt(B.Plaintext.try_encode(v, B.Encoding.poly(1), par),
                         rng)
    pks_shares = [M.PublicKeySwitchShare.new(sk, pk_o, ct1, rng) for sk in sks]
    ct_pks = M.aggregate(pks_shares)
    out["ct1"] = ct_words(ct1)
    out["pks_shares"] = [[words(s.h0_share), words(s.h1_share)]
                         for s in pks_shares]
    out["pks"] = ct_words(ct_pks)
    out["pks_dec"] = np.asarray(
        sk_o.try_decrypt(ct_pks).try_decode(B.Encoding.poly()))

    # Protocol 2: the two-round relinearization key
    crp_vec = M.CommonRandomPoly.new_vec(par, rng)
    gens = [M.RelinKeyGenerator(sk, crp_vec, rng) for sk in sks]
    r1 = [g.round_1(rng) for g in gens]
    agg1 = M.aggregate(r1)
    r2 = [g.round_2(agg1, rng) for g in gens]
    rk = M.aggregate(r2)
    out["u"] = [words(g.u) for g in gens]
    out["r1"] = [[words(p) for p in sh.h0 + sh.h1] for sh in r1]
    out["agg1"] = [words(p) for p in agg1.h0 + agg1.h1]
    out["r2"] = [[words(p) for p in sh.h0 + sh.h1] for sh in r2]
    ksk = rk.ksk
    out["rk_meta"] = (ksk.seed, ksk.log_base, ksk.ciphertext_level,
                      ksk.ksk_level)
    if side == "port":
        out["rk"] = [ksk.c0.numpy(), ksk.c0_shoup.numpy(), ksk.c1.numpy(),
                     ksk.c1_shoup.numpy()]
    else:
        out["rk"] = [np.stack([words(p.coeffs_shoup if sh else p) for p in rows])
                     for rows in (ksk.c0, ksk.c1) for sh in (False, True)]
    out["rk_bytes"] = rk.to_bytes()
    va, vb = values(t, seed + 1), values(t, seed + 2)
    ca, cb = (pk.try_encrypt(B.Plaintext.try_encode(x, B.Encoding.simd(), par),
                             rng) for x in (va, vb))
    prod = ct_mul(ca, cb)
    rk.relinearizes(prod)
    out["prod"] = ct_words(prod)
    out["prod_dec"] = decrypt(sks, prod, B.Encoding.simd())[2]
    out["want"] = (v, (va.astype(object) * vb % t).astype(np.uint64))
    return out


@pytest.fixture(scope="module")
def runs():
    return {side: protocols(side) for side in SIDES}


def same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("step", ["crp", "p0_shares", "pk", "ct"])
def test_public_key_shares_and_collective_key_match_tpufhe(runs, step):
    same(runs["port"][step], runs["tpufhe"][step])


def test_decryption_shares_and_aggregate_match_tpufhe(runs):
    j, t = runs["tpufhe"], runs["port"]
    same(t["dec_shares"], j["dec_shares"])
    same(t["dec_value"], j["dec_value"])
    np.testing.assert_array_equal(t["dec"], t["want"][0])


def test_secret_key_switch_matches_tpufhe(runs):
    j, t = runs["tpufhe"], runs["port"]
    same(t["sks_shares"], j["sks_shares"])
    same(t["sks"], j["sks"])
    np.testing.assert_array_equal(t["sks_dec"], t["want"][0])


def test_public_key_switch_at_level_1_matches_tpufhe(runs):
    j, t = runs["tpufhe"], runs["port"]
    assert t["ct1"][-1] == 1 and t["pks"][-1] == 1
    same(t["ct1"], j["ct1"])
    same(t["pks_shares"], j["pks_shares"])
    same(t["pks"], j["pks"])
    np.testing.assert_array_equal(t["pks_dec"], t["want"][0])


@pytest.mark.parametrize("step", ["u", "r1", "agg1", "r2"])
def test_relin_key_rounds_match_tpufhe(runs, step):
    same(runs["port"][step], runs["tpufhe"][step])


def test_collective_relinearization_key_matches_tpufhe(runs):
    """The aggregated key: c0 = h0 + h1 of round 2, c1 = round 1's
    aggregated h1, their Shoup constants, no seed, log_base 0, and the
    same proto3 bytes (the seedless key writes c1)."""
    j, t = runs["tpufhe"], runs["port"]
    assert t["rk_meta"] == j["rk_meta"] == (None, 0, 0, 0)
    same(t["rk"], j["rk"])
    np.testing.assert_array_equal(t["rk"][2], np.stack(t["agg1"][3:]))
    assert t["rk_bytes"] == j["rk_bytes"]
    rk = TB.RelinearizationKey.from_bytes(j["rk_bytes"],
                                          params("port", [62] * 3))
    assert rk.ksk.seed is None
    same([rk.ksk.c0.numpy(), rk.ksk.c0_shoup.numpy(), rk.ksk.c1.numpy(),
          rk.ksk.c1_shoup.numpy()], t["rk"])


def test_collective_key_relinearizes_a_product(runs):
    j, t = runs["tpufhe"], runs["port"]
    same(t["prod"], j["prod"])
    np.testing.assert_array_equal(t["prod_dec"], t["want"][1])
    np.testing.assert_array_equal(j["prod_dec"], t["want"][1])


def large_t_decryption(side, seed=2043):
    """Collective decryption at t = 2^127 - 1 (the CRT-lifted fold)."""
    B, M, _, Rng, seed_from, _ = SIDES[side]
    par = params(side, [60] * 5, M127)
    rng = Rng(seed_from(seed))
    sks = [B.SecretKey.random(par, rng) for _ in range(3)]
    crp = M.CommonRandomPoly.new(par, rng)
    pk = M.aggregate([M.PublicKeyShare.new(sk, crp, rng) for sk in sks])
    v = [0] * DEGREE
    v[0], v[1], v[2] = 123456789, M127 - 1, M127 // 2
    ct = pk.try_encrypt(B.Plaintext.try_encode(v, B.Encoding.poly(), par), rng)
    pt = M.aggregate([M.DecryptionShare.new(sk, ct, rng) for sk in sks])
    return [int(x) for x in pt.value], v


def test_large_t_decryption_share_matches_tpufhe():
    (jv, want), (tv, _) = (large_t_decryption(s) for s in SIDES)
    assert tv == jv == want


def errors(side):
    """(class name, message) of each refusal of the protocols."""
    B, M, E, Rng, seed_from, _ = SIDES[side]
    par = params(side, [62] * 2)
    other = params(side, [62] * 3)
    single = params(side, [62])
    rng = Rng(seed_from(5))
    sk, sk_other = B.SecretKey.random(par, rng), B.SecretKey.random(other, rng)
    crp = M.CommonRandomPoly.new(par, rng)
    pk = M.aggregate([M.PublicKeyShare.new(sk, crp, rng)])
    ct = pk.try_encrypt(B.Plaintext.try_encode([1], B.Encoding.poly(), par),
                        rng)
    ct3 = B.Ciphertext(par, list(ct.c) + [ct.c[1]], ct.level)
    cases = [
        lambda: M.aggregate([]),
        lambda: M.SecretKeySwitchShare.new(sk, sk_other, ct, rng),
        lambda: M.SecretKeySwitchShare.new(sk, sk, ct3, rng),
        lambda: M.DecryptionShare.new(sk, ct3, rng),
        lambda: M.PublicKeySwitchShare.new(sk_other, pk, ct, rng),
        lambda: M.RelinKeyGenerator(sk, [crp], rng),
        lambda: M.RelinKeyGenerator(B.SecretKey.random(single, rng),
                                    M.CommonRandomPoly.new_vec(single, rng),
                                    rng),
    ]
    out = []
    for case in cases:
        with pytest.raises(E.FheError) as info:
            case()
        out.append((type(info.value).__name__, str(info.value)))
    return out


def test_protocol_errors_match_tpufhe():
    j, t = errors("tpufhe"), errors("port")
    assert t == j
    assert [name for name, _ in t] == [
        "TooFewValues", "ContextMismatch", "InvalidCiphertext",
        "InvalidCiphertext", "ContextMismatch", "DimensionMismatch",
        "UnsupportedOperation"]
