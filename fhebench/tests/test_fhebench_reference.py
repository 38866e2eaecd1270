"""The reference (fhebench/reference/) against the port at degree 64 on
the CPU: the same streams, primes, transforms, keys, encryptions,
decryptions, encodings and wire format. The test imports both; the
reference imports nothing of the program."""

import ast
import os

import numpy as np
import pytest

from fhebench.reference import bfv, chacha, ring
from tpufhe_torch.bfv import (
    BfvParametersBuilder,
    Ciphertext,
    Encoding,
    EvaluationKeyBuilder,
    Plaintext,
    RelinearizationKey,
    SecretKey,
)
from tpufhe_torch.models.util import database_rows
from tpufhe_torch.ops import ntt as port_ntt
from tpufhe_torch.ops.zq import Modulus
from tpufhe_torch.pipeline import make_mul_relin
from tpufhe_torch.utils import rngs, sampling

N = 64
SEED = 2 ** 33 + 17


def words(t):
    return t.numpy().astype(np.uint64)


def port_params(sizes, t=65537):
    return (BfvParametersBuilder().set_degree(N).set_plaintext_modulus(t)
            .set_moduli_sizes(sizes).set_device("cpu").build())


def test_reference_imports_nothing_of_the_program():
    ref = os.path.dirname(bfv.__file__)
    allowed = {"__future__", "dataclasses", "functools", "hashlib", "numpy",
               "fhebench"}
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module]
            else:
                mods = []
            for m in mods:
                assert m.split(".")[0] in allowed, (name, m)
                if m.startswith("fhebench"):
                    assert m.startswith("fhebench.reference"), (name, m)


def test_streams_equal_the_port():
    seed = rngs.seed_from_u64(SEED)
    assert seed == chacha.seed_from_u64(SEED)
    r, s = rngs.ChaCha8Rng(seed), chacha.Stream(seed)
    assert [r.next_u32() for _ in range(37)] == list(s.take(37))
    assert (sampling.sample_vec_cbd(1000, 10, r)
            == chacha.cbd(s, 1000, 10)).all()
    assert r.fill_bytes(32) == s.bytes(32)
    p = (1 << 62) - 57
    assert list(rngs.uniform_u64_below(r, p, 3000).astype(object)) == \
        list(chacha.uniform_below(s, p, 3000))
    assert rngs.random_range_u64(r, p) == chacha.random_range(s, p)


@pytest.mark.parametrize("sizes", [(62, 62, 62), (50, 55, 55)])
def test_primes_and_transforms_equal_the_port(sizes):
    moduli = ring.generate_moduli(sizes, N)
    assert moduli == list(port_params(list(sizes)).moduli)
    x = np.stack([np.random.default_rng(1).integers(0, p, (3, N),
                                                    dtype=np.uint64)
                  for p in moduli], axis=1)
    y = ring.forward(x, moduli)
    for j, p in enumerate(moduli):
        op = port_ntt.NttOperator.new(Modulus(p), N)
        assert (op.forward_host(x[0, j]) == y[0, j]).all()
    assert (ring.backward(y, moduli) == x).all()


def test_mulmod_is_exact_at_the_edges():
    for p in ring.generate_moduli([62, 50], N):
        a = np.array([p - 1, p - 2, 1, 0, p // 2], dtype=np.uint64)
        b = np.array([p - 1, p - 1, p - 1, p - 1, p - 3], dtype=np.uint64)
        got = ring.mulmod(a, b, np.full(5, p, dtype=np.uint64))
        assert list(got.astype(object)) == [int(u) * int(v) % p
                                            for u, v in zip(a, b)]


@pytest.mark.parametrize("sizes,t", [((62, 62, 62), 65537), ((50,), 1785857)])
def test_scale_round_equals_the_exact_lift(sizes, t):
    """Decryption's scale, long double and all, against round(t x / Q) of
    the CRT lift in Python integers, the extreme residues included."""
    moduli = ring.generate_moduli(sizes, N)
    g = np.random.default_rng(4)
    x = np.stack([g.integers(0, p, (50, N), dtype=np.uint64) for p in moduli],
                 axis=1)
    x[0, :, :3] = np.array(moduli, dtype=np.uint64)[:, None] - 1
    x[0, :, 3:6] = 0
    q = 1
    for p in moduli:
        q *= p
    want = (2 * t * ring.crt(x, moduli) + q) // (2 * q) % t
    assert (ring.scale_round(x, moduli, t) == want.astype(np.uint64)).all()


def test_keys_encryptions_and_products_equal_the_port():
    par = port_params([62, 62, 62])
    rng = rngs.ChaCha8Rng(rngs.seed_from_u64(SEED))
    sk = SecretKey.random(par, rng)
    rk = RelinearizationKey.new(sk, rng)
    g = np.random.default_rng(5)
    va, vb = (g.integers(0, 65537, N, dtype=np.uint64) for _ in range(2))
    ca, cb = (sk.try_encrypt(Plaintext.try_encode(v, Encoding.simd(), par),
                             rng) for v in (va, vb))
    ek = EvaluationKeyBuilder(sk).enable_inner_sum().build(rng)
    ref = bfv.Params(N, 65537, (62, 62, 62))
    rep = bfv.Replay(ref, SEED)
    assert (rep.s == sk.coeffs).all()
    c0, c1 = rep.relin_key(0)
    assert (c0 == words(rk.ksk.c0)).all() and (c1 == words(rk.ksk.c1)).all()
    for v, ct in ((va, ca), (vb, cb)):
        e0, e1, _ = rep.encryption(bfv.simd_encode(ref, v), 0)
        assert (e0 == words(ct[0])).all() and (e1 == words(ct[1])).all()
    for e in sorted(ek.gk):
        k0, k1 = rep.galois_key(e, 0, 0)
        assert (k0 == words(ek.gk[e].ksk.c0)).all()
        assert (k1 == words(ek.gk[e].ksk.c1)).all()
    o0, o1 = make_mul_relin(par, rk)(ca[0], ca[1], cb[0], cb[1])
    pt = rep.decrypt(words(o0), words(o1), 0)
    assert (bfv.simd_decode(ref, pt) == va * vb % 65537).all()
    dec = sk.try_decrypt(Ciphertext(par, [o0, o1], 0))
    assert (np.asarray(dec.value, dtype=np.uint64) == pt).all()
    parts, level, seed = bfv.parse_ciphertext(
        ref, Ciphertext(par, [o0, o1], 0).to_bytes())
    assert level == 0 and seed == b"" and len(parts) == 2
    assert (rep.decrypt(parts[0], parts[1], 0, ntt=False) == pt).all()


def test_leveled_keys_queries_and_rows_equal_the_port():
    t = 1785857
    par = port_params([50, 55, 55], t)
    rng = rngs.ChaCha8Rng(rngs.seed_from_u64(SEED))
    sk = SecretKey.random(par, rng)
    ek = (EvaluationKeyBuilder(sk, ciphertext_level=1, evaluation_key_level=0)
          .enable_expansion(3).build(rng))
    rk = RelinearizationKey.new(sk, rng, ciphertext_level=1, key_level=1)
    m = np.arange(9, dtype=np.uint64) * 1000
    q = sk.try_encrypt(Plaintext.try_encode(m, Encoding.poly(1), par), rng)
    ref = bfv.Params(N, t, (50, 55, 55))
    rep = bfv.Replay(ref, SEED)
    for e in sorted(ek.gk):
        k0, k1 = rep.galois_key(e, 1, 0)
        assert (k0 == words(ek.gk[e].ksk.c0)).all()
        assert (k1 == words(ek.gk[e].ksk.c1)).all()
    c0, c1 = rep.relin_key(1)
    assert (c0 == words(rk.ksk.c0)).all() and (c1 == words(rk.ksk.c1)).all()
    want0, _, seed = rep.encryption(m, 1)
    parts, level, got_seed = bfv.parse_ciphertext(ref, q.to_bytes())
    assert level == 1 and got_seed == seed and len(parts) == 1
    assert (ring.forward(parts[0], ref.level_moduli(1)) == want0).all()
    db = np.random.default_rng(3).integers(0, 256, (30, 8), dtype=np.uint8)
    values, _ = database_rows(db, par)
    for row in range(values.shape[0]):
        assert (bfv.pir_row_values(ref, db, row) == values[row]).all()


@pytest.mark.parametrize("entropy", ["fhe.rs", "full"])
def test_reference_mulpir_answer_equals_the_port(entropy, monkeypatch):
    """The reference's MulPIR server (reference/pir.py) gives the harness's
    answer word for word, from the same query, keys and database: fhe.rs's
    database and one of random bytes."""
    from fhebench.reference import pir
    from fhebench.trace import Recorder
    from fhebench.traffic import mulpir
    from fhebench.tests.tiny import TINY_CONFIG

    config = {**bfv_config("mulpir-n8192-64k-1k"), **TINY_CONFIG}
    mix = {"batch": 1, "pool": 3, "check_queries": 3}
    if entropy == "full":
        full = np.random.default_rng(5).integers(
            0, 256, (config["database_size"], config["element_size"]),
            dtype=np.uint8)
        monkeypatch.setattr(mulpir, "database", lambda config: full)
    db = mulpir.database(config)
    cell = mulpir.setup(config, mix, SEED, "cpu")
    a = 2
    got, level, _ = bfv.parse_ciphertext(
        bfv.Params(N, config["plaintext_modulus"],
                   tuple(config["moduli_sizes"])),
        cell.serve([cell.queries[a]], Recorder(False))[0])
    ref = bfv.Params(N, config["plaintext_modulus"],
                     tuple(config["moduli_sizes"]))
    rep = bfv.Replay(ref, SEED)
    gk, rk = mulpir.replay_keys(config, rep)
    lvl = config["query_level"]
    rep.skip_encryptions(a)
    idx = int(mulpir.query_indices(config, mix, SEED)[a])
    c0, c1, _ = rep.encryption(mulpir.query_plaintext(config, idx), lvl)
    per, dim1, dim2, _ = mulpir.layout(config)
    want = pir.answer(ref, rep, gk, rk, (c0, c1),
                      lambda r: bfv.pir_row_values(ref, db, r), (dim1, dim2),
                      lvl, config["expansion_key_level"])
    assert level == 2
    assert (got[0] == want[0]).all() and (got[1] == want[1]).all()
    row = bfv.pir_row_values(ref, db, idx // per)
    assert (rep.decrypt(want[0], want[1], 2, ntt=False) == row).all()
    assert pir.noise_bits(rep, want[0], want[1], row, 2) < \
        np.log2(ref.moduli[0] / (2 * ref.plaintext))


def bfv_config(name):
    import json

    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "configs", f"{name}.json")) as f:
        return json.load(f)


def test_pir_margin_runs_and_the_reference_agrees():
    """The witness of PERF.md's MulPIR finding at degree 64: every answer
    right, and the reference's answer equal to the program's."""
    from fhebench.tests import pir_margin
    from fhebench.tests.tiny import TINY_CONFIG

    config = {**bfv_config("mulpir-n8192-64k-1k"), **TINY_CONFIG}
    lines = []
    pir_margin.margins(config, {"batch": 1, "pool": 3, "check_queries": 3},
                       SEED, "cpu", 1,
                       emit=lines.append)
    rows = [__import__("json").loads(x) for x in lines]
    assert len(rows) == 7
    assert all(r["wrong"] == 0 for r in rows)
    assert rows[-1]["words_off"] == 0
