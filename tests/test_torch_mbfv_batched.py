"""The port's batched all-parties programs (tpufhe_torch.mbfv.batched)
against its object API and tpufhe's batched programs, bit-exact (equal
residues, equal bytes), on one ChaCha8 stream each:

- batched_public_key, batched_decryption and batched_relin_keygen (the
  collective key's rows, Shoup constants and proto3 bytes);
- psum_mod / make_sharded_pk_aggregation over a gloo group of 2, 3 and 4
  processes (each holding some parties' shares), equal to tpufhe's
  make_sharded_pk_aggregation on the 8-device CPU mesh; at the top of the
  range (every residue p - 1, 2^16 - 1 parties folded into each of two
  ranks) against exact Python ints, wide and narrow; and its refusal
  without a process group.

The workers are subprocesses that import only tpufhe_torch, rendezvous
through a FileStore under the test's tmp_path (no port is opened) and
have a process-group timeout (test_torch_ntt_dist.run_gloo: each worker
logs to its own file, and all share one deadline).
"""

import jax
import numpy as np
import pytest
import torch

import tpufhe.bfv as JB
import tpufhe.mbfv as JM
from tpufhe.bfv.ops import ct_mul as j_ct_mul
from tpufhe.mbfv import batched as JBatch
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed

import tpufhe_torch.bfv as TB
import tpufhe_torch.mbfv as TM
from tpufhe_torch import convert
from tpufhe_torch.bfv.ops import ct_mul as t_ct_mul
from tpufhe_torch.mbfv import batched as TBatch
from tpufhe_torch.utils.rngs import ChaCha8Rng as TRng
from tpufhe_torch.utils.rngs import seed_from_u64 as t_seed

from test_torch_ntt_dist import run_gloo

DEGREE = 16
PARTIES = 5


def words(x) -> np.ndarray:
    c = getattr(x, "coeffs", x)
    if isinstance(c, torch.Tensor):
        return c.numpy()
    return convert.lanes_to_words(np.asarray(c))


class Side:
    """Parameters, party keys and CRPs of one package from one seed."""

    def __init__(self, B, M, Rng, seed_from, sizes=(62, 62), seed=1234):
        b = (B.BfvParametersBuilder().set_degree(DEGREE)
             .set_plaintext_modulus(65537).set_moduli_sizes(list(sizes)))
        self.par = (b.set_device("cpu") if B is TB else b).build()
        self.B, self.M, self.Rng, self.seed_from = B, M, Rng, seed_from
        r = self.rng(seed)
        self.sks = [B.SecretKey.random(self.par, r) for _ in range(PARTIES)]
        self.crp = M.CommonRandomPoly.new(self.par, r)
        self.crp_vec = M.CommonRandomPoly.new_vec(self.par, r)

    def rng(self, seed):
        return self.Rng(self.seed_from(seed))

    def object_pk(self, seed):
        r = self.rng(seed)
        return self.M.aggregate([self.M.PublicKeyShare.new(sk, self.crp, r)
                                 for sk in self.sks])

    def object_rk(self, seed):
        r = self.rng(seed)
        gens = [self.M.RelinKeyGenerator(sk, self.crp_vec, r)
                for sk in self.sks]
        agg1 = self.M.aggregate([g.round_1(r) for g in gens])
        return self.M.aggregate([g.round_2(agg1, r) for g in gens])

    def ciphertext(self, pk, seed):
        v = np.arange(DEGREE, dtype=np.uint64) * 4099 % 65537
        pt = self.B.Plaintext.try_encode(v, self.B.Encoding.poly(), self.par)
        return pk.try_encrypt(pt, self.rng(seed)), v


@pytest.fixture(scope="module")
def sides():
    return (Side(JB, JM, JRng, j_seed), Side(TB, TM, TRng, t_seed))


def pk_words(pk):
    return [words(pk.c[0]), words(pk.c[1])]


def rk_words(rk):
    ksk = rk.ksk
    if isinstance(ksk.c0, torch.Tensor):
        return [ksk.c0.numpy(), ksk.c0_shoup.numpy(), ksk.c1.numpy(),
                ksk.c1_shoup.numpy()]
    return [np.stack([words(p.coeffs_shoup if sh else p) for p in rows])
            for rows in (ksk.c0, ksk.c1) for sh in (False, True)]


def test_batched_public_key_matches_object_api_and_tpufhe(sides):
    j, t = sides
    got = pk_words(TBatch.batched_public_key(t.sks, t.crp, t.rng(777)))
    for want in (pk_words(t.object_pk(777)), pk_words(j.object_pk(777)),
                 pk_words(JBatch.batched_public_key(j.sks, j.crp,
                                                    j.rng(777)))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_batched_decryption_matches_object_api_and_tpufhe(sides):
    j, t = sides
    t_ct, v = t.ciphertext(t.object_pk(5), 6)
    j_ct, _ = j.ciphertext(j.object_pk(5), 6)
    for i in range(2):
        np.testing.assert_array_equal(words(t_ct[i]), words(j_ct[i]))
    got = TBatch.batched_decryption(t.sks, t_ct, t.rng(888))
    r = t.rng(888)
    obj = TM.aggregate([TM.DecryptionShare.new(sk, t_ct, r) for sk in t.sks])
    ref = JBatch.batched_decryption(j.sks, j_ct, j.rng(888))
    np.testing.assert_array_equal(got.value, obj.value)
    np.testing.assert_array_equal(got.value, np.asarray(ref.value))
    np.testing.assert_array_equal(got.try_decode(TB.Encoding.poly()), v)
    np.testing.assert_array_equal(got.poly_ntt.numpy(), words(ref.poly_ntt))


def test_batched_relin_keygen_matches_object_api_and_tpufhe(sides):
    j, t = sides
    got = TBatch.batched_relin_keygen(t.sks, t.crp_vec, t.rng(999))
    ref = JBatch.batched_relin_keygen(j.sks, j.crp_vec, j.rng(999))
    for want in (rk_words(t.object_rk(999)), rk_words(ref)):
        for a, b in zip(rk_words(got), want):
            np.testing.assert_array_equal(a, b)
    assert got.ksk.seed is None and got.ksk.log_base == 0
    assert got.to_bytes() == ref.to_bytes()


def test_batched_relin_key_multiplies_collectively(sides):
    """The batched key relinearizes a product under the batched public
    key; decrypted by batched_decryption, equal to tpufhe's slots."""
    out = []
    for s, batch, ct_mul in zip(sides, (JBatch, TBatch), (j_ct_mul, t_ct_mul)):
        rk = batch.batched_relin_keygen(s.sks, s.crp_vec, s.rng(31))
        r = s.rng(32)
        pk = batch.batched_public_key(s.sks, s.crp, r)
        vals = np.random.default_rng(33).integers(0, 65537, (2, DEGREE),
                                                  dtype=np.uint64)
        cts = [pk.try_encrypt(s.B.Plaintext.try_encode(
            v, s.B.Encoding.simd(), s.par), r) for v in vals]
        prod = ct_mul(*cts)
        rk.relinearizes(prod)
        pt = batch.batched_decryption(s.sks, prod, r)
        out.append(np.asarray(pt.try_decode(s.B.Encoding.simd())))
        want = (vals[0].astype(object) * vals[1] % 65537).astype(np.uint64)
        np.testing.assert_array_equal(out[-1], want)
    np.testing.assert_array_equal(out[0], out[1])


# ---------------------------------------------------------------------------
# aggregation across processes (gloo)
# ---------------------------------------------------------------------------

WORKER = r"""
from tpufhe_torch.bfv import BfvParametersBuilder
from tpufhe_torch.mbfv.batched import make_sharded_pk_aggregation, psum_mod

par = (BfvParametersBuilder().set_degree(spec["degree"])
       .set_plaintext_modulus(spec["t"]).set_moduli(spec["moduli"])
       .set_device("cpu").build())
shares = torch.from_numpy(data["shares"])
if spec["mode"] == "pk":
    out["sum"] = make_sharded_pk_aggregation(par)(shares[rank::world]).numpy()
else:  # this rank's slice of the parties, folded by psum_mod itself
    out["sum"] = psum_mod(shares[rank::world], par.context_at_level(0),
                          dim=0).numpy()
"""


def gloo_sum(tmp_path, world: int, shares: np.ndarray, par, mode="pk"):
    """Every rank's output of a gloo run over `world` worker processes
    (test_torch_ntt_dist.run_gloo: a log file each, one deadline), rank r
    holding the parties r, r + world, ... of `shares`."""
    spec = {"degree": par.degree(), "t": par.plaintext.value,
            "moduli": [int(m) for m in par.moduli], "mode": mode}
    outs = run_gloo(tmp_path / f"gloo{world}{mode}", world, WORKER, spec,
                    {"shares": shares})
    return [o["sum"] for o in outs]


@pytest.fixture(scope="module")
def mesh_aggregation(sides):
    """p0 shares of both packages and tpufhe's psum over the 8-device
    mesh (the parties padded with zero shares, tests/test_mbfv_batched.py)."""
    j, t = sides
    r = j.rng(41)
    shares = [JM.PublicKeyShare.new(sk, j.crp, r) for sk in j.sks]
    stacked = np.stack([np.asarray(s.p0_share.coeffs) for s in shares])
    pad = np.zeros((8 - PARTIES,) + stacked.shape[1:], stacked.dtype)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("parties",))
    agg = JBatch.make_sharded_pk_aggregation(j.par, mesh)
    want = convert.lanes_to_words(np.asarray(agg(np.concatenate([stacked,
                                                                 pad]))))
    r = t.rng(41)
    t_shares = np.stack([s.p0_share.coeffs.numpy() for s in
                         (TM.PublicKeyShare.new(sk, t.crp, r)
                          for sk in t.sks)])
    np.testing.assert_array_equal(t_shares, convert.lanes_to_words(stacked))
    np.testing.assert_array_equal(
        want, words(JM.aggregate(shares).c[0]))
    return t_shares, want


@pytest.mark.parametrize("world", [2, 3, 4])
def test_gloo_pk_aggregation_matches_tpufhe_mesh_psum(sides, mesh_aggregation,
                                                      tmp_path, world):
    _, t = sides
    shares, want = mesh_aggregation
    for out in gloo_sum(tmp_path, world, shares, t.par):
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("sizes", [(62, 62, 62), (30, 30)],
                         ids=["wide", "narrow"])
def test_psum_mod_top_of_range(tmp_path, sizes):
    """Every residue p - 1, 2^16 - 1 parties in each of two ranks (the most
    tpufhe's 16-bit planes take): exact against Python ints."""
    par = (TB.BfvParametersBuilder().set_degree(DEGREE)
           .set_plaintext_modulus(65537).set_moduli_sizes(list(sizes))
           .set_device("cpu").build())
    ctx = par.context_at_level(0)
    parties = 2 * ((1 << 16) - 1)
    top = (ctx.mod.p - 1).to(ctx.dtype).expand(ctx.k, DEGREE)
    shares = top.expand(parties, ctx.k, DEGREE).contiguous().numpy()
    want = np.array([[(parties * (m - 1)) % m] * DEGREE for m in par.moduli],
                    dtype=np.int64)
    for out in gloo_sum(tmp_path, 2, shares, par, mode="psum"):
        assert out.dtype == shares.dtype
        np.testing.assert_array_equal(out.astype(np.int64), want)


def test_psum_mod_needs_a_process_group():
    par = (TB.BfvParametersBuilder().set_degree(DEGREE)
           .set_plaintext_modulus(65537).set_moduli_sizes([62])
           .set_device("cpu").build())
    assert not torch.distributed.is_initialized()
    x = torch.zeros(2, 1, DEGREE, dtype=torch.int64)
    with pytest.raises((RuntimeError, ValueError)):
        TBatch.psum_mod(x, par.context_at_level(0), dim=0)
