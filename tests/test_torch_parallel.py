"""The port's multi-process programs (tpufhe_torch/parallel/) against
tpufhe's, over gloo worker processes (test_torch_ntt_dist.run_gloo: each
imports only tpufhe_torch, rendezvous through a FileStore under the test's
tmp_path, a 60 s process-group timeout and a 120 s wait).

- make_seq_sharded_mul_relin over 2 ranks and over a 2 x 2 (batch, seq)
  mesh, default and strategy 2 with kP = 1, at degree 32, 2 x 62-bit,
  t = 12289, batch 2 (tests/test_seq_pipeline.py's configuration at a
  smaller degree): the ranks' blocks side by side equal tpufhe's
  make_mul_relin on the same keys and ciphertexts, word for word, and every
  slot decrypts to va vb mod t;
- make_sharded_mul_relin on a 4 x 2 and a 2 x 1 (batch, limb) mesh at
  BfvParameters.default(2, 16), batch 8 (tests/test_pipeline.py:54-84):
  equal to tpufhe's GSPMD program on conftest's 8-device CPU mesh;
- make_mul_relin with its transform hooks given explicitly equals the
  program without them, and every transform goes through the hooks;
- without a process group every entry point raises.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe.parallel import batch_limb_mesh as j_mesh
from tpufhe.parallel import make_sharded_mul_relin as j_sharded
from tpufhe.parallel import shard_ciphertext as j_shard
from tpufhe.pipeline import make_mul_relin as j_make_mul_relin
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed
from test_torch_ntt_dist import run_gloo

import tpufhe_torch.bfv as T
import tpufhe_torch.parallel as TP
from tpufhe_torch import convert
from tpufhe_torch.errors import UnsupportedOperation
from tpufhe_torch.ops.rq import ntt_backward, ntt_forward
from tpufhe_torch.parallel.seq_pipeline import make_seq_sharded_mul_relin
from tpufhe_torch.pipeline import make_mul_relin
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

SEQ_DEGREE, SEQ_T, SEQ_SIZES = 32, 12289, [62, 62]
SHARD_DEGREE, SHARD_BATCH = 16, 8

# Every worker builds the keys from the same seed as the test (the two
# packages make the same keys from one ChaCha8 stream).
KEYS = r"""
import tpufhe_torch.bfv as T
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64
par = (T.BfvParametersBuilder().set_degree(spec["degree"])
       .set_plaintext_modulus(spec["t"]).set_moduli_sizes(spec["sizes"])
       .set_device("cpu").build())
rng = ChaCha8Rng(seed_from_u64(spec["seed"]))
sk = T.SecretKey.random(par, rng)
rk = T.RelinearizationKey.new(sk, rng)
parts = [torch.from_numpy(data[name]) for name in ("a0", "a1", "b0", "b1")]
"""

SEQ_BODY = KEYS + r"""
from torch.distributed.device_mesh import init_device_mesh
from tpufhe_torch.parallel.seq_pipeline import make_seq_sharded_mul_relin
batch = spec["batch_shards"]
mesh = init_device_mesh("cpu", (batch, world // batch),
                        mesh_dim_names=("batch", "seq"))
bi, si = mesh.get_coordinate()
b = spec["degree"] // mesh.size(1)
rows = len(data["a0"]) // batch
for s2 in (None, 1):
    fn = make_seq_sharded_mul_relin(par, rk, mesh, batch_axis="batch",
                                    strategy2_primes=s2)
    blocks = [x[bi * rows:(bi + 1) * rows, :, si * b:(si + 1) * b]
              .contiguous() for x in parts]
    c0, c1 = fn(*blocks)
    out[f"s2_{s2}"] = torch.stack([c0, c1]).numpy()
"""


class Keys:
    """The same keys and SIMD ciphertexts from both packages."""

    def __init__(self, jp, tp, seed: int, batch: int):
        self.jp, self.tp, self.seed = jp, tp, seed
        jr, tr = JRng(j_seed(seed)), ChaCha8Rng(seed_from_u64(seed))
        self.jsk = J.SecretKey.random(jp, jr)
        self.tsk = T.SecretKey.random(tp, tr)
        self.jrk = J.RelinearizationKey.new(self.jsk, jr)
        self.trk = T.RelinearizationKey.new(self.tsk, tr)
        t, n = jp.plaintext.value, jp.degree()
        vals = np.random.default_rng(seed)
        self.va = vals.integers(0, t, (batch, n), dtype=np.uint64)
        self.vb = vals.integers(0, t, (batch, n), dtype=np.uint64)
        self.want = ((self.va.astype(object) * self.vb.astype(object)) % t
                     ).astype(np.uint64)
        jc = [[self.jsk.try_encrypt(J.Plaintext.try_encode(
            v, J.Encoding.simd(), jp), jr) for v in vs]
            for vs in (self.va, self.vb)]
        # tpufhe's lane arrays (a0, a1, b0, b1), each (batch, k, 2, ...)
        self.lanes = [np.stack([np.asarray(c[i].coeffs) for c in cs])
                      for cs in jc for i in (0, 1)]
        self.words = {name: convert.lanes_to_words(x) for name, x in
                      zip(("a0", "a1", "b0", "b1"), self.lanes)}

    def spec(self, **extra) -> dict:
        return {"degree": self.jp.degree(), "t": self.jp.plaintext.value,
                "sizes": [62] * len(self.jp.moduli), "seed": self.seed} | extra

    def check_decrypts(self, c0: np.ndarray, c1: np.ndarray) -> None:
        for i in range(len(self.want)):
            ct = T.Ciphertext(self.tp, [torch.from_numpy(c0[i]),
                                        torch.from_numpy(c1[i])], 0)
            got = self.tsk.try_decrypt(ct).try_decode(T.Encoding.simd())
            np.testing.assert_array_equal(got, self.want[i])


@pytest.fixture(scope="module")
def seq_keys():
    def build(pkg):
        return (pkg.BfvParametersBuilder().set_degree(SEQ_DEGREE)
                .set_plaintext_modulus(SEQ_T).set_moduli_sizes(SEQ_SIZES))

    keys = Keys(build(J).build(), build(T).set_device("cpu").build(), 5, 2)
    ref = {}
    with jax.disable_jit():  # eager at this degree, as tests/test_pipeline.py
        for s2 in (None, 1):
            fn = j_make_mul_relin(keys.jp, keys.jrk, strategy2_primes=s2)
            ref[s2] = [convert.lanes_to_words(np.asarray(o))
                       for o in fn(*keys.lanes)]
    return keys, ref


@pytest.mark.parametrize("world,batch_shards", [(2, 1), (4, 2)],
                         ids=["seq2", "batch2xseq2"])
def test_seq_sharded_mul_relin_matches_tpufhe(seq_keys, tmp_path, world,
                                              batch_shards):
    keys, ref = seq_keys
    outs = run_gloo(tmp_path / "seq", world, SEQ_BODY,
                    keys.spec(batch_shards=batch_shards), keys.words)
    seq = world // batch_shards
    for s2 in (None, 1):
        name = f"s2_{s2}"
        # rank (bi, si) of the row-major mesh holds batch block bi, block si
        got = np.concatenate([
            np.concatenate([outs[bi * seq + si][name] for si in range(seq)],
                           axis=-1) for bi in range(batch_shards)], axis=1)
        np.testing.assert_array_equal(got[0], ref[s2][0], err_msg=name)
        np.testing.assert_array_equal(got[1], ref[s2][1], err_msg=name)
        keys.check_decrypts(got[0], got[1])


SHARD_BODY = KEYS + r"""
import tpufhe_torch.parallel as TP
mesh = TP.batch_limb_mesh(*spec["mesh"])
fn = TP.make_sharded_mul_relin(par, rk, mesh)
c0, c1 = fn(*(TP.shard_ciphertext(mesh, x) for x in parts))
out["c"] = torch.stack([c0, c1]).numpy()
out["coord"] = np.array(mesh.get_coordinate())
"""


@pytest.fixture(scope="module")
def shard_keys():
    return Keys(J.BfvParameters.default(2, SHARD_DEGREE),
                T.BfvParameters.default(2, SHARD_DEGREE, device="cpu"), 11,
                SHARD_BATCH)


@pytest.mark.parametrize("mesh", [(4, 2), (2, 1)], ids=["4x2", "2x1"])
def test_sharded_mul_relin_matches_tpufhe_gspmd(shard_keys, tmp_path, mesh):
    keys = shard_keys
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    jm = j_mesh(*mesh)
    fn = j_sharded(keys.jp, keys.jrk, jm)
    want = [convert.lanes_to_words(np.asarray(o))
            for o in fn(*(j_shard(jm, x) for x in keys.lanes))]
    outs = run_gloo(tmp_path / "shard", mesh[0] * mesh[1], SHARD_BODY,
                    keys.spec(mesh=list(mesh)), keys.words)
    rows, limbs = SHARD_BATCH // mesh[0], 2 // mesh[1]
    got = np.zeros((2,) + want[0].shape, np.int64)
    for o in outs:
        bi, li = o["coord"]
        got[:, bi * rows:(bi + 1) * rows, li * limbs:(li + 1) * limbs] = o["c"]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    keys.check_decrypts(got[0], got[1])


# ---------------------------------------------------------------------------
# make_mul_relin's transform hooks, in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s2", [None, 1], ids=["default", "strategy2"])
def test_explicit_hooks_equal_the_hookless_program(shard_keys, s2):
    keys = shard_keys
    calls = {"fwd": 0, "bwd": 0, "const": 0}

    def fwd(ctx, x, limb_slice=None):
        calls["fwd"] += 1
        return ntt_forward(ctx, x, limb_slice)

    def bwd(ctx, x):
        calls["bwd"] += 1
        return ntt_backward(ctx, x)

    def const_slice(arr):
        calls["const"] += 1
        return arr

    parts = [torch.from_numpy(keys.words[n]) for n in ("a0", "a1", "b0", "b1")]
    want = make_mul_relin(keys.tp, keys.trk, strategy2_primes=s2)(*parts)
    hooked = make_mul_relin(keys.tp, keys.trk, strategy2_primes=s2,
                            ntt_fwd=fwd, ntt_bwd=bwd, const_slice=const_slice)
    assert calls["const"] == 4  # the key's four tables, once
    got = hooked(*parts)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # extend (+ strategy 2's rhs) and tail forwards; input and tensor inverses
    assert calls == {"fwd": 2 if s2 is None else 3, "bwd": 2, "const": 4}
    with pytest.raises(UnsupportedOperation):
        make_mul_relin(keys.tp, keys.trk, ext_fuse=True, ntt_fwd=fwd)


def test_parallel_programs_need_a_process_group(shard_keys):
    keys = shard_keys
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError):
        TP.batch_limb_mesh(1, 1)
    with pytest.raises(RuntimeError):
        make_seq_sharded_mul_relin(keys.tp, keys.trk, None)
    narrow = (T.BfvParametersBuilder().set_degree(16)
              .set_plaintext_modulus(1153).set_moduli_sizes([30, 30])
              .set_device("cpu").build())
    nrk = T.RelinearizationKey.new(
        T.SecretKey.random(narrow, ChaCha8Rng(seed_from_u64(1))),
        ChaCha8Rng(seed_from_u64(2)))
    with pytest.raises(UnsupportedOperation):
        make_seq_sharded_mul_relin(narrow, nrk, None)
