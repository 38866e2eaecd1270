"""tpufhe's last public names in the port, each against tpufhe on the CPU
(exact: Python ints and canonical words), and the audit of every public
name of tpufhe against the port.

- SecretKey.zeroize and its call from __del__ (the port's copy of
  tests/test_bfv.py's test_secret_key_zeroize, plus the cached NTT-domain
  s zeroed in place and the cached programs dropped);
- zq.Modulus.add / sub / mul / neg / pow / center on Python ints;
- native.available();
- NttOperator.forward_host / backward_host, the exact host transforms;
- RnsScaler.scale_host, the exact Python-int scaler (scaler.rs:249-352);
- rq.Context.context_at_level and NoMoreContext;
- the audit (ast): every public top-level function, class and method of
  tpufhe/ has a counterpart of the same name in tpufhe_torch/, or is one
  of the TPU- and JAX-only names of NOT_PORTED (ROADMAP.md, "Not to
  port"), each of which exists in tpufhe and has no counterpart.
"""

import ast
import gc
import os

import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe import native as j_native
from tpufhe.errors import NoMoreContext as JNoMoreContext
from tpufhe.ops.ntt import NttOperator as JNttOperator
from tpufhe.ops.rq import Context as JContext
from tpufhe.ops.zq import Modulus as JModulus
from tpufhe.utils.rngs import ChaCha8Rng as JRng
from tpufhe.utils.rngs import seed_from_u64 as j_seed

import tpufhe_torch.bfv as T
from tpufhe_torch import native
from tpufhe_torch.errors import NoMoreContext
from tpufhe_torch.ops.ntt import NttOperator, forward_plain
from tpufhe_torch.ops.rq import Context
from tpufhe_torch.ops.zq import Modulus
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(builder, sizes=(62, 62), n=16):
    b = (builder().set_degree(n).set_plaintext_modulus(65537)
         .set_moduli_sizes(list(sizes)))
    return b.set_device("cpu").build() if builder is T.BfvParametersBuilder \
        else b.build()


def test_secret_key_zeroize():
    """Zeroize scrubs the key material in place (secret_key.rs:29-40): the
    host coefficients, as tpufhe's, and the cached s in the NTT domain;
    the cached programs are dropped. A program built before still holds
    its own copy of s."""
    jpar, par = _params(J.BfvParametersBuilder), _params(T.BfvParametersBuilder)
    jsk = J.SecretKey.random(jpar, JRng(j_seed(3)))
    sk = T.SecretKey.random(par, ChaCha8Rng(seed_from_u64(3)))
    np.testing.assert_array_equal(sk.coeffs, np.asarray(jsk.coeffs))
    buf, jbuf = sk.coeffs, jsk.coeffs
    assert np.any(buf != 0)
    rng = ChaCha8Rng(seed_from_u64(4))
    v = np.arange(16, dtype=np.uint64)
    ct = sk.try_encrypt(T.Plaintext.try_encode(v, T.Encoding.simd(), par), rng)
    sk.try_decrypt(ct)  # builds the cached decryption program
    s = sk.s_ntt(par.context_at_level(0))
    from tpufhe_torch.pipeline import make_decrypt_phase

    before = make_decrypt_phase(par, sk)(ct[0], ct[1])
    dec = make_decrypt_phase(par, sk)
    assert torch.any(s != 0) and sk._enc_fns and sk._dec_fns
    jsk.zeroize()
    sk.zeroize()
    assert not np.any(np.asarray(jbuf) != 0) and not np.any(buf != 0)
    assert not torch.any(s != 0)
    assert not hasattr(sk, "_enc_fns") and not hasattr(sk, "_dec_fns")
    assert torch.equal(dec(ct[0], ct[1]), before)


def test_secret_key_zeroized_on_del():
    par = _params(T.BfvParametersBuilder)
    sk = T.SecretKey.random(par, ChaCha8Rng(seed_from_u64(5)))
    buf, s = sk.coeffs, sk.s_ntt(par.context_at_level(0))
    assert np.any(buf != 0) and torch.any(s != 0)
    del sk
    gc.collect()
    assert not np.any(buf != 0) and not torch.any(s != 0)


@pytest.mark.parametrize("p", [(1 << 62) - 57, 1073479681, 65537, 7])
def test_modulus_host_arithmetic_matches_tpufhe(p):
    jq, q = JModulus(p), Modulus(p)
    rng = np.random.default_rng(p % 1000)
    values = [0, 1, p - 1, p, p + 1, -1, -p, 3 * p + 2, (1 << 64) + 5,
              -(1 << 70)] + [int(v) for v in rng.integers(0, 1 << 62, 20)]
    for a in values:
        assert q.neg(a) == jq.neg(a)
        assert q.center(a) == jq.center(a)
        assert -(p // 2) <= q.center(a) <= p // 2
        for b in values[:8]:
            assert q.add(a, b) == jq.add(a, b)
            assert q.sub(a, b) == jq.sub(a, b)
            assert q.mul(a, b) == jq.mul(a, b)
        for e in (0, 1, 2, p - 2, 12345):
            assert q.pow(a % p, e) == jq.pow(a % p, e)


def test_native_available_matches_tpufhe():
    assert native.available() == (native.lib() is not None)
    assert native.available() == j_native.available()


@pytest.mark.parametrize("sizes,n", [([62], 16), ([30], 64), ([50], 1024)])
def test_ntt_host_oracles_match_tpufhe(sizes, n):
    p = J.BfvParametersBuilder.generate_moduli(sizes, n)[0]
    jop, op = JNttOperator.new(JModulus(p), n), NttOperator.new(Modulus(p), n)
    a = np.random.default_rng(n).integers(0, p, n, dtype=np.uint64)
    fwd = op.forward_host(a)
    assert fwd.dtype == np.uint64
    np.testing.assert_array_equal(fwd, jop.forward_host(a))
    np.testing.assert_array_equal(op.backward_host(a), jop.backward_host(a))
    np.testing.assert_array_equal(op.backward_host(fwd), a)
    ctx = Context([p], n, "cpu")
    plain = forward_plain(torch.from_numpy(a.astype(np.int64))[None],
                          ctx.tables.omegas, ctx.mod)
    np.testing.assert_array_equal(plain[0].numpy().astype(np.uint64), fwd)


def _scalers(par):
    lvl = par.context_level_at(0)
    mp = lvl.mul_params()
    k, k_mul = lvl.poly_context.k, mp.to_ctx.k
    return [(mp.extender.rns_scaler, k, k_mul - k),
            (mp.down_scaler.rns_scaler, 0, k),
            (lvl.cipher_plain_context.scaler.rns_scaler, 0,
             lvl.cipher_plain_context.plaintext_context.k)]


@pytest.mark.parametrize("sizes", [[62] * 3, [30] * 3, [62] * 8, [30] * 8])
def test_scale_host_matches_tpufhe(sizes):
    """The extend, the t/q down-scale and the decryption's scale (the
    multiplication bases of 7 and of 17 or 18 limbs): every output row of
    random and adversarial residues."""
    jpar = _params(J.BfvParametersBuilder, sizes)
    par = _params(T.BfvParametersBuilder, sizes)
    rng = np.random.default_rng(len(sizes))
    for (jsc, start, size), (tsc, _, _) in zip(_scalers(jpar), _scalers(par)):
        moduli = tsc.from_ctx.moduli_u64
        q = tsc.from_ctx.product
        values = [0, 1, q - 1, q // 2 - 1, q // 2, q // 2 + 1, q // 3] + [
            int.from_bytes(rng.bytes(32), "little") % q for _ in range(8)]
        for v in values:
            rests = [v % m for m in moduli]
            want = jsc.scale_host(rests, size=size, starting_index=start)
            assert tsc.scale_host(rests, size=size,
                                  starting_index=start) == want
        assert tsc.scale_host(rests) == jsc.scale_host(rests)
        with pytest.raises(ValueError):
            tsc.scale_host(rests[:-1])


def test_context_at_level_matches_tpufhe():
    moduli = J.BfvParametersBuilder.generate_moduli([62, 50, 40], 16)
    jctx, ctx = JContext(moduli, 16), Context(moduli, 16, "cpu")
    for level in range(3):
        got = ctx.context_at_level(level)
        assert got.moduli == tuple(jctx.context_at_level(level).moduli)
        assert got is ctx.context_at_level(level)
    assert ctx.context_at_level(0) is ctx
    assert ctx.context_at_level(2).next_context is None
    with pytest.raises(JNoMoreContext):
        jctx.context_at_level(3)
    with pytest.raises(NoMoreContext):
        ctx.context_at_level(3)


# ---------------------------------------------------------------------------
# The audit of tpufhe's public names
# ---------------------------------------------------------------------------

# tpufhe's TPU- and JAX-only names, by module: "*" a whole module. The
# port's CUDA kernels (csrc/) stand for the Pallas wrappers, its one word
# a residue for the uint32 (lo, hi) lane arithmetic, its *_plain
# transforms for the lane transforms and make_mul_relin / make_expand for
# the step builders.
NOT_PORTED = {
    "hostflags.py": "*",
    "utils/runtime.py": "*",
    "ops/u64.py": "*",
    "ops/ntt_mxu.py": "*",
    "ops/pallas/intt_scale_kernel.py": "*",
    "ops/pallas/mxu_ntt_kernel.py": "*",
    "ops/pallas/ntt32_kernel.py": "*",
    "ops/pallas/ntt_kernel.py": "*",
    "ops/pallas/rns_kernel.py": "*",
    "ops/pallas/tensor_kernel.py": "*",
    "ops/ntt.py": {"forward", "backward", "forward32", "backward32"},
    "ops/rq.py": {"LANES", "lane_shape", "pack_u64", "unpack_u64",
                  "Context.dev", "ntt_forward_any", "ntt_backward_any",
                  "Poly.tree_flatten", "Poly.tree_unflatten"},
    "ops/zq.py": {"Modulus.p_pair", "Modulus.p2_pair",
                  "Modulus.barrett_lo_pair", "Modulus.barrett_hi_pair",
                  "add_mod", "sub_mod", "neg_mod", "mul_mod", "mul_mod_opt",
                  "reduce1", "reduce_i64", "reduce_u128", "lazy_reduce",
                  "lazy_reduce_u128", "lazy_reduce_opt",
                  "lazy_reduce_opt_u128", "lazy_mul_shoup", "lazy_mul_opt",
                  "center", "shr_pair_1"},
    "ops/zq32.py": {"add_mod32", "sub_mod32", "neg_mod32", "mul_mod32",
                    "reduce1_32", "mul_shoup32", "lazy_mul_shoup32",
                    "reduce_u64_32", "lazy_reduce_u64_32"},
    "pipeline.py": {"build_mul_relin_step", "build_expand_step"},
}


def _public_names(package: str) -> dict:
    """{module path: names} of a package's public top-level functions,
    classes, assigned names and methods ("Class.method"; __del__ counts as
    public)."""
    out = {}
    base = os.path.join(ROOT, package)
    for dirpath, _, files in os.walk(base):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            names = set()
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    names.add(node.name)
                elif isinstance(node, ast.ClassDef):
                    if node.name.startswith("_"):
                        continue
                    names.add(node.name)
                    names.update(
                        f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and (not m.name.startswith("_") or m.name == "__del__"))
                elif isinstance(node, ast.Assign):
                    names.update(t.id for t in node.targets
                                 if isinstance(t, ast.Name))
            out[os.path.relpath(path, base)] = {
                n for n in names if not n.split(".")[-1].startswith("_")
                or n.endswith(".__del__")}
    return out


def _missing() -> dict:
    """{module: names} of tpufhe with no counterpart of the same name (a
    method: on a class of the same name) anywhere in tpufhe_torch."""
    port = set().union(*_public_names("tpufhe_torch").values())
    out = {}
    for module, names in _public_names("tpufhe").items():
        gone = {n for n in names if n not in port}
        if gone:
            out[module] = gone
    return out


def test_every_public_name_has_a_counterpart():
    unported = {}
    for module, names in _missing().items():
        listed = NOT_PORTED.get(module, set())
        rest = set() if listed == "*" else names - listed
        if rest:
            unported[module] = sorted(rest)
    assert not unported, f"tpufhe names with no counterpart: {unported}"


def test_not_ported_list_is_current():
    """Every listed name exists in tpufhe and has no counterpart, so the
    list shrinks when a name is ported."""
    tpufhe_names, missing = _public_names("tpufhe"), _missing()
    for module, listed in NOT_PORTED.items():
        assert module in tpufhe_names, module
        if listed != "*":
            assert listed <= tpufhe_names[module], listed - tpufhe_names[module]
            assert listed <= missing.get(module, set()), \
                listed - missing.get(module, set())
