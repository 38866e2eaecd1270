"""The CUDA sources of K1 (ntt.cu), K3 (tensor_intt.cu), K4 (relin_tail.cu),
K5 (rotate_tail.cu), K8 (intt_scale.cu), K9 (ntt32.cu), ct_pt_dot
(ct_pt_dot.cu) and ks_accumulate (ks_accumulate.cu, its <<<>>> launches
rewritten as calls of the stand-in's emu_chevron), compiled with g++
against the CPU stand-in of tests/cuda_emu (each CTA an OS thread, each CUDA
thread a fiber switched at barriers, distributed shared memory mapped
between the cluster's threads) and run through the port's own wrappers on
CPU tensors, word for word against their plain versions: every K1 instance
(the general one, the fixed n = 4096 and 8192 rows, the N = 16384 two-CTA
split) in both directions and as a lazy forward (words below 4p,
congruent to the plain output), K3's cluster of three, both tails and the
key switch alone (ks_tail, in relin_tail.cu: d digit rows over k >= d
limbs), K9's narrow passes (the general instance, a row of one pass at
n = 8, the fixed n = 8192) in both directions and lazy, K8's cluster (the fixed k_in = 3 instances
and the general one, with more limbs than CTAs), ct_pt_dot's 128-bit
sums across its reduction windows at each of its instances, through its
ring of cp.async stages (tests/cuda_emu/cuda_pipeline.h carries a
thread's copies out only when it waits for them), and ks_accumulate's
Garner, digit and leveled rows (fewer digit rows than key limbs), and
ntt_dist's cross-shard step (ntt_dist.cu, <<<>>> rewritten likewise) with
K1 on the shard tables, the D ranks' blocks side by side equal to the
whole row's transform, and zq_mul (zq_mul.cu) in both modes over 50-,
55- and 62-bit moduli at every broadcast pattern the glue passes it, its
edge words, rows of odd length and rows off a 16-byte boundary, equal to
the digit chains and to exact integer products, and inside MulPIR's
expansion, switch-down and a product by a plaintext, expand_fold
(expand_fold.cu), the expansion's fold, on both routes (with and
without the addend) over 50-, 55- and 62-bit moduli, its edge words and
rows off a 16-byte boundary, and inside make_expand at MulPIR's shape,
and rq_pack /
rq_unpack (rq_pack.cu), the wire codec's residue transcode, byte for byte
against the host transcode at every width from 1 to 62 bits, mixed
widths, narrow rows, streams off an 8-byte boundary, the range flag, and
the codec's card route at MulPIR's parameters. The
card remains the judge of speed and of races; this holds the kernels'
arithmetic, indexing, barriers and cluster exchanges on every CPU run."""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tpufhe_torch.bfv as T
from tpufhe_torch import kernels
from tpufhe_torch import pipeline as tpl
from tpufhe_torch.bfv.keys.key_switching_key import shoup_of
from tpufhe_torch.errors import SerializationError
from tpufhe_torch.ops import dot, zq
from tpufhe_torch.ops import ntt as ntt_mod
from tpufhe_torch.ops.intt_scale import intt_scale_cuda, intt_scale_plain
from tpufhe_torch.ops.rns import ScalingFactor
from tpufhe_torch.ops.rq import Context, Scaler
from tpufhe_torch.parallel import ntt_dist as nd
from tpufhe_torch.serialize import rq_pack
from tpufhe_torch.utils import obs
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")
SOURCES = ("ntt", "tensor_intt", "relin_tail", "rotate_tail", "ntt32",
           "intt_scale", "ct_pt_dot", "ks_accumulate", "ntt_dist", "zq_mul",
           "rq_pack", "expand_fold")
# the sources that launch with <<<>>>, rewritten for g++ before the build
CHEVRON = ("ks_accumulate", "ntt_dist")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """{kernel name: ctypes library} of the sources built with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the CUDA sources cannot be emulated")
    out = tmp_path_factory.mktemp("cuda_emu")

    def build(name):
        lib = str(out / f"{name}.so")
        src = os.path.join(kernels.CSRC, f"{name}.cu")
        if name in CHEVRON:
            with open(src) as f:
                text = re.sub(r"(\w+(?:<\w+>)?)<<<(.*?)>>>",
                              r"emu_chevron(\1, \2)", f.read(), flags=re.S)
            src = str(out / f"{name}.cu")
            with open(src, "w") as f:
                f.write(text)
        cmd = [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w", "-I", EMU,
               "-I", kernels.CSRC, "-include", "cuda_runtime.h", "-x", "c++",
               src, "-x", "none", os.path.join(EMU, "emu.cpp"), "-o", lib,
               "-lpthread"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
        return name, ctypes.CDLL(lib)

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(pool.map(build, SOURCES))


@pytest.fixture
def on_host(emulated, monkeypatch):
    """The wrappers launch the emulated kernels on CPU tensors."""

    def function(name, symbol, argtypes):
        fn = getattr(emulated[kernels.KERNELS[name][0][:-3]], symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    def require(name, dtype, *tensors, contiguous=True):
        for t in tensors:
            assert t.dtype == dtype, name
            assert t.is_contiguous() or not contiguous, name

    monkeypatch.setattr(kernels, "function", function)
    monkeypatch.setattr(kernels, "require_cuda", require)
    monkeypatch.setattr(kernels, "stream", lambda: ctypes.c_void_p(0))
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.KERNELS, 0))
    return kernels.LAUNCHES


def _residues(shape, moduli, seed):
    """Canonical int64 residues of (..., k, n), row j below moduli[j], each
    row's first coefficient p - 1."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, p, shape[:-2] + shape[-1:], dtype=np.uint64)
                  for p in moduli], axis=-2)
    x[..., 0] = np.array(moduli, np.uint64) - 1
    return torch.from_numpy(x.astype(np.int64))


def _context(n, k, bits=62):
    """A context of k moduli of `bits` bits (or of the sizes in `bits`)."""
    sizes = [bits] * k if isinstance(bits, int) else list(bits)
    return Context(T.BfvParametersBuilder.generate_moduli(sizes, n), n,
                   "cpu", narrow=max(sizes) <= 30)


# (n, limbs of the context, limb_slice, batch rows): the general instance
# (n = 8, 16, 512), the fixed ones (4096, 8192) and the split (16384), with
# limb slices that start past limb 0
K1_CASES = [(8, 2, slice(None), 2), (16, 3, slice(None), 2),
            (512, 3, slice(1, 3), 2), (4096, 2, slice(None), 2),
            (8192, 3, slice(1, 3), 1), (16384, 2, slice(None), 1),
            (16384, 3, slice(2, 3), 2)]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,k,sl,rows", K1_CASES)
def test_ntt_kernel_matches_plain(on_host, n, k, sl, rows, inverse):
    tables = _context(n, k).tables
    moduli = tables.mod.moduli[sl]
    x = _residues((rows, len(moduli), n), moduli, n + rows)
    got = ntt_mod.ntt_cuda(x, tables, sl, inverse)
    if inverse:
        want = ntt_mod.backward_plain(x, tables.zetas_inv[sl], tables.ninv[sl],
                                      tables.mod[sl])
    else:
        want = ntt_mod.forward_plain(x, tables.omegas[sl], tables.mod[sl])
    assert torch.equal(got, want)
    assert on_host["ntt"] == 1


def _lazy_matches(got, want, moduli, bits):
    """Every word of a lazy forward (read as unsigned) below 4p and
    congruent to the plain version's canonical word; where there are
    enough words, some at or above p (the last reduction was left out)."""
    p = np.array(moduli, np.uint64)[:, None]
    u = got.numpy().view(np.uint64 if bits == 64 else np.uint32)
    u = u.astype(np.uint64)
    assert (u < 4 * p).all()
    assert np.array_equal(u % p, want.numpy().astype(np.uint64))
    if u.size >= 512:
        assert (u >= p).any()


@pytest.mark.parametrize("n,k,sl,rows", K1_CASES)
def test_ntt_kernel_lazy_forward(on_host, n, k, sl, rows):
    tables = _context(n, k).tables
    moduli = tables.mod.moduli[sl]
    x = _residues((rows, len(moduli), n), moduli, n + rows)
    got = ntt_mod.ntt_cuda(x, tables, sl, False, lazy=True)
    _lazy_matches(got, ntt_mod.forward_plain(x, tables.omegas[sl],
                                             tables.mod[sl]), moduli, 64)
    assert on_host["ntt"] == 1
    with pytest.raises(ValueError):
        ntt_mod.ntt_cuda(x, tables, sl, True, lazy=True)


@pytest.mark.parametrize("n,k,rows", [(16, 2, 2), (1024, 3, 1), (8192, 2, 1)])
def test_tensor_intt_kernel_matches_plain(on_host, n, k, rows):
    ctx = _context(n, k)
    ext = _residues((4, rows, k, n), ctx.moduli, n + 7)
    assert torch.equal(tpl.tensor_intt_cuda(ctx, ext),
                       tpl.tensor_intt_plain(ctx, ext))
    assert on_host["tensor_intt"] == 1


@pytest.mark.parametrize("tail", ["relin", "rotate"])
@pytest.mark.parametrize("n,k,rows", [(64, 2, 2), (4096, 2, 1)])
def test_tail_kernels_match_plain(on_host, tail, n, k, rows):
    ctx = _context(n, k)
    key = SimpleNamespace(c0=_residues((k, k, n), ctx.moduli, 1),
                          c1=_residues((k, k, n), ctx.moduli, 2))
    key.c0_shoup = shoup_of(key.c0, ctx.moduli)
    key.c1_shoup = shoup_of(key.c1, ctx.moduli)
    if tail == "relin":
        dsc = _residues((3, rows, k, n), ctx.moduli, 3)
        got = tpl.relin_tail_cuda(ctx, dsc, key)
        want = tpl.relin_tail_plain(ctx, dsc, key)
    else:
        s0 = _residues((rows, k, n), ctx.moduli, 4)
        c2 = _residues((rows, k, n), ctx.moduli, 5)
        got = tpl.rotate_tail_cuda(ctx, s0, c2, key)
        want = tpl.rotate_tail_plain(ctx, s0, c2, key)
    assert torch.equal(torch.stack(got), torch.stack(want))
    assert on_host[f"{tail}_tail"] == 1


# (degree, digit rows, key limbs, batch rows): a leveled key's 2 rows over
# 3 limbs (MulPIR's expansion), the Garner rows (d = k), and 17 rows over
# 17 limbs, which the cluster of 16 takes in two rounds
KS_TAIL_CASES = [(64, 2, 3, 2), (4096, 2, 3, 1), (64, 3, 3, 2),
                 (256, 3, 3, 1), (64, 17, 17, 1)]


@pytest.mark.parametrize("n,d,k,rows", KS_TAIL_CASES)
def test_ks_tail_kernel_matches_plain(on_host, n, d, k, rows):
    ctx = _context(n, k)
    key = SimpleNamespace(c0=_residues((d, k, n), ctx.moduli, 1),
                          c1=_residues((d, k, n), ctx.moduli, 2), log_base=0,
                          ctx_ciphertext=Context(ctx.moduli[:d], n, "cpu"))
    key.c0_shoup = shoup_of(key.c0, ctx.moduli)
    key.c1_shoup = shoup_of(key.c1, ctx.moduli)
    c2 = _residues((rows, d, n), ctx.moduli[:d], 3)
    got = tpl.ks_tail_cuda(ctx, c2, key)
    assert got.shape == (2, rows, k, n)
    assert torch.equal(got, tpl.ks_tail_plain(ctx, c2, key))
    assert on_host["ks_tail"] == 1


# (n, limbs of the narrow context, limb_slice, batch rows): K9's general
# instance (a row of one three-stage pass at n = 8, a two-stage lead pass at
# n = 32, n = 16 and 512) and its fixed n = 8192 one, with limb slices that
# start past limb 0
K9_CASES = [(8, 2, slice(None), 2), (16, 3, slice(1, 3), 2),
            (32, 2, slice(None), 1), (512, 3, slice(1, 3), 2),
            (8192, 3, slice(1, 3), 1)]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,k,sl,rows", K9_CASES)
def test_ntt32_kernel_matches_plain(on_host, n, k, sl, rows, inverse):
    tables = _context(n, k, 30).tables
    moduli = tables.mod.moduli[sl]
    x = _residues((rows, len(moduli), n), moduli, n + rows).int()
    got = ntt_mod.ntt32_cuda(x, tables, sl, inverse)
    if inverse:
        want = ntt_mod.backward32_plain(x, tables.zetas_inv[sl],
                                        tables.ninv[sl], tables.p[sl])
    else:
        want = ntt_mod.forward32_plain(x, tables.omegas[sl], tables.p[sl])
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert on_host["ntt32"] == 1


@pytest.mark.parametrize("n,k,sl,rows", K9_CASES)
def test_ntt32_kernel_lazy_forward(on_host, n, k, sl, rows):
    tables = _context(n, k, 30).tables
    moduli = tables.mod.moduli[sl]
    x = _residues((rows, len(moduli), n), moduli, n + rows).int()
    got = ntt_mod.ntt32_cuda(x, tables, sl, False, lazy=True)
    assert got.dtype == torch.int32
    _lazy_matches(got, ntt_mod.forward32_plain(x, tables.omegas[sl],
                                               tables.p[sl]), moduli, 32)
    assert on_host["ntt32"] == 1


# (n, k_in, extension limbs, scaling, batch rows): the fixed shape's pair
# of half-row CTAs (3 limbs of 8192, also with a table too large for the
# parameter space at 56 new limbs), and the general one-limb CTAs at 3
# limbs of other degrees and with more limbs than the cluster's eight CTAs;
# "extend" is the base extension of a multiplication (factor one, the new
# limbs), "rhs" strategy 2's P/q scaling onto every limb of the larger basis
K8_CASES = [(16, 3, 2, "extend", 2), (1024, 3, 2, "rhs", 2),
            (8192, 3, 1, "extend", 1), (8192, 3, 2, "rhs", 2),
            (8192, 3, 56, "extend", 1),
            (1024, 12, 1, "rhs", 1),
            (64, 9, 2, "extend", 2)]


@pytest.mark.parametrize("n,k,extra,kind,rows", K8_CASES)
def test_intt_scale_kernel_matches_plain(on_host, n, k, extra, kind, rows):
    basis = T.BfvParametersBuilder.generate_moduli([62] * (k + extra), n)
    ctx, ctx_mul = Context(basis[:k], n, "cpu"), Context(basis, n, "cpu")
    if kind == "extend":
        factor, start, size = ScalingFactor.one(), k, extra
    else:
        p_prod = int(np.prod([int(p) for p in basis[k:]], dtype=object))
        factor, start, size = ScalingFactor(p_prod, ctx.modulus()), 0, k + extra
    scaler = Scaler(ctx, ctx_mul, factor).rns_scaler
    x = _residues((rows, k, n), ctx.moduli, n + k)
    got = intt_scale_cuda(ctx, scaler, x, start, size)
    assert torch.equal(got, intt_scale_plain(ctx, scaler, x, start, size))
    assert on_host["intt_scale"] == 1


# (terms n, columns m, limbs, bits, batch rows, rows folded per limb set,
# window): 62-bit moduli (a window of 14 terms, so 15 and 29 cross one and
# two reductions) and 44-bit ones (a window far above 29 terms, and forced
# to 3 to cross several), two parts, batch rows and, as rq.dot_product
# passes them, rows R = 2 k of a folded batch
DOT_CASES = [(15, 1, 3, 62, 1, 1, None), (29, 3, 3, 62, 2, 1, None),
             (15, 3, 2, 44, 2, 1, None), (29, 1, 2, 44, 1, 2, None),
             (29, 3, 2, 44, 1, 1, 3)]


@pytest.mark.parametrize("n,m,k,bits,b,fold,win", DOT_CASES)
def test_ct_pt_dot_kernel_matches_plain(on_host, monkeypatch, n, m, k, bits,
                                        b, fold, win):
    ctx = _context(256, k, bits)
    if win is not None:
        monkeypatch.setattr(dot, "dot_window", lambda c: win)
    elif bits == 62:
        assert dot.dot_window(ctx) == 14
    moduli = list(ctx.moduli) * fold
    parts = [_residues((n + 1, b, k * fold, 256), moduli, 10 + i)
             for i in range(2)]
    db = _residues((n, m, k * fold, 256), moduli, 12)
    got = dot.ct_pt_dot_cuda(ctx, parts, db)
    assert got.shape == (2, m, b, k * fold, 256)
    assert torch.equal(got, dot.ct_pt_dot_plain(ctx, parts, db))
    assert on_host["ct_pt_dot"] == 1


# (parts, terms n, columns m, limbs, bits, batch rows, rows folded per limb
# set, degree, window, words the parts start past a 16-byte boundary):
# every instance of the kernel (<1, 1>, <2, 1>, <2, 8> and the general one
# of up to 8 parts and 2 columns a group) at m below, at and above its
# column group, over a part-filled CTA and several
# CTAs, term counts that are no multiple of the ring or the window; 29 terms
# whose first words are p - 1 overflow 128 bits without the window's
# reductions; MulPIR's first dimension (58 terms, 57 columns: 7 groups of
# 8 and a tail of 1) over its level-1 moduli of 50 and 55 bits, whose
# window holds every term
DOT_PLAN_CASES = [(1, 29, 1, 2, 62, 1, 2, 64, None, 0),
                  (1, 15, 1, 3, 62, 2, 1, 256, None, 0),
                  (2, 29, 1, 3, 62, 2, 1, 256, None, 0),
                  (2, 29, 1, 3, 62, 2, 1, 256, None, 1),
                  (2, 17, 1, 2, 62, 1, 1, 64, None, 0),
                  (2, 29, 1, 2, 62, 1, 1, 256, 3, 0),
                  (2, 15, 3, 2, 62, 2, 1, 256, None, 0),
                  (2, 29, 8, 2, 62, 2, 1, 256, None, 0),
                  (2, 29, 8, 3, 62, 1, 1, 64, None, 0),
                  (2, 21, 10, 2, 62, 1, 1, 64, None, 0),
                  (3, 29, 1, 2, 62, 2, 1, 256, None, 0),
                  (3, 17, 2, 3, 62, 1, 1, 128, None, 0),
                  (3, 15, 5, 1, 44, 1, 1, 64, None, 0),
                  (8, 29, 1, 2, 62, 1, 1, 64, None, 0),
                  (8, 15, 3, 2, 44, 2, 1, 256, 3, 0),
                  (2, 58, 57, 2, (50, 55), 1, 1, 64, None, 0)]


def _dot_instance(parts: int, m: int) -> tuple:
    """(parts, columns) of the kernel instance a call of `parts` parts and
    m columns takes."""
    if parts <= 2 and m == 1:
        return parts, 1
    return (2, 8) if parts == 2 else (dot.MAX_PARTS, 2)


@pytest.mark.parametrize("parts,n,m,k,bits,b,fold,deg,win,shift",
                         DOT_PLAN_CASES)
def test_ct_pt_dot_instances_match_plain(on_host, emulated, monkeypatch,
                                         parts, n, m, k, bits, b, fold, deg,
                                         win, shift):
    ctx = _context(deg, k, bits)
    if win is not None:
        monkeypatch.setattr(dot, "dot_window", lambda c: win)
    plan_fn = emulated["ct_pt_dot"].tpufhe_ct_pt_dot_plan
    plan_fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_void_p]
    plan = (ctypes.c_longlong * 7)()
    assert plan_fn(parts, m, b * k * fold * deg, plan) == 0
    assert tuple(plan[:2]) == _dot_instance(parts, m)
    moduli = list(ctx.moduli) * fold
    es = [_residues((n + i % 2, b, k * fold, deg), moduli, 20 + i)
          for i in range(parts)]
    if shift:
        # the same words at an address 8 bytes past a 16-byte boundary
        es = [torch.cat([e.new_zeros(shift), e.flatten()])[shift:]
              .view(e.shape) for e in es]
        assert all(e.data_ptr() % 16 for e in es)
    db = _residues((n, m, k * fold, deg), moduli, 19)
    got = dot.ct_pt_dot_cuda(ctx, es, db)
    assert got.shape == (parts, m, b, k * fold, deg)
    assert torch.equal(got, dot.ct_pt_dot_plain(ctx, es, db))
    assert on_host["ct_pt_dot"] == 1



# (digit rows, key limbs, batch rows, n, bits, addends): the Garner rows
# (digits = k), a leveled key's (k_ct = 2 digit rows over its 3 limbs, as
# the MulPIR expansion's last doubling), a single-modulus key's base-2^31
# digits (2 rows, 1 limb) and narrow int32 words
KS_CASES = [(3, 3, 2, 64, 62, 2), (2, 3, 4, 64, 62, 0), (2, 3, 1, 256, 50, 1),
            (2, 1, 3, 64, 62, 2), (2, 3, 2, 64, 30, 1)]


@pytest.mark.parametrize("digits,k,rows,n,bits,adds", KS_CASES)
def test_ks_accumulate_kernel_matches_plain(on_host, digits, k, rows, n, bits,
                                            adds):
    ctx = _context(n, k, bits)
    moduli = ctx.moduli

    def words(shape, seed):
        return _residues(shape, moduli, seed).to(ctx.dtype)

    key = {name: words((digits, k, n), 30 + i)
           for i, name in enumerate(("c0", "c1"))}
    ksk = SimpleNamespace(log_base=0, c0=key["c0"], c1=key["c1"],
                          c0_shoup=shoup_of(key["c0"], moduli),
                          c1_shoup=shoup_of(key["c1"], moduli))
    lifted = words((digits, rows, k, n), 40)
    addends = [words((rows, k, n), 41 + i) if i < adds else None
               for i in range(2)]
    got = tpl.ks_accumulate_cuda(ctx, lifted, ksk, *addends)
    assert torch.equal(got, tpl.ks_accumulate_plain(ctx, lifted, ksk,
                                                    *addends))
    assert on_host["ks_accumulate"] == 1


# (degree, shards, limbs of the context, limb_slice, batch rows): blocks of
# K1's general instance (8 .. 512 words) and of its fixed n = 4096 one
DIST_CASES = [(64, 8, 2, slice(None), 2), (256, 4, 3, slice(1, 3), 2),
              (1024, 2, 2, slice(None), 1), (8192, 2, 1, slice(None), 1)]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,shards,k,sl,rows", DIST_CASES)
def test_ntt_dist_kernel_matches_plain(on_host, n, shards, k, sl, rows,
                                       inverse):
    """ntt_dist against cross_plain on every rank's gathered blocks, and
    each rank's transform (K1 on its shard tables around the kernel) side
    by side equal to the whole row's; the forward also on words in
    [0, 4p)."""
    ctx = _context(n, k)
    moduli = ctx.moduli[sl]
    x = _residues((rows, len(moduli), n), moduli, n + shards)
    if not inverse:  # lazy words below 4p, some above 2^63
        x = x + torch.from_numpy(np.array([3 * m for m in moduli],
                                          np.uint64).view(np.int64))[:, None]
    b = n // shards
    plans = [nd.DistNttPlan.new(ctx, shards, e) for e in range(shards)]
    start = sl.indices(k)[0]
    if inverse:
        sent = torch.stack([ntt_mod.ntt_cuda(x[..., e * b:(e + 1) * b]
                                             .contiguous(), plans[e].tables,
                                             sl, True)
                            for e in range(shards)])
    else:
        sent = torch.stack([x[..., e * b:(e + 1) * b] for e in range(shards)])
    out = []
    for plan in plans:
        w, ws = ((plan.w_inv, plan.w_inv_shoup) if inverse
                 else (plan.w, plan.w_shoup))
        y = nd.cross_cuda(sent, w, ws, plan.tables.p, start)
        assert torch.equal(y, nd.cross_plain(sent, w[sl], ws[sl],
                                             plan.tables.mod[sl]))
        out.append(y if inverse else
                   ntt_mod.ntt_cuda(y, plan.tables, sl, False))
    tb = ctx.tables
    if inverse:
        want = ntt_mod.backward_plain(x, tb.zetas_inv[sl], tb.ninv[sl],
                                      tb.mod[sl])
    else:
        want = ntt_mod.forward_plain(zq.reduce_u64(x, tb.mod[sl]),
                                     tb.omegas[sl], tb.mod[sl])
    assert torch.equal(torch.cat(out, -1), want)
    assert on_host["ntt_dist"] == shards
    assert on_host["ntt"] == shards


# zq_mul: (name, shape of a, shape of b, moduli shape) at k = 2 limbs of
# n = 64 words (n = 13 in the ragged cases, rows of odd length that the
# kernel takes one word a thread): the switch-down's rows by a (k, 1)
# column, the fold's rows by a (k, n) monomial, ct_mul_pt's parts by a
# (k, n) plaintext, two full operands, the NTT's plain stages' (k, 1, 1)
# moduli, and an operand expanded along an outer dimension (stride 0)
ZQ_N = 64
ZQ_SHAPES = {
    "column": ((2, 3, 4, 2, ZQ_N), (2, 1), (2, 1)),
    "row": ((5, 4, 2, ZQ_N), (2, ZQ_N), (2, 1)),
    "plaintext": ((6, 2, ZQ_N), (2, ZQ_N), (2, 1)),
    "full": ((3, 2, ZQ_N), (3, 2, ZQ_N), (2, 1)),
    "staged": ((3, 2, 4, ZQ_N // 4), (2, 4, 1), (2, 1, 1)),
    "outer_stride_0": ((1, 2, ZQ_N), (7, 2, ZQ_N), (2, 1)),
    "ragged_row": ((3, 2, 13), (2, 13), (2, 1)),
    "ragged_full": ((5, 2, 13), (5, 2, 13), (2, 1)),
}



def _zq_operands(case, bits, seed):
    """(a, b, b_shoup, table) of a case over two moduli of `bits` bits:
    canonical words, each row starting with 0 and ending with p - 1."""
    a_shape, b_shape, m_shape = ZQ_SHAPES[case]
    moduli = T.BfvParametersBuilder.generate_moduli([bits] * 2, 64)
    m = zq.ModTable(moduli, "cpu", m_shape)
    rng = np.random.default_rng(seed)

    def words(shape):
        p = m.p.expand(torch.broadcast_shapes(shape, m_shape)).numpy()
        x = rng.integers(0, 1 << 62, shape, dtype=np.int64) % p
        x[..., 0] = 0
        x[..., -1] = p[..., -1] - 1
        return torch.from_numpy(x)

    a, b = words(a_shape), words(b_shape)
    if case == "outer_stride_0":
        a = b[:1].expand(b.shape)
        assert a.stride()[0] == 0
        b = words((2, ZQ_N))
    p = m.p.expand(b.shape).reshape(-1).tolist()
    bs = [(v << 64) // q for v, q in zip(b.reshape(-1).tolist(), p)]
    bs = torch.from_numpy(np.array(bs, np.uint64).view(np.int64)
                          .reshape(b.shape))
    return a, b, bs, m


def _exact(a, b, m):
    """a b mod p word by word in Python integers (a read as unsigned)."""
    shape = torch.broadcast_shapes(a.shape, b.shape, m.p.shape)
    x, y, p = (t.expand(shape).reshape(-1).tolist() for t in (a, b, m.p))
    return [(u % (1 << 64)) * v % q for u, v, q in zip(x, y, p)]


@pytest.mark.parametrize("case", sorted(ZQ_SHAPES))
@pytest.mark.parametrize("bits", [50, 55, 62])
@pytest.mark.parametrize("mode", ["barrett", "shoup"])
def test_zq_mul_kernel_matches_the_digit_chains(on_host, mode, bits, case):
    """Both modes word for word against zq.mul_plain / mul_shoup_plain and
    exact products; Shoup's also with a at its edge words 2^63 - 1 and
    2^62 + p (any a below 2^63)."""
    a, b, bs, m = _zq_operands(case, bits, bits + len(case))
    if mode == "barrett":
        got = zq.mul_cuda(a, b, None, m)
        want = zq.mul_plain(a, b, m)
    else:
        if a.stride()[0]:
            a = a.clone()
            a[..., 1] = (1 << 63) - 1
            a[..., 2] = (1 << 62) + m.p.expand(a.shape)[..., 2]
        got = zq.mul_cuda(a, b, bs, m)
        want = zq.mul_shoup_plain(a, b, bs, m)
    assert got.is_contiguous() and got.shape == want.shape
    assert torch.equal(got, want)
    assert got.reshape(-1).tolist() == _exact(a, b, m)
    assert on_host["zq_mul"] == 1


def _zq_plan(emulated, a, b, bs, m) -> tuple:
    """(merged dimensions, words a thread) of zq_mul's launch plan."""
    fn = emulated["zq_mul"].tpufhe_zq_mul_plan
    fn.argtypes = zq._ZQ_MUL_ARGS[:-1] + [ctypes.c_void_p]
    plan = (ctypes.c_longlong * 2)()
    _, args = zq.zq_mul_args(a, b, bs, m)
    assert fn(*args, plan) == 0
    return tuple(plan)


def test_zq_mul_kernel_takes_rows_off_a_16_byte_boundary(on_host, emulated):
    """Rows of even length whose first word is 8 bytes past a 16-byte
    boundary (one word a thread; the aligned rows take two, in 16-byte
    accesses), and a view of a transposed tensor."""
    a, b, bs, m = _zq_operands("row", 62, 7)
    shifted = torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape)
    assert shifted.data_ptr() % 16
    assert _zq_plan(emulated, a, b, bs, m) == (3, 2)
    assert _zq_plan(emulated, shifted, b, bs, m) == (3, 1)
    assert torch.equal(zq.mul_cuda(shifted, b, bs, m),
                       zq.mul_shoup_plain(a, b, bs, m))
    t = a.transpose(0, 1).contiguous().transpose(0, 1)
    assert not t.is_contiguous()
    assert torch.equal(zq.mul_cuda(t, b, None, m), zq.mul_plain(a, b, m))
    assert on_host["zq_mul"] == 2


@pytest.mark.parametrize("case,plan", [
    ("column", (3, 2)), ("row", (3, 2)), ("plaintext", (3, 2)),
    ("full", (3, 2)), ("staged", (4, 2)), ("outer_stride_0", (3, 2)),
    ("ragged_row", (3, 1)), ("ragged_full", (3, 1))])
def test_zq_mul_kernel_merges_the_broadcast_walk(emulated, case, plan):
    """The merged dimensions and words a thread of each case: the moduli's
    (k, 1) column keeps the limb dimension apart from the rows and the
    words (three dimensions; the switch-down's five and the fold's four
    merge to three), the NTT stages' (k, 1, 1) one more, and rows of odd
    length take one word a thread."""
    a, b, bs, m = _zq_operands(case, 62, 3)
    assert _zq_plan(emulated, a, b, bs, m) == plan


def test_zq_mul_kernel_refuses_more_dimensions_than_it_walks(on_host):
    """Broadcast patterns that leave seven dimensions after the merge
    raise; six run."""
    m = zq.ModTable(T.BfvParametersBuilder.generate_moduli([62], 64), "cpu",
                    (1, 1))
    a = torch.arange(3, 19, dtype=torch.int64).reshape(2, 1, 2, 1, 2, 1, 2)
    b = torch.arange(5, 13, dtype=torch.int64).reshape(1, 2, 1, 2, 1, 2, 1)
    with pytest.raises(RuntimeError):
        zq.mul_cuda(a, b, None, m)
    a, b = a[..., 0], b[..., 0]
    got = zq.mul_cuda(a, b, None, m)
    assert got.shape == (2, 2, 2, 2, 2, 2)
    assert torch.equal(got, zq.mul_plain(a, b, m))


def test_zq_mul_kernel_serves_the_glue_bound_cells(on_host, monkeypatch):
    """test_torch_obs's MulPIR batch (two queries: the expansion, then
    the switch to the last level without the response, whose plain
    versions would take the patched products too) and inner-product step
    with the glue's products (a context's mul and mul_shoup; the plain
    transforms keep their digit chains) on the emulated kernel: the same
    words as on the digit chains, and a launch for each of the 22 and 2
    products, plus the 4 Shoup products a doubling of ks_tail's plain
    version (2 digit rows, both key parts), which takes a context's
    mul_shoup too."""
    from test_torch_obs import one_torch_thread, served_programs

    programs = served_programs(batch=2, respond=False)
    with one_torch_thread():
        want = {name: [t.clone() for t in fn()]
                for name, fn in programs.items()}
    monkeypatch.setattr(Context, "mul",
                        lambda ctx, a, b: zq.mul_cuda(a, b, None, ctx.mod))
    monkeypatch.setattr(Context, "mul_shoup",
                        lambda ctx, a, b, bs: zq.mul_cuda(a, b, bs, ctx.mod))
    for name, launches in (("mulpir_batch", 22 + 4 * 7), ("ct_mul_pt", 2)):
        on_host["zq_mul"] = 0
        with one_torch_thread():
            got = programs[name]()
        assert len(got) == len(want[name])
        assert all(torch.equal(x, y) for x, y in zip(got, want[name]))
        assert on_host["zq_mul"] == launches


# expand_fold: (degree, limbs, ciphertexts L, batch B, bits of the moduli)
# of the doubling folds held against the plain version, each with and
# without the addend: one limb to three, N = 16 to 8192, L = 1 to 64
FOLD_CASES = [(16, 1, 1, 1, 62), (16, 3, 64, 16, 50), (64, 2, 8, 16, 55),
              (1024, 2, 32, 1, 62), (8192, 2, 1, 1, 55), (8192, 1, 2, 4, 62),
              (8192, 3, 1, 2, 50)]


def _fold_operands(n, k, l, b, bits, addend, seed):
    """(ctx, cur0, cur1, s0, ks0, ks1, mono, mono_shoup) of a fold of L
    ciphertexts of B rows: canonical words, ks0 None without the addend.
    The first five columns of every row hold edge words: a subtrahend
    above cur (0 against p - 1), p - 1 against p - 1, p - 1 against 0,
    0 against 0, and s0 + ks0 wrapping past p (p - 1 + p - 1)."""
    ctx = _context(n, k, bits)
    rng = np.random.default_rng(seed)
    p = np.array(ctx.moduli, np.uint64)[:, None]

    def words(shape):
        return rng.integers(0, 1 << 62, shape, dtype=np.uint64) % p

    cur0, cur1, s0, ks0, ks1 = (words((l, b, k, n)) for _ in range(5))
    edges = np.array([[0, p_ - 1, p_ - 1, 0, p_ - 3] for p_ in p[:, 0]],
                     np.uint64)  # cur
    subs = np.array([[p_ - 1, p_ - 1, 0, 0, p_ - 1] for p_ in p[:, 0]],
                    np.uint64)  # s0 and ks1
    for cur in (cur0, cur1):
        cur[..., :5] = edges
    s0[..., :5], ks1[..., :5] = subs, subs
    ks0[..., :5] = subs * np.array([0, 0, 0, 0, 1], np.uint64)
    mono = words((k, n))
    mono[:, 0] = p[:, 0] - 1
    t = [torch.from_numpy(x.astype(np.int64))
         for x in (cur0, cur1, s0, ks0, ks1, mono)]
    if not addend:
        t[3] = None
    return (ctx, *t, shoup_of(t[5], ctx.moduli))


def _fold_exact(ctx, cur0, cur1, s0, ks0, ks1, mono, mono_shoup):
    """The fold word by word in Python integers: both parts' rows."""
    p = np.array(ctx.moduli, dtype=object)[:, None]
    m = mono.numpy().astype(object)
    out = []
    for cur, sub, add in ((cur0, s0, ks0), (cur1, ks1, None)):
        c, s = cur.numpy().astype(object), sub.numpy().astype(object)
        if add is not None:
            s = (s + add.numpy().astype(object)) % p
        out.append(np.concatenate([(c + s) % p, (c - s) % p * m % p]).tolist())
    return out


@pytest.mark.parametrize("addend", [True, False])
@pytest.mark.parametrize("n,k,l,b,bits", FOLD_CASES)
def test_expand_fold_kernel_matches_plain(on_host, n, k, l, b, bits, addend):
    """Both parts of a doubling's fold word for word against
    expand_fold_plain (zq add, sub, mul_shoup and cat), in one launch; at
    the smallest case also against exact integers."""
    ops = _fold_operands(n, k, l, b, bits, addend, n + k + l + b + bits)
    got = tpl.expand_fold_cuda(*ops)
    want = tpl.expand_fold_plain(*ops)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2 * l, b, k, n) and g.is_contiguous()
        assert torch.equal(g, w)
    if n * l * b <= 16:
        assert [g.tolist() for g in got] == _fold_exact(*ops)
    assert on_host["expand_fold"] == 1


def _fold_plan(emulated, ctx, cur0, cur1, s0, ks0, ks1, mono, mono_shoup):
    """The words a thread takes in expand_fold's launch on these
    operands (outputs allocated aligned, as torch.empty does)."""
    fn = emulated["expand_fold"].tpufhe_expand_fold_plan
    fn.argtypes = tpl._EXPAND_FOLD_ARGS
    out = torch.empty((2, 2) + tuple(cur0.shape), dtype=torch.int64)
    plan = (ctypes.c_longlong * 1)()
    ptr = [None if t is None else t.data_ptr()
           for t in (cur0, cur1, s0, ks0, ks1, mono, mono_shoup)]
    assert fn(cur0.numel(), ctx.k, ctx.degree, *ptr, ctx.tables.p.data_ptr(),
              out[0].data_ptr(), out[1].data_ptr(), plan) == 0
    return plan[0]


def _shifted(x):
    """A contiguous copy of x whose first word is 8 bytes past a 16-byte
    boundary."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    assert y.data_ptr() % 16 == 8
    return y.copy_(x)


@pytest.mark.parametrize("which", [0, 2, 3, 5])
def test_expand_fold_kernel_takes_rows_off_a_16_byte_boundary(
        on_host, emulated, which):
    """An operand (cur0, s0, ks0 or the monomial) 8 bytes past a 16-byte
    boundary: one word a thread, scalar accesses (two where every
    operand is aligned), and the same words."""
    ops = list(_fold_operands(64, 2, 4, 2, 62, True, 11 + which))
    want = tpl.expand_fold_plain(*ops)
    assert _fold_plan(emulated, *ops) == 2
    ops[1 + which] = _shifted(ops[1 + which])
    assert _fold_plan(emulated, *ops) == 1
    got = tpl.expand_fold_cuda(*ops)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert on_host["expand_fold"] == 1


def test_expand_fold_kernel_refuses_mismatched_operands(on_host):
    """Operands of other shapes, or a monomial of another degree, raise
    before any launch."""
    ctx, *ops = _fold_operands(16, 2, 2, 1, 62, True, 5)
    bad = list(ops)
    bad[2] = ops[2][:1]
    with pytest.raises(ValueError):
        tpl.expand_fold_cuda(ctx, *bad)
    bad = list(ops)
    bad[5] = ops[5][:, :8].contiguous()
    with pytest.raises(ValueError):
        tpl.expand_fold_cuda(ctx, *bad)
    assert on_host["expand_fold"] == 0


@pytest.mark.parametrize("leveled", [True, False])
def test_expand_fold_kernel_serves_make_expand(on_host, monkeypatch, leveled):
    """One make_expand call into 2^7 ciphertexts each (at degree 128)
    with the fold on the emulated kernel: leveled, at MulPIR's shape (a
    batch of 16, moduli of 50, 55 and 55 bits, queries at level 1,
    expansion keys at level 0, the fold adding the key switch to s0), and
    with keys at the ciphertexts' level (a batch of 2 over 3 x 62 bits,
    the rotation's c0 as it comes). Exactly one expand_fold launch a doubling, no glue.zq counter
    inside a fold span, the glue outside them alone counted, and the
    words of the plain route, which test_torch_galois and
    test_torch_levels hold against tpufhe."""
    from test_torch_obs import bfv_params, one_torch_thread

    from tpufhe_torch.ops import zq as zq_mod

    levels, batch, n = 7, 16 if leveled else 2, 128
    rng = ChaCha8Rng(seed_from_u64(24))
    par = bfv_params(n, 1785857 if leveled else 65537,
                     [50, 55, 55] if leveled else [62, 62, 62])
    level = 1 if leveled else 0
    sk = T.SecretKey.random(par, rng)
    ek = (T.EvaluationKeyBuilder(sk, ciphertext_level=level,
                                 evaluation_key_level=0)
          .enable_expansion(levels).build(rng))
    cts = [sk.try_encrypt(T.Plaintext.try_encode(
        [i + 1, 0, 2], T.Encoding.poly(level), par), rng)
        for i in range(batch)]
    c0 = torch.stack([ct[0] for ct in cts])
    c1 = torch.stack([ct[1] for ct in cts])
    expand = tpl.make_expand(par, ek, levels, level=level)
    with one_torch_thread(), obs.recording() as plain_rec:
        want = expand(c0, c1)
    seen = []

    def spy(name, k=1):
        rec = obs._open
        if rec is not None and not rec._quiet:
            seen.append((name, tuple(rec._stack)))
        count(name, k)

    count = zq_mod.count
    monkeypatch.setattr(zq_mod, "count", spy)
    monkeypatch.setattr(tpl, "expand_fold_plain", tpl.expand_fold_cuda)
    with one_torch_thread(), obs.recording() as rec:
        got = expand(c0, c1)
    assert on_host["expand_fold"] == levels
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].shape == (1 << levels, batch, 2 if leveled else 3, n)
    names = {s.id: s.name for s in rec.spans}
    assert sum(names[i] == "fold" for i in names) == levels
    assert not [name for name, stack in seen
                if any(names[i] == "fold" for i in stack)]
    outside = {"glue.rq.substitute": 2 * levels}
    if leveled:  # the switch-down's add, sub and Shoup product
        outside.update({"rq.switch_down": levels, "glue.zq.add": levels,
                        "glue.zq.sub": levels, "glue.zq.mul_shoup": levels})
    counted = {k: v for k, v in rec.counters.items()
               if not k.startswith("launch.")}
    assert counted == outside == plain_rec.counters


# rq_pack / rq_unpack: the residues of m messages of a context, packed
# little-endian in bitlen(p - 1) bits each (rq_pack.py, csrc/rq_pack.cu)


def _rq_words(ctx, m, seed):
    """(m, k, n) canonical words of ctx's word type: random residues, each
    row's first word p - 1 and its last 0."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, p, (m, ctx.degree), dtype=np.uint64)
                  for p in ctx.moduli], axis=1)
    x[..., 0] = np.array(ctx.moduli, np.uint64) - 1
    x[..., -1] = 0
    return torch.from_numpy(x.astype(np.int32 if ctx.narrow else np.int64))


def _rq_round_trip(ctx, x, launches):
    """rq_pack's bytes equal the host transcode's; rq_unpack of them gives
    x back, as the host's unpack does; one launch each."""
    want = rq_pack.pack_plain(ctx, x)
    got = rq_pack.pack_cuda(ctx, x)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    payloads = [row.tobytes() for row in want]
    back = rq_pack.unpack_cuda(ctx, payloads)
    assert back.dtype == x.dtype and back.is_contiguous()
    assert torch.equal(back, x)
    assert torch.equal(rq_pack.unpack_plain(ctx, payloads), x)
    assert (launches["rq_pack"], launches["rq_unpack"]) == (1, 1)


def _width_context(nbits, n):
    """Two limbs of nbits and 63 - nbits bits, each modulus the largest of
    its width (every bit of a word in use): rows of 63 n / 8 bytes, so at
    n = 8 every row and the second limb's stream start off an 8-byte
    boundary."""
    moduli = tuple(min(1 << b, (1 << 62) - 1) for b in (nbits, 63 - nbits))
    return SimpleNamespace(q=[zq.Modulus(p) for p in moduli], moduli=moduli,
                           degree=n, narrow=False, k=2,
                           device=torch.device("cpu"))


@pytest.mark.parametrize("n", [8, 64])
@pytest.mark.parametrize("nbits", range(1, 63))
def test_rq_pack_kernels_match_the_host_transcode_at_every_width(
        on_host, nbits, n):
    ctx = _width_context(nbits, n)
    assert [q.nbits for q in ctx.q] == [nbits, 63 - nbits]
    _rq_round_trip(ctx, _rq_words(ctx, 3, nbits * n), on_host)


# (moduli sizes, n, messages): MulPIR's 50/55/55 bits (a query's one part,
# an answer's two), BASELINE config 5's 6 x 62 bits, the narrow 7 x 30 bits
# (int32 rows), at n = 8 (streams off an 8-byte boundary) up to 16384
RQ_CASES = [((50, 55, 55), 8192, 1), ((50, 55, 55), 8192, 2),
            ((50, 55, 55), 64, 16), ((50, 55, 55), 8, 16),
            ((62,) * 6, 16384, 1), ((62,) * 6, 64, 16), ((62,) * 6, 8, 2),
            ((30,) * 7, 8192, 2), ((30,) * 7, 64, 16), ((30,) * 7, 8, 1)]


@pytest.mark.parametrize("sizes,n,m", RQ_CASES)
def test_rq_pack_kernels_match_the_host_transcode_at_mixed_widths(
        on_host, sizes, n, m):
    ctx = _context(n, len(sizes), list(sizes))
    assert ctx.narrow == (max(sizes) <= 30)
    _rq_round_trip(ctx, _rq_words(ctx, m, n + m), on_host)


@pytest.mark.parametrize("where", [0, -1])
@pytest.mark.parametrize("limb", range(3))
@pytest.mark.parametrize("sizes", [(50, 55, 55), (30, 29, 30)])
def test_rq_unpack_flags_a_residue_out_of_range(on_host, sizes, limb, where):
    """A residue p (or 2^nbits - 1) at the first or last word of a limb of
    the second message: both routes raise the codec's error."""
    ctx = _context(64, 3, list(sizes))
    for value in (ctx.moduli[limb], (1 << ctx.q[limb].nbits) - 1):
        x = _rq_words(ctx, 2, limb)
        x[1, limb, where] = value
        payloads = [row.tobytes() for row in rq_pack.pack_plain(ctx, x)]
        for unpack in (rq_pack.unpack_cuda, rq_pack.unpack_plain):
            with pytest.raises(SerializationError,
                               match="Coefficient out of range"):
                unpack(ctx, payloads)
    assert on_host["rq_unpack"] == 2


@pytest.mark.parametrize("sizes", [(50, 55, 55), (30, 29, 30)])
def test_rq_pack_refuses_a_word_wider_than_its_bits(on_host, sizes):
    """A word of nbits + 1 bits, or a negative one, raises AssertionError
    on both routes, as the host transcode asserts."""
    ctx = _context(64, 3, list(sizes))
    for value in (1 << ctx.q[1].nbits, -1):
        x = _rq_words(ctx, 2, 5)
        x[1, 1, 7] = value
        for pack in (rq_pack.pack_cuda, rq_pack.pack_plain):
            with pytest.raises(AssertionError):
                pack(ctx, x)
    assert on_host["rq_pack"] == 2


def test_the_codec_takes_the_card_route_at_mulpir_q16s_parameters(
        on_host, monkeypatch):
    """The benchmark cell mulpir-q16's wire path with the kernels' route
    taken on CPU tensors: one query (level 1, seeded: one part) parsed and
    one answer (two parts at level 2) serialized count 3 card rows and no
    host rows, launch rq_unpack once and rq_pack once, and give the words
    and bytes of the host route."""
    par = (T.BfvParametersBuilder().set_degree(8192)
           .set_plaintext_modulus(1785857).set_moduli_sizes([50, 55, 55])
           .set_device("cpu").build())
    rng = ChaCha8Rng(seed_from_u64(22))
    sk = T.SecretKey.random(par, rng)
    query = sk.try_encrypt(T.Plaintext.try_encode(
        [3, 0, 5], T.Encoding.poly(1), par), rng).to_bytes()
    host = T.Ciphertext.from_bytes(query, par)
    answer = T.Ciphertext(par, list(host.c), 1)
    answer.switch_to_level(answer.max_switchable_level())
    want = answer.to_bytes()
    monkeypatch.setattr(rq_pack, "on_card", lambda x: True)
    with obs.recording() as rec:
        card = T.Ciphertext.from_bytes(query, par)
        got = T.Ciphertext(par, list(answer.c), answer.level).to_bytes()
    assert {k: n for k, n in rec.counters.items() if k.startswith("wire.")
            } == {"wire.card_rows": 3}
    assert (on_host["rq_unpack"], on_host["rq_pack"]) == (1, 1)
    assert all(torch.equal(a, b) for a, b in zip(card.c, host.c))
    assert card.seed == host.seed and got == want
