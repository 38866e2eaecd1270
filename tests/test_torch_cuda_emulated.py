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
expansion, switch-down and a product by a plaintext. The
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
from tpufhe_torch.ops import dot, zq
from tpufhe_torch.ops import ntt as ntt_mod
from tpufhe_torch.ops.intt_scale import intt_scale_cuda, intt_scale_plain
from tpufhe_torch.ops.rns import ScalingFactor
from tpufhe_torch.ops.rq import Context, Scaler
from tpufhe_torch.parallel import ntt_dist as nd

EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")
SOURCES = ("ntt", "tensor_intt", "relin_tail", "rotate_tail", "ntt32",
           "intt_scale", "ct_pt_dot", "ks_accumulate", "ntt_dist", "zq_mul")
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
