"""The CUDA sources of K1 (ntt.cu), K3 (tensor_intt.cu), K4 (relin_tail.cu),
K5 (rotate_tail.cu), K8 (intt_scale.cu), K9 (ntt32.cu), ct_pt_dot
(ct_pt_dot.cu) and ks_accumulate (ks_accumulate.cu, its <<<>>> launches
rewritten as calls of the stand-in's emu_chevron), compiled with g++
against the CPU stand-in of tests/cuda_emu (each CTA an OS thread, each CUDA
thread a fiber switched at barriers, distributed shared memory mapped
between the cluster's threads) and run through the port's own wrappers on
CPU tensors, word for word against their plain versions: every K1 instance
(the general one, the fixed n = 4096 and 8192 rows, the N = 16384 two-CTA
split) in both directions, K3's cluster of three, both tails, K9's narrow
passes (the general instance, a row of one pass at n = 8, the fixed
n = 8192) in both directions, K8's cluster (the fixed k_in = 3 instances
and the general one, with more limbs than CTAs), ct_pt_dot's 128-bit
sums across its reduction windows at each of its instances, through its
ring of cp.async stages (tests/cuda_emu/cuda_pipeline.h carries a
thread's copies out only when it waits for them), and ks_accumulate's
Garner, digit and leveled rows (fewer digit rows than key limbs). The
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
from tpufhe_torch.ops import dot
from tpufhe_torch.ops import ntt as ntt_mod
from tpufhe_torch.ops.intt_scale import intt_scale_cuda, intt_scale_plain
from tpufhe_torch.ops.rns import ScalingFactor
from tpufhe_torch.ops.rq import Context, Scaler

EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")
SOURCES = ("ntt", "tensor_intt", "relin_tail", "rotate_tail", "ntt32",
           "intt_scale", "ct_pt_dot", "ks_accumulate")
# the sources that launch with <<<>>>, rewritten for g++ before the build
CHEVRON = ("ks_accumulate",)


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
        fn = getattr(emulated[name], symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    def require(name, dtype, *tensors):
        for t in tensors:
            assert t.dtype == dtype and t.is_contiguous(), name

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
