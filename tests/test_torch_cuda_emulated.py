"""The CUDA sources of K1 (ntt.cu), K3 (tensor_intt.cu), K4 (relin_tail.cu)
and K5 (rotate_tail.cu), compiled with g++ against the CPU stand-in of
tests/cuda_emu (each CTA an OS thread, each CUDA thread a fiber switched at
barriers, distributed shared memory mapped between the cluster's threads)
and run through the port's own wrappers on CPU tensors, word for word
against their plain versions: every K1 instance (the general one, the fixed
n = 4096 and 8192 rows, the N = 16384 two-CTA split) in both directions,
K3's cluster of three and both tails. The card remains the judge of speed
and of races; this holds the kernels' arithmetic, indexing, barriers and
cluster exchanges on every CPU run."""

from __future__ import annotations

import ctypes
import os
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
from tpufhe_torch.ops import ntt as ntt_mod
from tpufhe_torch.ops.rq import Context

EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")
SOURCES = ("ntt", "tensor_intt", "relin_tail", "rotate_tail")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """{kernel name: ctypes library} of the four sources built with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the CUDA sources cannot be emulated")
    out = tmp_path_factory.mktemp("cuda_emu")

    def build(name):
        lib = str(out / f"{name}.so")
        cmd = [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w", "-I", EMU,
               "-include", "cuda_runtime.h", "-x", "c++",
               os.path.join(kernels.CSRC, f"{name}.cu"), "-x", "none",
               os.path.join(EMU, "emu.cpp"), "-o", lib, "-lpthread"]
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


def _context(n, k):
    return Context(T.BfvParametersBuilder.generate_moduli([62] * k, n), n,
                   "cpu")


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
