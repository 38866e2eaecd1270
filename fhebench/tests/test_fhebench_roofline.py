"""Each kernel's bytes and operations in fhebench/roofline/ equal
chip_smoke.py's arithmetic on the same launch, built on the CPU at
degree 64; and the trace names match the kernels' entry points."""

import re

import pytest
import torch

import chip_smoke
from fhebench.roofline import peaks
from fhebench.trace import roofline_modules
from tpufhe_torch import kernels
from tpufhe_torch.bfv import BfvParametersBuilder
from tpufhe_torch.pipeline import mul_basis

N = 64
MODS = roofline_modules()


def params(sizes):
    return (BfvParametersBuilder().set_degree(N).set_plaintext_modulus(65537)
            .set_moduli_sizes(sizes).set_device("cpu").build())


def rows(shape, ctx):
    x = torch.randint(0, 2 ** 40, shape, dtype=torch.int64)
    return torch.remainder(x, ctx.tables.p[:, None].long())


def cases():
    par = params([62, 62, 62])
    ctx = par.context_at_level(0)
    mb = mul_basis(par)
    cm = mb.ctx_mul
    key = chip_smoke.random_key(ctx, torch.Generator().manual_seed(1))
    x = rows((4, 5, 3, N), ctx)
    ext = rows((4, 5, cm.k, N), cm)
    dsc = rows((3, 5, 3, N), ctx)
    sl = slice(None)
    dot_ctx = params([50, 55, 55]).context_at_level(1)
    parts = [rows((7, 2, 2, N), dot_ctx)] * 2
    db = rows((7, 3, 2, N), dot_ctx)
    d = rows((3, 5, 3, N), ctx)
    a = rows((5, cm.k, N), cm)
    return [
        ("ntt", (x, ctx.tables, sl, False),
         chip_smoke.k1_case("t", x, ctx.tables, sl, False)),
        ("ntt", (x, ctx.tables, sl, True),
         chip_smoke.k1_case("t", x, ctx.tables, sl, True)),
        ("rns_scale", (mb.ext, x, 3, cm.k - 3),
         chip_smoke.k2_case("t", mb.ext, x, 3, cm.k - 3)),
        ("rns_scale", (mb.down, ext[0], 0, 3),
         chip_smoke.k2_case("t", mb.down, ext[0], 0, 3)),
        ("tensor_intt", (cm, ext), chip_smoke.k3_case("t", cm, ext)),
        ("relin_tail", (ctx, dsc, key),
         chip_smoke.k4_case("t", ctx, dsc, key)),
        ("rotate_tail", (ctx, x[0], x[1], key),
         chip_smoke.k5_case("t", ctx, x[0], x[1], key)),
        ("ks_tail", (ctx, x[0], key),
         chip_smoke.ks_tail_case("t", ctx, x[0], key)),
        ("ct_pt_dot", (dot_ctx, parts, db),
         chip_smoke.dot_case("t", dot_ctx, parts, db)),
        ("ks_accumulate", (ctx, d, key, d[0], None),
         chip_smoke.ks_case("t", ctx, d, key, d[0], None)),
        ("tensor", (cm, a, a, a, a), chip_smoke.k7_case("t", cm, a, a, a, a)),
        ("tensor", (cm, a, a, a[1:], a[1:]),
         chip_smoke.k7_case("t", cm, a, a, a[1:], a[1:])),
    ]


@pytest.mark.parametrize("case", range(12))
def test_cost_equals_chip_smoke(case):
    kernel, args, item = cases()[case]
    mod = MODS[kernel]
    assert mod.cost(mod.shape(*args)) == (item[3], item[4])


def test_peaks_equal_chip_smoke():
    assert peaks.MEM_BYTES_PER_S == chip_smoke.MEM_BYTES_PER_S
    assert (peaks.LO, peaks.HI, peaks.SHOUP, peaks.RED128, peaks.MULMOD,
            peaks.TENSOR_OPS) == (chip_smoke.LO, chip_smoke.HI,
                                  chip_smoke.SHOUP, chip_smoke.RED128,
                                  chip_smoke.MULMOD, chip_smoke.TENSOR_OPS)
    assert peaks.INT32_MULS_PER_S == 132 * chip_smoke.\
        INT32_MULS_PER_CLOCK_PER_SM * 1980e6


@pytest.mark.parametrize("kernel", sorted(MODS))
def test_trace_names_and_patch_targets(kernel):
    mod = MODS[kernel]
    assert kernel in kernels.KERNELS
    with open(f"{kernels.CSRC}/{kernels.KERNELS[kernel][0]}") as f:
        src = re.sub(r"__launch_bounds__\([^)]*\)", "", f.read())
    globals_ = re.findall(r"__global__[^(]*?\b(\w+)\s*\(", src)
    assert any(re.search(mod.TRACE, g) for g in globals_), globals_
    owner = __import__(mod.PATCH[0].split(":")[0], fromlist=["x"])
    if ":" in mod.PATCH[0]:
        owner = getattr(owner, mod.PATCH[0].split(":")[1])
    assert callable(getattr(owner, mod.PATCH[1]))
