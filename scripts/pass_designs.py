"""Time candidate launch designs of K9 (ntt32) and K8 (intt_scale) on one
card, with their registers and occupancy.

    python3 scripts/pass_designs.py

tpufhe_torch/csrc/ntt32.cu runs the narrow transform on the passes of
ntt_pass_device.cuh at NTT32_STAGES stages a pass, NTT32_THREADS threads a
CTA, asking for NTT32_MIN_BLOCKS CTAs an SM; tpufhe_torch/csrc/intt_scale.cu
runs its fixed shape (3 limbs of 8192) as a pair of CTAs, each holding half
of every limb, at K8_SPLIT_THREADS threads. Each candidate (DESIGNS) is a
copy of the kernel's source with those #define lines rewritten, built with
nvcc -Xptxas -v, which prints every instance's registers and spills, and
loaded in place of the kernel's library, with the Python plan's constants
of kernels.py set to match. The script holds each candidate torch.equal to
the plain version at the shapes chip_smoke.py checks (K9: the narrow
mul+relin's four transforms and the rotation's two at N = 8192 /
7 x 30-bit; K8: the default fused extend and the kP = 2 extends at
N = 8192 / 3 x 62-bit, batch 64), prints each candidate's CTAs per SM and
clusters at once (cudaOccupancyMax*), and times the candidates in turns,
twice each, with CUDA events, K8 beside the split K1 inverse + K2 pair it
fuses. The sources and libraries go to tpufhe_torch/_build/. Last line:
one JSON object with every number. Exits nonzero without a card.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(ROOT))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tail_profile import ptxas  # noqa: E402

REPS = 20
# name -> (kernel, the source's #define values, the Python plan's constants)
DESIGNS = {
    "k9_s2_t512": ("ntt32", {"NTT32_STAGES": 2, "NTT32_THREADS": 512,
                             "NTT32_MIN_BLOCKS": 4},
                   {"NARROW_PASS_STAGES": 2, "NTT32_THREADS": 512}),
    "k9_s2_t256": ("ntt32", {"NTT32_STAGES": 2, "NTT32_THREADS": 256,
                             "NTT32_MIN_BLOCKS": 6},
                   {"NARROW_PASS_STAGES": 2, "NTT32_THREADS": 256}),
    "k9_s3_t256": ("ntt32", {"NTT32_STAGES": 3, "NTT32_THREADS": 256,
                             "NTT32_MIN_BLOCKS": 6},
                   {"NARROW_PASS_STAGES": 3, "NTT32_THREADS": 256}),
    "k9_s3_t128": ("ntt32", {"NTT32_STAGES": 3, "NTT32_THREADS": 128,
                             "NTT32_MIN_BLOCKS": 6},
                   {"NARROW_PASS_STAGES": 3, "NTT32_THREADS": 128}),
    "k9_s3_t512": ("ntt32", {"NTT32_STAGES": 3, "NTT32_THREADS": 512,
                             "NTT32_MIN_BLOCKS": 4},
                   {"NARROW_PASS_STAGES": 3, "NTT32_THREADS": 512}),
    "k8_pair_t384": ("intt_scale", {"K8_SPLIT_THREADS": 384},
                     {"K8_SPLIT_THREADS": 384}),
    "k8_pair_t512": ("intt_scale", {"K8_SPLIT_THREADS": 512},
                     {"K8_SPLIT_THREADS": 512}),
}


def source(kernel: str, defines: dict) -> str:
    """The kernel's source with each named #define set to its value."""
    from tpufhe_torch import kernels

    with open(os.path.join(kernels.CSRC, f"{kernel}.cu")) as f:
        text = f.read()
    for name, value in defines.items():
        text, found = re.subn(rf"^#define {name} \S+$",
                              f"#define {name} {value}", text,
                              flags=re.MULTILINE)
        if found != 1:
            raise SystemExit(f"{kernel}.cu: #define {name} found {found} times")
    return text


def build(out_dir: str):
    """nvcc of every design at once: ({design: library path}, {design:
    {entry: ptxas summary}})."""
    from tpufhe_torch import kernels

    def nvcc(item):
        name, (kernel, defines, _) = item
        src = os.path.join(out_dir, f"pass_designs_{name}.cu")
        with open(src, "w") as f:
            f.write(source(kernel, defines))
        lib = os.path.join(out_dir, f"pass_designs_{name}.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", kernels.CSRC, "-o", lib, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} exit {proc.returncode}\n{log}")
        return name, lib, ptxas(log)

    with ThreadPoolExecutor(len(DESIGNS)) as pool:
        done = list(pool.map(nvcc, DESIGNS.items()))
    return ({name: lib for name, lib, _ in done},
            {name: regs for name, _, regs in done})


class Design:
    """A built candidate put in place of its kernel's library, with the
    plan constants it was built for; the NTT tables' pass-ordered caches
    are dropped on entry and exit, since K9's order depends on its stages."""

    def __init__(self, name: str, lib, tables: list):
        self.kernel, _, self.consts = DESIGNS[name]
        self.lib, self.tables = lib, tables

    def __enter__(self):
        from tpufhe_torch import kernels

        self.saved = {k: getattr(kernels, k) for k in self.consts}
        for k, v in self.consts.items():
            setattr(kernels, k, v)
        kernels._libs[self.kernel] = self.lib
        for t in self.tables:
            t._passes.clear()
        return self

    def __exit__(self, *exc):
        from tpufhe_torch import kernels

        for k, v in self.saved.items():
            setattr(kernels, k, v)
        kernels._libs.pop(self.kernel, None)
        for t in self.tables:
            t._passes.clear()


def occupancy(lib, kernel: str) -> dict:
    """CTAs per SM and clusters at once of the design's N = 8192 instance,
    under its plan (inside its Design)."""
    from tpufhe_torch import kernels

    blocks, clusters = ctypes.c_int(), ctypes.c_int()
    if kernel == "ntt32":
        fn = lib.tpufhe_ntt32_occupancy
        cluster, threads, _ = kernels.ntt32_plan(8192)
        args = (8192, 0, threads)
    else:
        fn = lib.tpufhe_intt_scale_occupancy
        cluster, threads, _ = kernels.intt_scale_plan(3, 8192)
        args = (3, 8192, threads)
    fn.argtypes = cs.OCC_ARGS
    fn.restype = ctypes.c_int
    err = fn(*args, ctypes.byref(blocks), ctypes.byref(clusters))
    if err:
        raise SystemExit(f"occupancy of {kernel}: cudaError {err}")
    return {"cluster": cluster, "threads": threads,
            "blocks_per_sm": blocks.value, "clusters": clusters.value}


def main() -> int:
    if not torch.cuda.is_available():
        print("pass_designs: no CUDA device", file=sys.stderr)
        return 2
    from tpufhe_torch import kernels, pipeline
    from tpufhe_torch.bfv import BfvParametersBuilder
    from tpufhe_torch.ops import ntt as ntt_mod
    from tpufhe_torch.ops.intt_scale import intt_scale_cuda, intt_scale_plain

    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    os.makedirs(kernels.BUILD, exist_ok=True)
    kernels.build(["ntt", "rns_scale"])
    paths, regs = build(kernels.BUILD)
    libs = {name: ctypes.CDLL(path) for name, path in paths.items()}
    print(f"ptxas: {json.dumps(regs)}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def params(sizes):
        return (BfvParametersBuilder().set_degree(cs.DEGREE)
                .set_plaintext_modulus(cs.PLAINTEXT).set_moduli_sizes(sizes)
                .build())

    # K9 at chip_smoke.py's narrow shapes
    par_w30 = params(cs.NARROW_MODULI_SIZES)
    ctx = par_w30.context_at_level(0)
    ctx_mul = par_w30.context_level_at(0).mul_params().to_ctx
    k, k_mul, n, b = ctx.k, ctx_mul.k, cs.DEGREE, cs.BATCH
    t_ctx, t_mul = ctx.tables, ctx_mul.tables
    full, new = slice(None), slice(k, k_mul)
    k9_cases = [
        ("extend", cs.rand_residues((4, b, k, n), t_ctx.p, gen), t_ctx, full,
         True),
        ("new limbs", cs.rand_residues((4, b, k_mul - k, n), t_mul.p[new],
                                       gen), t_mul, new, False),
        ("tensor parts", cs.rand_residues((3, b, k_mul, n), t_mul.p, gen),
         t_mul, full, True),
        ("tail", cs.rand_residues((2 + k, b, k, n), t_ctx.p, gen), t_ctx,
         full, False),
        ("rotation c1", cs.rand_residues((cs.ROT_BATCH, k, n), t_ctx.p, gen),
         t_ctx, full, True),
        ("rotation digits", cs.rand_residues((k, cs.ROT_BATCH, k, n),
                                             t_ctx.p, gen), t_ctx, full,
         False),
    ]

    def k9_want(x, tb, sl, inverse):
        if inverse:
            return ntt_mod.backward32_plain(x, tb.zetas_inv[sl], tb.ninv[sl],
                                            tb.p[sl])
        return ntt_mod.forward32_plain(x, tb.omegas[sl], tb.p[sl])

    k9_wants = [k9_want(x, tb, sl, inv) for _, x, tb, sl, inv in k9_cases]

    # K8 at the fused extends
    par = params(cs.MODULI_SIZES)
    wctx = par.context_at_level(0)
    mb = pipeline.mul_basis(par)
    s2 = pipeline.mul_basis(par, strategy2_primes=2)
    kw = wctx.k
    x4 = cs.rand_residues((4, b, kw, n), wctx.tables.p, gen)
    k8_groups = {
        "default extend": [(mb.ext, x4, kw, mb.ctx_mul.k - kw)],
        "kP=2 extends": [(s2.ext, x4[:2], kw, s2.ctx_mul.k - kw),
                         (s2.rhs, x4[2:], 0, s2.ctx_mul.k)],
    }
    k8_wants = {g: [intt_scale_plain(wctx, *args) for args in items]
                for g, items in k8_groups.items()}
    tables = [t_ctx, t_mul, wctx.tables]

    def k9_run():
        return [ntt_mod.ntt32_cuda(x, tb, sl, inv)
                for _, x, tb, sl, inv in k9_cases]

    def k8_run(group):
        return [intt_scale_cuda(wctx, *args) for args in k8_groups[group]]

    out = {"card": card, "ptxas": regs, "designs": {}}
    for name in DESIGNS:
        kernel = DESIGNS[name][0]
        rec = {}
        with Design(name, libs[name], tables):
            rec["occupancy"] = occupancy(libs[name], kernel)
            if kernel == "ntt32":
                got = k9_run()
                rec["equal"] = all(torch.equal(g, w)
                                   for g, w in zip(got, k9_wants))
            else:
                rec["equal"] = all(torch.equal(g, w) for grp in k8_groups
                                   for g, w in zip(k8_run(grp),
                                                   k8_wants[grp]))
        torch.cuda.synchronize()
        out["designs"][name] = rec
        print(f"{name}: {rec}", flush=True)

    def split_ms(group):
        def run():
            for scaler, x, start, size in k8_groups[group]:
                scaler.scale_cuda(ntt_mod.ntt_cuda(x, wctx.tables, full,
                                                   True), start, size)
        return cs.time_ms(run, REPS)

    out["k8_split_ms"] = {}
    for turn in range(2):
        for name in DESIGNS:
            kernel = DESIGNS[name][0]
            rec = out["designs"][name]
            with Design(name, libs[name], tables):
                if kernel == "ntt32":
                    times = {label: cs.time_ms(
                        lambda x=x, tb=tb, sl=sl, inv=inv:
                        ntt_mod.ntt32_cuda(x, tb, sl, inv), REPS)
                        for label, x, tb, sl, inv in k9_cases}
                    times["mul+relin (4)"] = sum(
                        times[c[0]] for c in k9_cases[:4])
                    times["rotation (2)"] = sum(
                        times[c[0]] for c in k9_cases[4:])
                else:
                    times = {g: cs.time_ms(lambda g=g: k8_run(g), REPS)
                             for g in k8_groups}
            rec.setdefault("ms", []).append(times)
            print(f"turn {turn} {name}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in times.items()),
                  flush=True)
        for g in k8_groups:
            out["k8_split_ms"].setdefault(g, []).append(split_ms(g))
        print(f"turn {turn} split K1 inverse + K2: {out['k8_split_ms']}",
              flush=True)
    print(json.dumps(out))
    if not all(r["equal"] for r in out["designs"].values()):
        raise SystemExit("a design disagrees with its plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
