"""Time candidate designs of ct_pt_dot on one card, with each instance's
registers, spills and launch plan.

    python3 scripts/dot_designs.py [OTHER_CHECKOUT ...]

tpufhe_torch/csrc/ct_pt_dot.cu serves every part of an output word in one
thread, DOT_THREADS threads a CTA, and keeps a ring of DOT_RING_WORDS
words of terms in flight in shared memory a thread. Each candidate
(DESIGNS) is a copy of the source with those #define lines rewritten;
each OTHER_CHECKOUT (a checkout of another commit, or any directory
holding tpufhe_torch/csrc/ct_pt_dot.cu, each with a distinct name) gives
one more candidate, named after its directory, whose C entry point takes
the same arguments. Every candidate is built with nvcc -Xptxas -v
(registers and spills of every instance), loaded in place of the
kernel's library, held torch.equal to the plain version at
chip_smoke.py's phase-3 shapes of the kernel, and timed with CUDA events
in turns (the candidates in order, then in reverse), 20 calls after a
warm-up each, beside the bytes bound of chip_smoke.py's dot_case. Prints
the card's name and power limit, one line per shape and candidate, and
as its last line one JSON object with every number. The sources and
libraries go to tpufhe_torch/_build/. Exits nonzero without a card or if
a candidate disagrees with the plain version.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(ROOT))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tail_profile import ptxas  # noqa: E402

REPS = 20
# name -> the source's #define values
DESIGNS = {
    "r16_t128": {},
    "r32": {"DOT_RING_WORDS": 32},
    "r64": {"DOT_RING_WORDS": 64},
    "t256": {"DOT_THREADS": 256},
}


def source(text: str, defines: dict) -> str:
    """The kernel's source with each named #define set to its value."""
    for name, value in defines.items():
        text, found = re.subn(rf"^#define {name} \S+$",
                              f"#define {name} {value}", text,
                              flags=re.MULTILINE)
        if found != 1:
            raise SystemExit(f"ct_pt_dot.cu: #define {name} found {found} "
                             "times")
    return text


def build(out_dir: str, others: list):
    """nvcc of every candidate, all at once. Returns ({name: library},
    {name: {instance: ptxas summary}})."""
    from tpufhe_torch import kernels

    with open(os.path.join(kernels.CSRC, "ct_pt_dot.cu")) as f:
        text = f.read()
    jobs = {name: source(text, d) for name, d in DESIGNS.items()}
    for other in others:
        name = os.path.basename(other.rstrip("/"))
        if name in jobs:
            raise SystemExit(f"two candidates named {name}")
        with open(os.path.join(other, "tpufhe_torch", "csrc",
                               "ct_pt_dot.cu")) as f:
            jobs[name] = f.read()

    def nvcc(item):
        name, text = item
        src = os.path.join(out_dir, f"dot_designs_{name}.cu")
        lib = os.path.join(out_dir, f"dot_designs_{name}.so")
        with open(src, "w") as f:
            f.write(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", kernels.CSRC, "-o", lib, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} exit {proc.returncode}\n{log}")
        return name, lib, ptxas(log)

    libs, regs = {}, {}
    with ThreadPoolExecutor(len(jobs)) as pool:
        for name, lib, r in pool.map(nvcc, jobs.items()):
            libs[name], regs[name] = lib, r
    return libs, regs


def plan(lib, nparts: int, m: int, plane: int) -> dict:
    """A candidate's launch plan and CTAs per SM at one call."""
    args = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    lib.tpufhe_ct_pt_dot_plan.argtypes = args
    lib.tpufhe_ct_pt_dot_occupancy.argtypes = args
    out = (ctypes.c_longlong * 7)()
    blocks = ctypes.c_int()
    if (lib.tpufhe_ct_pt_dot_plan(nparts, m, plane, out)
            or lib.tpufhe_ct_pt_dot_occupancy(nparts, m, plane,
                                              ctypes.byref(blocks))):
        raise SystemExit("ct_pt_dot plan or occupancy failed")
    keys = ("parts", "columns", "stages", "threads", "blocks",
            "shared_bytes", "general")
    return dict(zip(keys, out)) | {"blocks_per_sm": blocks.value}


def shapes(gen):
    """(label, ctx, parts, db) at chip_smoke.py's phase-3 shapes."""
    from tpufhe_torch.bfv import BfvParameters, BfvParametersBuilder

    def ctx(n, sizes):
        return (BfvParametersBuilder().set_degree(n)
                .set_plaintext_modulus(cs.PLAINTEXT).set_moduli_sizes(sizes)
                .build().context_at_level(0))

    rot = ctx(cs.DEGREE, cs.DOT_MODULI_SIZES)
    main = ctx(cs.DEGREE, cs.MODULI_SIZES)
    d128 = next(p for p in BfvParameters.default_parameters_128(cs.D128_BITS)
                if p.degree() == cs.DEGREE).context_at_level(0)
    cases = [("dot bench", rot, 2, cs.DOT_PAIRS, 1, 1),
             ("PIR first dimension", ctx(cs.N16K, cs.N16K_MODULI_SIZES), 2,
              *cs.DOT_PIR, 1)]
    cases += [(f"{t} terms", main, 2, t, 1, 1) for t in cs.DOT_WINDOW_TERMS]
    cases += [(f"rq.dot_product of {cs.DOT_SCALAR}, rows folded", rot, 1,
               cs.DOT_SCALAR, 1, cs.DOT_FOLD),
              (f"three-part dot_product_scalar of {cs.DOT_SCALAR}", rot, 3,
               cs.DOT_SCALAR, 1, 1),
              (f"{cs.DOT_D128_TERMS} terms, 5 x 44-bit", d128, 2,
               cs.DOT_D128_TERMS, 1, 1)]
    for label, c, nparts, n, m, fold in cases:
        p = c.tables.p.repeat(fold)
        r = c.k * fold
        parts = [cs.rand_residues((n, 1, r, c.degree), p, gen)
                 for _ in range(nparts)]
        yield label, c, parts, cs.rand_residues((n, m, r, c.degree), p, gen)


def main() -> int:
    if not torch.cuda.is_available():
        print("dot_designs: no CUDA device", file=sys.stderr)
        return 2
    from tpufhe_torch import kernels
    from tpufhe_torch.ops import dot

    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    sm_clock = float(cs.nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_rate = sms * cs.INT32_MULS_PER_CLOCK_PER_SM * sm_clock * 1e6
    os.makedirs(kernels.BUILD, exist_ok=True)
    paths, regs = build(kernels.BUILD, [os.path.abspath(a)
                                        for a in sys.argv[1:]])
    print(f"ptxas: {json.dumps(regs)}", flush=True)
    libs = {name: ctypes.CDLL(path) for name, path in paths.items()}
    order = list(libs) + list(reversed(libs))

    def use(name):
        # what kernels.function finds for the wrapper's symbol
        kernels._libs["ct_pt_dot"] = SimpleNamespace(
            tpufhe_ct_pt_dot=libs[name].tpufhe_ct_pt_dot)
        dot._LAUNCHERS.clear()

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rows = []
    for label, ctx, parts, db in shapes(gen):
        _, _, _, nbytes, ops = cs.dot_case(label, ctx, parts, db)
        bound = cs.Bound(int32_rate)
        bound.add(nbytes, ops)
        bound_ms, bound_by = bound.result()
        want = dot.ct_pt_dot_plain(ctx, parts, db)
        n, m, r = db.shape[:3]
        plane = parts[0].shape[1] * r * ctx.degree
        equal, times = {}, {name: [] for name in libs}
        for name in order:
            use(name)
            if name not in equal:
                equal[name] = torch.equal(dot.ct_pt_dot_cuda(ctx, parts, db),
                                          want)
            times[name].append(cs.time_ms(
                lambda: dot.ct_pt_dot_cuda(ctx, parts, db), REPS))
        # another checkout's plan entry point may take other arguments
        plans = {name: plan(lib, len(parts), m, plane) if name in DESIGNS
                 else None for name, lib in libs.items()}
        rows.append({"label": label, "equal": equal, "ms": times,
                     "plans": plans, "bound_ms": bound_ms,
                     "bound_by": bound_by})
        for name in libs:
            print(f"{label} {name}: equal {equal[name]}, ms {times[name]}, "
                  f"bound {bound_ms:.4f} ({bound_by}), plan {plans[name]}",
                  flush=True)
        del want
    kernels._libs.pop("ct_pt_dot", None)
    dot._LAUNCHERS.clear()
    print(json.dumps({"card": card, "ptxas": regs, "shapes": rows}))
    if not all(all(r["equal"].values()) for r in rows):
        raise SystemExit("a candidate disagrees with the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
