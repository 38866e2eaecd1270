"""Time the key-switch tails K4 and K5 beside the unfused composition and
K1's per-row rate, with their registers, occupancy and phases, on one card.

    python3 scripts/tail_profile.py [--sweep] [--stamps]

tpufhe_torch/csrc/relin_tail.cu and rotate_tail.cu run one cluster of
one-row CTAs per (batch row, limb), each CTA transforming its row two
butterfly stages a pass (ntt_pass_device.cuh, shared with K1 and K3).
This script builds both sources into one library with nvcc -Xptxas -v,
which prints every instance's registers and spills (K1's and K3's too),
prints each tail's CTAs per SM and co-resident clusters
(cudaOccupancyMax*), holds both torch.equal to the
plain versions at the shapes chip_smoke.py checks plus one shape with more
than 16 rows a cluster (taken in rounds), and times each twice with CUDA
events beside the unfused composition (relin_tail_unfused /
rotate_tail_unfused: K1 forward of the stacked rows, ks_accumulate and the
glue) and beside K1 alone on the same number of transformed rows. --sweep
also times K5 at N = 8192, k = 4 over batches of 8 to 48 rows (32 to 192
clusters) and K1 forward over 132 to 792 rows, to show how a CTA's time
grows with the CTAs beside it. --stamps builds a second library whose K5
writes a globaltimer stamp a CTA at entry, around its transform and at
exit (TAIL_STAMP), runs it once at (32, 4, 8192) and prints quartiles of
each phase. The libraries are built into tpufhe_torch/_build/. Last line:
one JSON object with every number. Exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

REPS = 20
SOURCE = r'''
#include "relin_tail.cu"
#include "rotate_tail.cu"
'''
# --stamps: globaltimer stamps (ns) a CTA at the four TAIL_STAMP phases
STAMPED = r'''
__device__ unsigned long long tail_stamps[4 * 8192];

__device__ __forceinline__ unsigned long long stamp() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

#define TAIL_STAMP(phase) \
  if (threadIdx.x == 0) tail_stamps[4 * blockIdx.x + (phase)] = stamp();
''' + SOURCE + r'''
extern "C" int read_stamps(unsigned long long* host, int count) {
  return (int)cudaMemcpyFromSymbol(host, tail_stamps,
                                   count * sizeof(unsigned long long));
}
'''


def ptxas(log: str) -> dict:
    """{entry: 'R registers, S bytes spilled'} from nvcc -Xptxas -v."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry:
            out[entry] = f"spill stores {m.group(1)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = f"{m.group(1)} registers, " + out.get(entry, "")
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(out), text=True,
                               capture_output=True).stdout.splitlines()
        out = dict(zip(names, out.values()))
    return out


def build(out_dir: str, stamps: bool):
    """nvcc of both tails (and again with stamps), and of K1 and K3 for
    their registers, all at once. Returns ({name: library path}, {entry: ptxas
    summary})."""
    from tpufhe_torch import kernels

    jobs = {"tail": SOURCE} | ({"stamped": STAMPED} if stamps else {})
    outs = {}
    for name, text in jobs.items():
        src = os.path.join(out_dir, f"tail_profile_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        outs[name] = (src, os.path.join(out_dir, f"tail_profile_{name}.so"))
    for name in ("ntt", "tensor_intt"):
        outs[name] = (os.path.join(kernels.CSRC, f"{name}.cu"),
                      os.path.join(out_dir, f"tail_profile_{name}.so"))

    def nvcc(item):
        name, (src, lib) = item
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", kernels.CSRC, "-o", lib, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} exit {proc.returncode}\n{log}")
        return {f"{name}: {entry}": v for entry, v in ptxas(log).items()}

    regs = {}
    with ThreadPoolExecutor(len(outs)) as pool:
        for r in pool.map(nvcc, outs.items()):
            regs.update(r)
    return {name: lib for name, (_, lib) in outs.items()
            if name not in ("ntt", "tensor_intt")}, regs


def cases(gen):
    """(label, kind, ctx, args) at chip_smoke.py's tail shapes and one with
    more than 16 rows a cluster."""
    from tpufhe_torch.bfv import BfvParametersBuilder
    from tpufhe_torch.ops.rq import Context

    def ctx(n, sizes):
        return Context(BfvParametersBuilder.generate_moduli(sizes, n), n)

    out = []
    for batch, c in ((cs.BATCH, ctx(cs.DEGREE, cs.MODULI_SIZES)),
                     (cs.WIDER_BATCH, ctx(cs.DEGREE, [62] * 8)),
                     (8, ctx(4096, [62] * 2)),
                     (2, ctx(4096, [62] * 15))):
        dsc = cs.rand_residues((3, batch, c.k, c.degree), c.tables.p, gen)
        out.append((f"relin {tuple(dsc.shape)}", "relin", c,
                    (dsc, cs.random_key(c, gen))))
    for batch, c in ((cs.ROT_BATCH, ctx(cs.DEGREE, cs.ROT_MODULI_SIZES)),
                     (8, ctx(4096, [62] * 2)),
                     (2, ctx(2048, [62] * 17))):
        s0 = cs.rand_residues((batch, c.k, c.degree), c.tables.p, gen)
        c2 = cs.rand_residues((batch, c.k, c.degree), c.tables.p, gen)
        out.append((f"rotate {tuple(s0.shape)}", "rotate", c,
                    (s0, c2, cs.random_key(c, gen))))
    return out


def run_sweep(gen) -> dict:
    """Kept K5 over batches at N = 8192, k = 4 and K1 forward over row
    counts, each timed with CUDA events."""
    from tpufhe_torch import pipeline
    from tpufhe_torch.bfv import BfvParametersBuilder
    from tpufhe_torch.ops import ntt as ntt_mod
    from tpufhe_torch.ops.rq import Context

    ctx = Context(BfvParametersBuilder.generate_moduli(cs.ROT_MODULI_SIZES,
                                                       cs.DEGREE), cs.DEGREE)
    key = cs.random_key(ctx, gen)
    out = {"rotate_tail": {}, "ntt": {}}
    for batch in (8, 16, 23, 24, 32, 46, 48):
        s0 = cs.rand_residues((batch, ctx.k, ctx.degree), ctx.tables.p, gen)
        c2 = cs.rand_residues((batch, ctx.k, ctx.degree), ctx.tables.p, gen)
        out["rotate_tail"][batch * ctx.k] = cs.time_ms(
            lambda: pipeline.rotate_tail_cuda(ctx, s0, c2, key), REPS)
    for rows in (132, 264, 396, 528, 792):
        x = cs.rand_residues((rows // 4, 4, ctx.degree), ctx.tables.p, gen)
        out["ntt"][rows] = cs.time_ms(
            lambda: ntt_mod.ntt_cuda(x, ctx.tables, slice(None), False), REPS)
    print(f"sweep: rotate_tail ms by clusters {out['rotate_tail']}; ntt "
          f"forward ms by rows {out['ntt']}", flush=True)
    return out


def run_stamps(lib, gen) -> dict:
    """One launch of the kept K5 at (32, 4, 8192) with globaltimer stamps:
    per CTA the time from the launch's first CTA to its start, its load and
    reduction, its transform, and its slice phase with both cluster syncs
    (quartiles over the CTAs, us)."""
    from tpufhe_torch import kernels, pipeline
    from tpufhe_torch.bfv import BfvParametersBuilder
    from tpufhe_torch.ops.rq import Context

    ctx = Context(BfvParametersBuilder.generate_moduli(cs.ROT_MODULI_SIZES,
                                                       cs.DEGREE), cs.DEGREE)
    key = cs.random_key(ctx, gen)
    s0 = cs.rand_residues((cs.ROT_BATCH, ctx.k, ctx.degree), ctx.tables.p, gen)
    c2 = cs.rand_residues((cs.ROT_BATCH, ctx.k, ctx.degree), ctx.tables.p, gen)
    kernels._libs["rotate_tail"] = lib
    for _ in range(3):
        pipeline.rotate_tail_cuda(ctx, s0, c2, key)
    torch.cuda.synchronize()
    kernels._libs.pop("rotate_tail", None)
    ctas = cs.ROT_BATCH * ctx.k * ctx.k
    buf = (ctypes.c_ulonglong * (4 * ctas))()
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    kernels.check(lib.read_stamps(buf, 4 * ctas), "read_stamps")
    t = torch.tensor(list(buf), dtype=torch.float64).view(ctas, 4) / 1e3
    phases = {"start": t[:, 0] - t[:, 0].min(), "load": t[:, 1] - t[:, 0],
              "transform": t[:, 2] - t[:, 1], "slice": t[:, 3] - t[:, 2],
              "end": t[:, 3] - t[:, 0].min()}
    out = {name: [round(float(v), 2) for v in
                  torch.quantile(x, torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0],
                                                 dtype=torch.float64))]
           for name, x in phases.items()}
    print(f"stamps (us; min, quartiles, max over {ctas} CTAs): {out}",
          flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("tail_profile: no CUDA device", file=sys.stderr)
        return 2
    from tpufhe_torch import kernels, pipeline
    from tpufhe_torch.ops import ntt as ntt_mod

    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--stamps", action="store_true")
    opts = ap.parse_args()
    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    os.makedirs(kernels.BUILD, exist_ok=True)
    paths, regs = build(kernels.BUILD, opts.stamps)
    libs = {name: ctypes.CDLL(path) for name, path in paths.items()}
    print(f"ptxas: {regs}", flush=True)
    occ = {}
    # the main shapes' rows a cluster: K4 k + 2 = 5, K5 k = 4
    for kind, rows in (("relin", len(cs.MODULI_SIZES) + 2),
                       ("rotate", len(cs.ROT_MODULI_SIZES))):
        occ[kind] = cs.occupancy(
            getattr(libs["tail"], f"tpufhe_{kind}_tail_occupancy"), rows,
            cs.DEGREE)
    print(f"occupancy at N = {cs.DEGREE}: {occ}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rows_out = []
    for label, kind, ctx, args in cases(gen):
        name = f"{kind}_tail"
        if kind == "relin":
            plain, unfused = pipeline.relin_tail_plain, pipeline.relin_tail_unfused
            cuda = pipeline.relin_tail_cuda
            stacked = torch.cat([args[0][:2], pipeline._ksk_digits(ctx, args[0][2])])
        else:
            plain, unfused = pipeline.rotate_tail_plain, pipeline.rotate_tail_unfused
            cuda = pipeline.rotate_tail_cuda
            stacked = pipeline._ksk_digits(ctx, args[1])
        kernels._libs[name] = libs["tail"]
        equal = torch.equal(torch.stack(cuda(ctx, *args)),
                            torch.stack(plain(ctx, *args)))
        times = [cs.time_ms(lambda: cuda(ctx, *args), REPS) for _ in range(2)]
        kernels._libs.pop(name, None)
        unfused_ms = cs.time_ms(lambda: unfused(ctx, *args), REPS)
        tb = ctx.tables
        k1_ms = cs.time_ms(lambda: ntt_mod.ntt_cuda(stacked, tb, slice(None),
                                                    False), REPS)
        transformed = stacked.numel() // ctx.degree
        rec = {"label": label, "equal": equal, "ms": times,
               "unfused_ms": unfused_ms, "k1_ms": k1_ms,
               "rows_transformed": transformed,
               "us_per_row": {"tail": 1e3 * min(times) / transformed,
                              "k1": 1e3 * k1_ms / transformed}}
        rows_out.append(rec)
        print(f"{label}: equal {equal}, {times} ms, unfused {unfused_ms:.4f} "
              f"ms, K1 on the {transformed} rows {k1_ms:.4f} ms; us/row "
              f"{rec['us_per_row']}", flush=True)
        del stacked
    sweep = run_sweep(gen) if opts.sweep else None
    stamps = run_stamps(libs["stamped"], gen) if opts.stamps else None
    print(json.dumps({"card": card, "ptxas": regs, "occupancy": occ,
                      "sweep": sweep, "stamps": stamps, "cases": rows_out}))
    if not all(r["equal"] for r in rows_out):
        raise SystemExit("a tail instance disagrees with its plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
