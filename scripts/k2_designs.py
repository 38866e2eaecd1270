"""Time K2's fixed-k_in instances against its general instance on one card.

    python3 scripts/k2_designs.py

tpufhe_torch/csrc/rns_scale.cu runs a fixed instance (k_in a template
parameter, the table in the launch's parameters) for the k_in its lists
name, and the general instance (residues in chunks, the table in shared
memory) for any other. This script builds one library from rns_scale.cu
plus an entry point that always takes the general instance (nvcc
-Xptxas -v: the registers of every instance are printed), holds both
torch.equal to the plain version, and times them with CUDA events in turns
fixed, general, general, fixed at the shapes the programs give K2: the
N = 8192, 3 x 62-bit, batch-64 mul+relin (extend 3 -> 4 new limbs,
down-scale 7 -> 3), the narrow 7 x 30-bit one on int32 rows (7 -> 9,
16 -> 7), N = 16384, 6 x 62-bit at batch 16 (6 -> 7, 13 -> 6), and the
8 x 62-bit and 8 x 30-bit down-scales at batch 16 (17 and 18 limbs, which
run the general instance either way). Prints the card, one line per shape
and, as its last line, one JSON object with every number. The library is
built into tpufhe_torch/_build/. Exits nonzero without a card.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from types import SimpleNamespace

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

REPS = 20
# tpufhe_rns_scale's interface, always on the general instance
GENERAL_ENTRY = r'''
#include "rns_scale.cu"

extern "C" int k2_general(const void* x, void* y, long long total, int n,
                          int k_in, const void* tab_dev, const void* tab_host,
                          int words, int size, int shift, int is_one,
                          int theta_gamma_sign, int word_bytes, void* stream) {
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  const cudaStream_t s = (cudaStream_t)stream;
  if (word_bytes == 8)
    return (int)launch_general<u64>(x, y, total, logn, k_in,
                                    (const u64*)tab_dev, words, size, shift,
                                    is_one, theta_gamma_sign, s);
  return (int)launch_general<u32>(x, y, total, logn, k_in, (const u64*)tab_dev,
                                  words, size, shift, is_one,
                                  theta_gamma_sign, s);
}
'''


def build(out_dir: str):
    """nvcc of rns_scale.cu with the general entry point. Returns (library,
    {instance: registers})."""
    from tpufhe_torch import kernels

    src = os.path.join(out_dir, "k2_designs.cu")
    lib = os.path.join(out_dir, "k2_designs.so")
    with open(src, "w") as f:
        f.write(GENERAL_ENTRY)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", kernels.CSRC, "-o", lib, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise SystemExit(f"nvcc exit {proc.returncode}\n{log}")
    regs, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[entry] = int(m.group(1))
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt and regs:
        names = subprocess.run([filt], input="\n".join(regs), text=True,
                               capture_output=True).stdout.splitlines()
        regs = dict(zip(names, regs.values()))
    return lib, regs


def shapes(gen):
    """(label, scaler, x, start, size) at the programs' shapes."""
    from tpufhe_torch.bfv import BfvParametersBuilder

    def par(n, sizes):
        return (BfvParametersBuilder().set_degree(n)
                .set_plaintext_modulus(cs.PLAINTEXT).set_moduli_sizes(sizes)
                .build())

    out = []
    for label, p, batch, both in (
            ("3 x 62-bit", par(cs.DEGREE, cs.MODULI_SIZES), cs.BATCH, True),
            ("7 x 30-bit", par(cs.DEGREE, cs.NARROW_MODULI_SIZES), cs.BATCH,
             True),
            ("N = 16384, 6 x 62-bit", par(cs.N16K, cs.N16K_MODULI_SIZES),
             cs.N16K_BATCH, True),
            ("8 x 62-bit", par(cs.DEGREE, [62] * 8), cs.WIDER_BATCH, False),
            ("8 x 30-bit", par(cs.DEGREE, [30] * 8), cs.WIDER_BATCH, False)):
        ctx = p.context_at_level(0)
        mp = p.context_level_at(0).mul_params()
        k, k_mul, n = ctx.k, mp.to_ctx.k, ctx.degree
        if both:
            x = cs.rand_residues((4, batch, k, n), ctx.tables.p, gen)
            out.append((f"{label} extend", mp.extender.rns_scaler, x, k,
                        k_mul - k))
        x = cs.rand_residues((3, batch, k_mul, n), mp.to_ctx.tables.p, gen)
        out.append((f"{label} down", mp.down_scaler.rns_scaler, x, 0, k))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_designs: no CUDA device", file=sys.stderr)
        return 2
    from tpufhe_torch import kernels

    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    sm_clock = float(cs.nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_rate = sms * cs.INT32_MULS_PER_CLOCK_PER_SM * sm_clock * 1e6
    os.makedirs(kernels.BUILD, exist_ok=True)
    lib_path, regs = build(kernels.BUILD)
    lib = ctypes.CDLL(lib_path)
    print(f"registers: {regs}", flush=True)
    # what kernels.function finds under the wrapper's symbol
    libs = {"fixed": SimpleNamespace(tpufhe_rns_scale=lib.tpufhe_rns_scale),
            "general": SimpleNamespace(tpufhe_rns_scale=lib.k2_general)}

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rows = []
    for label, sc, x, start, size in shapes(gen):
        want = sc.scale_plain(x, start, size)
        equal, times = {}, {name: [] for name in libs}
        for name in ("fixed", "general", "general", "fixed"):
            kernels._libs["rns_scale"] = libs[name]
            if name not in equal:
                equal[name] = torch.equal(sc.scale_cuda(x, start, size), want)
            times[name].append(cs.time_ms(
                lambda: sc.scale_cuda(x, start, size), REPS))
        bound = cs.Bound(int32_rate)
        coeffs = x.numel() // x.shape[-2]
        bound.add((x.numel() + coeffs * size) * x.element_size(),
                  cs.scale_ops(sc.factor.is_one, x.shape[-2], size, coeffs))
        bound_ms, bound_by = bound.result()
        rows.append({"label": label, "shape": list(x.shape), "size": size,
                     "equal": equal, "ms": times, "bound_ms": bound_ms,
                     "bound_by": bound_by})
        print(f"{label} {tuple(x.shape)} -> {size}: equal {equal}, fixed "
              f"{times['fixed']} ms, general {times['general']} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)
        del want
    kernels._libs.pop("rns_scale", None)
    print(json.dumps({"card": card, "registers": regs, "shapes": rows}))
    if not all(all(r["equal"].values()) for r in rows):
        raise SystemExit("an instance disagrees with the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
