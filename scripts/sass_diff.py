"""Compare the machine code (SASS) of kernels built from this tree and from
another checkout of the repo.

    python3 scripts/sass_diff.py OTHER_CHECKOUT [kernel ...]

Builds each named kernel source (default: ntt, tensor_intt, relin_tail,
rotate_tail, the kernels whose shared transform passes a change to
csrc/ntt_pass_device.cuh must leave alone) from both trees with the flags
of tpufhe_torch/kernels.py plus -cubin, disassembles both with cuobjdump
-sass, drops addresses, encodings and comments, and prints per kernel
whether every entry's instructions are the same, with the first differing
lines where they are not. Needs nvcc and cuobjdump (the CUDA toolkit), not
a card. Exits 1 if any kernel differs.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT = ("ntt", "tensor_intt", "relin_tail", "rotate_tail")


def sass(src: str, out_dir: str, tag: str) -> dict:
    """{entry: [instruction, ...]} of one source's cubin."""
    from tpufhe_torch import kernels

    cubin = os.path.join(out_dir, f"{tag}.cubin")
    flags = [f for f in kernels.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([kernels._nvcc(), *flags, "-cubin", "-o", cubin, src],
                   check=True, capture_output=True, text=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    out, entry = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            entry = m.group(1)
            out[entry] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", line)
        if m and entry:
            out[entry].append(m.group(1).strip())
    return out


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    names = sys.argv[2:] or DEFAULT
    same_all = True
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            mine = sass(os.path.join(ROOT, "tpufhe_torch", "csrc",
                                     f"{name}.cu"), tmp, f"{name}_this")
            theirs = sass(os.path.join(other, "tpufhe_torch", "csrc",
                                       f"{name}.cu"), tmp, f"{name}_other")
            same = mine == theirs
            same_all &= same
            count = sum(len(v) for v in mine.values())
            print(f"{name}: {len(mine)} entries, {count} instructions, "
                  f"{'same SASS' if same else 'SASS differs'}", flush=True)
            if not same:
                for entry in sorted(set(mine) | set(theirs)):
                    a, b = mine.get(entry, []), theirs.get(entry, [])
                    if a == b:
                        continue
                    diff = next((i for i, (x, y) in enumerate(zip(a, b))
                                 if x != y), min(len(a), len(b)))
                    print(f"  {entry}: {len(a)} vs {len(b)} instructions, "
                          f"first difference at {diff}: "
                          f"{a[diff:diff + 1]} vs {b[diff:diff + 1]}")
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
