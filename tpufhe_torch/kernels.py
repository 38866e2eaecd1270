"""Build, load and count the hand-written CUDA kernels.

Each kernel is one source in ``tpufhe_torch/csrc/`` with a plain C entry
point. It is compiled at first use with nvcc for ``sm_90a`` into
``tpufhe_torch/_build/`` (named by a hash of its sources, so an edited
source is rebuilt) and loaded with ctypes. ``build()`` compiles every kernel
at once, one nvcc process per source, all started together.

Every wrapper calls ``count(name)`` right where it launches its kernel, and
only there, so a run can show which kernels a path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD = os.path.join(_DIR, "_build")

# kernel name -> (source, the TPU kernel it replaces)
KERNELS = {
    "ntt": ("ntt.cu", "tpufhe/ops/pallas/mxu_ntt_kernel.py:319 _mxu4_kernel"
                      " and tpufhe/ops/pallas/ntt_kernel.py:109 _ntt_kernel"),
    "rns_scale": ("rns_scale.cu",
                  "tpufhe/ops/pallas/rns_kernel.py:361 _scale_kernel_bc"),
    "tensor_intt": ("tensor_intt.cu",
                    "tpufhe/ops/pallas/mxu_ntt_kernel.py:738 _tensor_intt_kernel"),
    "relin_tail": ("relin_tail.cu",
                   "tpufhe/ops/pallas/mxu_ntt_kernel.py:464 _relin_tail_kernel"
                   " (mode relin)"),
    "rotate_tail": ("rotate_tail.cu",
                    "tpufhe/ops/pallas/mxu_ntt_kernel.py:464 _relin_tail_kernel"
                    " (mode rotate)"),
    "tensor": ("tensor.cu",
               "tpufhe/ops/pallas/tensor_kernel.py:57 _tensor_kernel"),
    "intt_scale": ("intt_scale.cu",
                   "tpufhe/ops/pallas/intt_scale_kernel.py:59 _intt_scale_kernel"),
    # the narrow (w30) transform; also stands for tpufhe's four-step
    # ntt_mxu.forward_mxu32 / backward_mxu32, its TPU route at N >= 1024
    "ntt32": ("ntt32.cu", "tpufhe/ops/pallas/ntt32_kernel.py:76 _ntt32_kernel"),
    # no Pallas counterpart: tpufhe's unfused tail runs this accumulate in
    # XLA wherever its fused tail kernel does not fit
    "ks_accumulate": ("ks_accumulate.cu",
                      "tpufhe/pipeline.py:564-569 _ksk_accumulate (XLA, where "
                      "tail_kernel_fits is false)"),
}
HEADERS = ("modarith.cuh", "ntt_device.cuh", "keyswitch_device.cuh",
           "rns_scale_device.cuh")
# Shared memory one block may use on sm_90 (dynamic, above the 48 KB default);
# the NTT-based kernels hold whole rows of N words in it (8 bytes a word,
# 4 for the narrow rows of ntt32).
SMEM_BYTES = 232448


def tail_fits(n: int, word_bytes: int = 8) -> bool:
    """Whether three rows of n words fit in one block's shared memory: the
    fused tensor + iNTT kernel (K3) needs it. Where it is false the programs
    take the unfused composition (K7, K1 and ks_accumulate in place of K3,
    K4 and K5), as tpufhe does where its tail kernel does not fit. The
    tails K4 and K5 hold one row a CTA, but follow the same route."""
    return 3 * n * word_bytes <= SMEM_BYTES


# The tails' CTAs (csrc/keyswitch_device.cuh): at most TAIL_THREADS threads,
# clusters of at most TAIL_CLUSTER_MAX CTAs (above 8 the card's
# non-portable cluster size), TAIL_STAGES butterfly stages a transform pass.
TAIL_THREADS = 512
TAIL_CLUSTER_MAX = 16
TAIL_STAGES = 2


def tail_passes(logn: int) -> list[tuple[int, int]]:
    """(first stage, stages) of each pass of the tails' forward transform at
    n = 2^logn: one pass of logn mod TAIL_STAGES stages, then TAIL_STAGES
    a pass."""
    lead = logn % TAIL_STAGES
    return ([(0, lead)] if lead else []) + [
        (s0, TAIL_STAGES) for s0 in range(lead, logn, TAIL_STAGES)]


def tail_twiddle_order(n: int) -> list[int]:
    """Indices into a limb's bit-reversed omegas in the order the tails'
    transform reads them: per pass (s0, S) and stage-s0 group g, the
    2^S - 1 twiddles of the group's unit, stage s0 + r's j-th at
    2^(s0+r) + g 2^r + j. Every index 1 .. n - 1 once, then 0 to pad the
    table to n entries."""
    order = []
    for s0, s in tail_passes(n.bit_length() - 1):
        for g in range(1 << s0):
            for r in range(s):
                order.extend((1 << (s0 + r)) + (g << r) + j
                             for j in range(1 << r))
    return order + [0]


def tail_plan(rows: int, n: int) -> tuple[int, int, int]:
    """Launch plan of the key-switch tails K4 (rows = k + 2 transformed
    rows per batch row and limb) and K5 (rows = k): (CTAs per cluster,
    threads per CTA, shared bytes per CTA). One CTA per row; above
    TAIL_CLUSTER_MAX rows the cluster takes them in rounds."""
    return (min(rows, TAIL_CLUSTER_MAX), max(1, min(n // 2, TAIL_THREADS)),
            8 * n)


NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {name: 0 for name in KERNELS}
_libs: dict = {}


def count(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for src in (KERNELS[name][0],) + HEADERS:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD, f"{name}-{h.hexdigest()[:16]}.so")


def build(names=None) -> dict:
    """Compile the named kernels (default all) that are not built yet.

    One nvcc per source, all running at once. Returns {name: seconds} for
    what was compiled. Raises RuntimeError with nvcc's output if any build
    fails.
    """
    names = list(KERNELS) if names is None else list(names)
    todo = [n for n in names if not os.path.exists(_lib_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        cmd = [nvcc, *NVCC_FLAGS, "-o", out + ".tmp",
               os.path.join(CSRC, KERNELS[n][0])]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
    times, errors = {}, []
    for n, proc in procs.items():
        log, _ = proc.communicate()
        times[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{n}: nvcc exit {proc.returncode}\n"
                          + log.decode(errors="replace"))
        else:
            out = _lib_path(n)
            os.replace(out + ".tmp", out)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return times


def function(name: str, symbol: str, argtypes: list):
    """The C entry point `symbol` of kernel `name`, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_lib_path(name))
        _libs[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a nonzero cudaGetLastError()."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def require_cuda(name: str, dtype, *tensors) -> None:
    """The checks every launching wrapper makes on its tensor arguments:
    on the card, of the word type `dtype`, contiguous."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, expected cuda")
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")
