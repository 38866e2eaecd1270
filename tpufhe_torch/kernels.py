"""Build, load and count the hand-written CUDA kernels.

Each kernel is a source in ``tpufhe_torch/csrc/`` with a plain C entry
point (ks_tail's is in relin_tail.cu, beside K4's, whose body it shares).
It is compiled at first use with nvcc for ``sm_90a`` into
``tpufhe_torch/_build/`` (named by the kernel and a hash of its sources, so
an edited source is rebuilt) and loaded with ctypes. ``build()`` compiles
every kernel at once, one nvcc process per kernel, all started together.

Every wrapper launches its kernel through ``launch``, the one place a
launch happens: it counts the launch (``LAUNCHES``, so a run can show which
kernels a path went through), passes the current stream and raises on a
launch error.
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
    # tpufhe's rns_scale_pallas takes _scale_kernel_bc where every output
    # modulus is above k_in 2^57 (rns_kernel.py:589-597), else _scale_kernel
    # (e.g. default_parameters_128's 43-44-bit moduli); both compute the
    # same function
    "rns_scale": ("rns_scale.cu",
                  "tpufhe/ops/pallas/rns_kernel.py:361 _scale_kernel_bc and"
                  " :243 _scale_kernel"),
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
    # no Pallas counterpart: tpufhe's deferred 128-bit ct x pt accumulation
    # is XLA code (also rq.dot_product, tpufhe/ops/rq.py:1337)
    "ct_pt_dot": ("ct_pt_dot.cu",
                  "tpufhe/pipeline.py:1091 make_ct_pt_dot (XLA)"),
    # no Pallas counterpart: the distributed NTT's cross-shard step is XLA
    # code around tpufhe's all_to_all
    "ntt_dist": ("ntt_dist.cu",
                 "tpufhe/parallel/ntt_dist.py:62-96 _block_matmul_left, "
                 "_fold_reduce and _psum_blocks_mod (XLA)"),
    # the key switch alone: d digit rows over k >= d limbs, no adds; its
    # own entry so that the launch counts tell it from K4
    "ks_tail": ("relin_tail.cu",
                "tpufhe/ops/pallas/mxu_ntt_kernel.py:464 _relin_tail_kernel"
                " (mode ks_only)"),
    # no Pallas counterpart: the glue's 62-bit products (ops/zq.py mul and
    # mul_shoup on the card) are XLA code in tpufhe
    "zq_mul": ("zq_mul.cu",
               "tpufhe/ops/zq.py mul_mod and mul_shoup (XLA)"),
    # no Pallas counterpart: the expansion's fold (the add after a leveled
    # key switch, the subtractions, the products by the monomial and the
    # concatenation) is XLA code in tpufhe
    "expand_fold": ("expand_fold.cu",
                    "tpufhe/pipeline.py:843 build_expand_step (XLA)"),
    # no Pallas counterpart: the wire codec's residue transcode, both
    # directions in one source, each its own entry so that the launch
    # counts tell them apart
    "rq_pack": ("rq_pack.cu",
                "none: tpufhe's host transcode (tpufhe/utils/transcode.py, "
                "serialize/codecs.py)"),
    "rq_unpack": ("rq_pack.cu",
                  "none: tpufhe's host transcode (tpufhe/utils/transcode.py, "
                  "serialize/codecs.py)"),
}
HEADERS = ("modarith.cuh", "ntt_pass_device.cuh", "keyswitch_device.cuh",
           "rns_scale_device.cuh")
# Shared memory one block may use on sm_90 (dynamic, above the 48 KB default);
# the NTT-based kernels hold whole rows of N words in it (8 bytes a word,
# 4 for the narrow rows of ntt32).
SMEM_BYTES = 232448


def tail_fits(n: int, word_bytes: int = 8) -> bool:
    """The route rule: whether the programs over degree n run the fused
    kernels K3, K4 and K5 (three rows of n words fit one block's shared
    memory, the need of K3's first design). Where it is false (N = 16384)
    they take the unfused composition (K7, K1 and ks_accumulate in place
    of K3, K4 and K5), as tpufhe does where its tail kernel does not fit.
    No kernel needs three rows a block any more: K3, K4 and K5 hold one row
    a CTA; the route stays until the fused kernels are timed against the
    unfused ones at N = 16384. The benchmark's cell mulrelin-n16384-b16
    (fhebench/, BASELINE config 5's ring) measures the unfused route: its
    metrics tensor_ms.n16k and relin_ms.n16k read the two stages the rule
    chooses between (make_mul_relin's spans mul_relin.tensor and
    mul_relin.relin), the yardstick of a measured rule."""
    return 3 * n * word_bytes <= SMEM_BYTES


# The transform passes (csrc/ntt_pass_device.cuh): PASS_STAGES butterfly
# stages a pass in registers. K1 holds at most NTT_ROW_MAX words of a row a
# CTA (64 KB, so three CTAs share an SM); a longer row is split across a
# cluster of two CTAs. K1, K3 and the tails run at most NTT_THREADS threads
# a CTA.
PASS_STAGES = 2
NTT_ROW_MAX = 8192
NTT_THREADS = 512
# K9 (csrc/ntt32.cu): the narrow rows' passes, NARROW_PASS_STAGES stages a
# pass, one CTA of at most NTT32_THREADS threads a row of 4-byte words (32 KB
# at n = 8192, six CTAs an SM).
NARROW_PASS_STAGES = 3
NTT32_THREADS = 256
# K8 (csrc/intt_scale.cu): a cluster per batch row of at most K8_CLUSTER_MAX
# CTAs, CTA r holding the row's limbs r, r + C, ..., at most K8_THREADS
# threads a CTA; its fixed shape (3 limbs of 8192 words) runs a pair of CTAs
# of K8_SPLIT_THREADS threads, each holding half of every limb (96 KB, two
# CTAs an SM).
K8_CLUSTER_MAX = 8
K8_THREADS = 256
K8_SPLIT_THREADS = 512
# The tails' clusters (csrc/keyswitch_device.cuh): at most TAIL_CLUSTER_MAX
# CTAs, above 8 the card's non-portable cluster size.
TAIL_CLUSTER_MAX = 16
# K3's cluster: one CTA per output part (csrc/tensor_intt.cu)
K3_PARTS = 3


def ntt_passes(stages: int, first: int = 0,
               per: int = PASS_STAGES) -> list[tuple[int, int]]:
    """(first stage, stages) of each forward pass over the stages first ..
    first + stages - 1: one pass of stages mod per stages, then per a pass
    (PASS_STAGES, or NARROW_PASS_STAGES for K9). A whole row of 2^logn
    words runs ntt_passes(logn); the inverse runs the same passes in
    reverse order."""
    lead = stages % per
    return ([(first, lead)] if lead else []) + [
        (s0, per) for s0 in range(first + lead, first + stages, per)]


def ntt_split(n: int) -> bool:
    """Whether K1 splits a row of n words across a cluster of two CTAs."""
    return n > NTT_ROW_MAX


def _forward_unit(s0: int, s: int, g: int, half: int | None = None
                  ) -> list[int]:
    """The bit-reversed omega indices of one forward unit of pass (s0, s)
    in stage-s0 group g: stage s0 + r's j-th, 2^(s0+r) + g 2^r + j. In half
    `half` of a split row, the half's stage s0 + r is the row's stage
    s0 + r + 1, whose groups in that half start at half 2^(s0+r)."""
    out = []
    for r in range(s):
        stage, group = s0 + r, g << r
        if half is not None:
            group += half << stage
            stage += 1
        out.extend((1 << stage) + group + j for j in range(1 << r))
    return out


def _inverse_unit(n: int, logn: int, s0: int, s: int, g: int,
                  halves: int = 1, rank: int = 0) -> list[int]:
    """The bit-reversed zeta_inv indices of one inverse unit of pass
    (s0, s) over a row (or half row, halves = 2) of 2^logn words, in
    stage-s0 group g: inverse stage ls + r (ls = logn - s0 - s), of
    m = 2^logn / 2^(ls+r+1) groups a row part, pairs unit words t and
    t + 2^r under group g 2^(s-1-r) + t / 2^(r+1), at
    n - 2 m halves + rank m + that group."""
    ls = logn - s0 - s
    out = []
    for r in range(s):
        m = (1 << logn) >> (ls + r + 1)
        out.extend(n - 2 * m * halves + rank * m + (g << (s - 1 - r)) + j
                   for j in range(1 << (s - 1 - r)))
    return out


def forward_twiddle_order(n: int, split: bool | None = None,
                          per: int = PASS_STAGES) -> list[int]:
    """Indices into a limb's bit-reversed omegas in the order K1's, K4's,
    K5's and (per = NARROW_PASS_STAGES) K9's forward passes read them
    (csrc/ntt_pass_device.cuh): per pass (s0, S) of ntt_passes(logn, 0,
    per) and stage-s0 group g, the 2^S - 1 twiddles of the group's unit.
    Split (default: ntt_split(n)): omega 1 (stage 0), then for each half
    r its stage-1 omega 2 + r and the passes of its own stages
    (ntt_passes(logn - 2, 1) over the half). Every index 1 .. n - 1 once,
    then 0 to pad the table to n entries."""
    logn = n.bit_length() - 1
    split = ntt_split(n) if split is None else split
    if not split:
        order = [i for s0, s in ntt_passes(logn, 0, per)
                 for g in range(1 << s0) for i in _forward_unit(s0, s, g)]
        return order + [0]
    order = [1]
    for rank in (0, 1):
        order.append(2 + rank)
        for s0, s in ntt_passes(logn - 2, 1):
            for g in range(1 << s0):
                order.extend(_forward_unit(s0, s, g, rank))
    return order + [0]


def inverse_twiddle_order(n: int, split: bool | None = None,
                          per: int = PASS_STAGES) -> list[int]:
    """Indices into a limb's bit-reversed zetas_inv in the order K1's, K3's,
    K8's and (per = NARROW_PASS_STAGES) K9's inverse passes read them: the
    forward schedule's passes in reverse order, per stage-s0 group g the
    2^S - 1 twiddles of the unit's Gentleman-Sande stages. Split (K1 at
    N = 16384, K8's pair): the twiddles of the last two stages
    (n - 4, n - 3 within the halves, n - 2 across), then for each half its
    own passes (ntt_passes(logn - 2, 1) in reverse). Every index 0 .. n - 2
    once, then n - 1 to pad the table to n entries."""
    logn = n.bit_length() - 1
    split = ntt_split(n) if split is None else split
    if not split:
        order = [i for s0, s in reversed(ntt_passes(logn, 0, per))
                 for g in range(1 << s0)
                 for i in _inverse_unit(n, logn, s0, s, g)]
        return order + [n - 1]
    order = [n - 4, n - 3, n - 2]
    for rank in (0, 1):
        for s0, s in reversed(ntt_passes(logn - 2, 1)):
            for g in range(1 << s0):
                order.extend(_inverse_unit(n, logn - 1, s0, s, g, 2, rank))
    return order + [n - 1]


def ntt_plan(n: int) -> tuple[int, int, int]:
    """K1's launch plan at degree n: (CTAs per cluster, threads per CTA,
    shared bytes per CTA). One CTA per row up to NTT_ROW_MAX words, a
    cluster of two holding half a row each above."""
    if n > 2 * NTT_ROW_MAX:
        raise ValueError(f"ntt: degree {n} does not fit two CTAs")
    cluster = 2 if ntt_split(n) else 1
    return cluster, max(1, min(n // 4, NTT_THREADS)), 8 * n // cluster


def tensor_intt_plan(n: int) -> tuple[int, int, int]:
    """K3's launch plan at degree n: (CTAs per cluster, threads per CTA,
    shared bytes per CTA): one CTA per output part, one row each."""
    return K3_PARTS, max(1, min(n // 4, NTT_THREADS)), 8 * n


def coefficient_shares(n: int, parts: int) -> list[tuple[int, int]]:
    """The coefficients [lo, hi) that each of `parts` CTAs of a cluster
    takes, in whole 32-word pieces (csrc/tensor_intt.cu, intt_scale.cu)."""
    span = (-(-n // parts) + 31) & ~31
    return [(min(n, r * span), min(n, (r + 1) * span)) for r in range(parts)]


def tensor_intt_thirds(n: int) -> list[tuple[int, int]]:
    """The coefficients [lo, hi) whose products each CTA of a K3 cluster
    forms."""
    return coefficient_shares(n, K3_PARTS)


def ntt32_plan(n: int) -> tuple[int, int, int]:
    """K9's launch plan at degree n: (CTAs per cluster, threads per CTA,
    shared bytes per CTA): one CTA a row, a thread a unit of
    2^NARROW_PASS_STAGES words at most."""
    return 1, max(1, min(n >> NARROW_PASS_STAGES, NTT32_THREADS)), 4 * n


def intt_scale_split(k_in: int, n: int) -> bool:
    """Whether K8 splits the row across a pair of half-row CTAs: its fixed
    shape, 3 limbs of 8192 words."""
    return k_in == 3 and n == 8192


def intt_scale_plan(k_in: int, n: int) -> tuple[int, int, int]:
    """K8's launch plan for k_in limbs of degree n: (CTAs per cluster,
    threads per CTA, shared bytes per CTA). A cluster per batch row; CTA r
    of its C = min(k_in, K8_CLUSTER_MAX) holds the limbs r, r + C, ...,
    and finishes the scale of its share of the coefficients
    (coefficient_shares(n, C)). Split (intt_scale_split): C = 2, CTA h
    holding half h of every limb and scaling the coefficients of that
    half."""
    if intt_scale_split(k_in, n):
        return 2, K8_SPLIT_THREADS, 4 * n * k_in
    cluster = min(k_in, K8_CLUSTER_MAX)
    limbs = -(-k_in // cluster)
    return cluster, max(1, min(n // 4, K8_THREADS)), 8 * n * limbs


def tail_plan(rows: int, n: int) -> tuple[int, int, int]:
    """Launch plan of the key-switch tails K4 (rows = k + 2 transformed
    rows per batch row and limb), K5 (rows = k) and ks_tail (rows = d, its
    digit rows): (CTAs per cluster, threads per CTA, shared bytes per CTA).
    One CTA per row; above TAIL_CLUSTER_MAX rows the cluster takes them in
    rounds."""
    return (min(rows, TAIL_CLUSTER_MAX), max(1, min(n // 2, NTT_THREADS)),
            8 * n)


NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {name: 0 for name in KERNELS}
_libs: dict = {}
# (kernel, symbol) -> (library, typed entry point)
_entries: dict = {}


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
    """The C entry point `symbol` of kernel `name`, building it if needed;
    its argument types are set once for each library loaded under `name`."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_lib_path(name))
        _libs[name] = lib
    entry = _entries.get((name, symbol))
    if entry is None or entry[0] is not lib:
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        entry = _entries[(name, symbol)] = (lib, fn)
    return entry[1]


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a nonzero cudaGetLastError()."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def launch(name: str, symbol: str, argtypes: list, *args) -> None:
    """Launch kernel `name` through its C entry point `symbol`: count the
    launch, call the entry point with args and the current stream, and
    raise if it returned a nonzero cudaGetLastError()."""
    fn = function(name, symbol, argtypes)
    count(name)
    check(fn(*args, stream()), name)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def require_cuda(name: str, dtype, *tensors, contiguous: bool = True) -> None:
    """The checks every launching wrapper makes on its tensor arguments:
    on the card, of the word type `dtype`, contiguous (unless the kernel
    takes strided views)."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, expected cuda")
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")
