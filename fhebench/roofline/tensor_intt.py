"""K3 (csrc/tensor_intt.cu): the four extended parts read, the three
products written, the tables; per (row, limb) the tensor products and
three inverse transforms (chip_smoke.py k3_case)."""

from fhebench.roofline.peaks import TENSOR_OPS, ntt_ops

TRACE = r"\btensor_intt_kernel\b"
PATCH = ("tpufhe_torch.pipeline", "tensor_intt_cuda")


def shape(ctx_mul, ext) -> dict:
    k_mul, n = ext.shape[-2:]
    return {"rows": ext[0].numel() // (k_mul * n), "k_mul": k_mul, "n": n}


def cost(d: dict) -> tuple:
    rows, k, n = d["rows"], d["k_mul"], d["n"]
    return ((7 * rows * k * n + 2 * k * n) * 8,
            rows * k * (n * TENSOR_OPS + 3 * ntt_ops(n, True)))
