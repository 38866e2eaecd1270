"""K4 (csrc/relin_tail.cu): the three scaled parts read, the key read
once (it stays in L2), the two outputs written, the tables; per (row,
limb) k digit rows and the forward transforms of c0 and c1 (chip_smoke.py
k4_case)."""

from fhebench.roofline.peaks import ks_digit_ops, ntt_ops

TRACE = r"\brelin_tail_kernel\b"
PATCH = ("tpufhe_torch.pipeline", "relin_tail_cuda")


def shape(ctx, dsc, key) -> dict:
    k, n = dsc.shape[-2:]
    return {"b": dsc[0].numel() // (k * n), "k": k, "n": n,
            "moduli": tuple(ctx.moduli)}


def cost(d: dict) -> tuple:
    b, k, n = d["b"], d["k"], d["n"]
    return ((5 * b * k * n + 4 * k * k * n + 2 * k * n) * 8,
            b * k * (k * ks_digit_ops(d["moduli"], n) + 2 * ntt_ops(n, False)))
