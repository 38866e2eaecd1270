"""ks_tail (csrc/relin_tail.cu): c2's d digit rows read, the key (d rows
over the key context's k limbs) read once, the two outputs written, the
tables; per (row, limb) d digit transforms and Shoup products
(chip_smoke.py ks_tail_case)."""

from fhebench.roofline.peaks import ks_digit_ops

TRACE = r"\bks_tail_kernel\b"
PATCH = ("tpufhe_torch.pipeline", "ks_tail_cuda")


def shape(ctx, c2_pb, ksk) -> dict:
    d, n = c2_pb.shape[-2:]
    return {"words": c2_pb.numel(), "d": d, "k": ctx.k, "n": n,
            "moduli": tuple(ctx.moduli)}


def cost(d: dict) -> tuple:
    k, n, dd = d["k"], d["n"], d["d"]
    rows = d["words"] // (dd * n)
    return ((d["words"] + 4 * dd * k * n + 2 * k * n + 2 * rows * k * n) * 8,
            rows * k * dd * ks_digit_ops(d["moduli"], n))
