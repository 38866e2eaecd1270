"""K5 (csrc/rotate_tail.cu): s0 and c2 read, the key read once, the two
outputs written, the tables; per (row, limb) k digit rows (chip_smoke.py
k5_case)."""

from fhebench.roofline.peaks import ks_digit_ops

TRACE = r"\brotate_tail_kernel\b"
PATCH = ("tpufhe_torch.pipeline", "rotate_tail_cuda")


def shape(ctx, s0, c2_pb, key) -> dict:
    k, n = s0.shape[-2:]
    return {"b": s0.numel() // (k * n), "k": k, "n": n,
            "moduli": tuple(ctx.moduli)}


def cost(d: dict) -> tuple:
    b, k, n = d["b"], d["k"], d["n"]
    return ((4 * b * k * n + 4 * k * k * n + 2 * k * n) * 8,
            b * k * k * ks_digit_ops(d["moduli"], n))
