"""ct_pt_dot (csrc/ct_pt_dot.cu): every part and the plaintext rows read
once, the output written once; per output word one 128-bit product a
term and one reduction a window of terms (chip_smoke.py dot_case)."""

from fhebench.roofline.peaks import HI, LO, RED128

TRACE = r"\bct_pt_dot_kernel\b"
PATCH = ("tpufhe_torch.ops.dot", "ct_pt_dot_cuda")


def shape(ctx, parts, db) -> dict:
    # the products summed in 128 bits before a reduction (ops/dot.py
    # dot_window): min over the moduli of 2^(2 leading zeros) - 2
    window = max(1, min(1 << (2 * (64 - q.bit_length()))
                        for q in ctx.moduli) - 2)
    return {"parts": len(parts), "terms": db.shape[0], "cols": db.shape[1],
            "r": db.shape[2], "b": parts[0].shape[1], "n": ctx.degree,
            "window": window}


def cost(d: dict) -> tuple:
    p, n, m, r, b, deg = (d["parts"], d["terms"], d["cols"], d["r"], d["b"],
                          d["n"])
    outs = p * m * b * r * deg
    windows = -(-n // min(d["window"], n))
    return ((p * n * b * r * deg + n * m * r * deg + outs) * 8,
            outs * (n * (LO + HI) + windows * RED128))
