"""ks_accumulate (csrc/ks_accumulate.cu): the digits and addends read
once, the two outputs written once, the key read once; two Shoup products
a digit word (chip_smoke.py ks_case)."""

from fhebench.roofline.peaks import SHOUP, SHOUP32

TRACE = r"\bks_(accumulate|digits)_kernel\b"
PATCH = ("tpufhe_torch.pipeline", "ks_accumulate_cuda")


def shape(ctx, d, key, add0=None, add1=None) -> dict:
    return {"k": ctx.k, "n": ctx.degree, "digits": d.shape[0],
            "plane": d[0].numel(), "word_bytes": d.element_size(),
            "addends": sum(t is not None for t in (add0, add1)),
            "narrow": bool(ctx.narrow)}


def cost(d: dict) -> tuple:
    shoup = SHOUP32 if d["narrow"] else SHOUP
    plane, digits = d["plane"], d["digits"]
    words = plane * (digits + d["addends"] + 2) + 4 * digits * d["k"] * d["n"]
    return words * d["word_bytes"], plane * digits * 2 * shoup
