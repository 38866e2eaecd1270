"""K1 (csrc/ntt.cu): each row read and written once, plus its twiddle
table; a Shoup product per butterfly (chip_smoke.py k1_case)."""

from fhebench.roofline.peaks import ntt_ops

TRACE = r"\bntt_(row|split)_kernel\b"
PATCH = ("tpufhe_torch.ops.ntt", "ntt_cuda")


def shape(x, tables, sl, inverse, lazy=False) -> dict:
    return {"words": x.numel(), "k_sel": x.shape[-2], "n": x.shape[-1],
            "inverse": bool(inverse)}


def cost(d: dict) -> tuple:
    n = d["n"]
    return (2 * d["words"] * 8 + 2 * d["k_sel"] * n * 8,
            d["words"] // n * ntt_ops(n, d["inverse"]))
