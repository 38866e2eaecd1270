"""K7 (csrc/tensor.cu): the parts read (twice for a square, four times
otherwise), the three products written; the tensor products of each word
(chip_smoke.py k7_case)."""

from fhebench.roofline.peaks import TENSOR_OPS

TRACE = r"\btensor_kernel\b"
PATCH = ("tpufhe_torch.pipeline", "tensor_cuda")


def shape(ctx, a0, a1, b0, b1) -> dict:
    return {"words": a0.numel(), "k": ctx.k,
            "reads": 2 if (b0 is a0 and b1 is a1) else 4}


def cost(d: dict) -> tuple:
    return (((d["reads"] + 3) * d["words"] + 3 * d["k"]) * 8,
            d["words"] * TENSOR_OPS)
