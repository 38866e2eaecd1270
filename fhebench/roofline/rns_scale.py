"""K2 (csrc/rns_scale.cu): the input rows read and the output rows
written once; the HPS scaler's products (chip_smoke.py k2_case)."""

from fhebench.roofline.peaks import scale_ops

TRACE = r"\brns_scale_(fixed|general)_kernel\b"
PATCH = ("tpufhe_torch.ops.rns:RnsScaler", "scale_cuda")


def shape(scaler, x, start, size) -> dict:
    return {"words": x.numel(), "k_in": x.shape[-2], "size": size,
            "word_bytes": x.element_size(),
            "is_one": bool(scaler.factor.is_one)}


def cost(d: dict) -> tuple:
    coeffs = d["words"] // d["k_in"]
    return ((d["words"] + coeffs * d["size"]) * d["word_bytes"],
            scale_ops(d["is_one"], d["k_in"], d["size"], coeffs))
