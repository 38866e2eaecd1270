"""The device milliseconds of make_mul_relin's `mul_relin.tensor` stage:
the tensor product and its inverse NTT over the multiplication basis (K3
on the fused route; K7 and the K1 inverse where kernels.tail_fits is
false). Its device interval (CUDA events on the kernels' stream at the
stage's ends) in each `mul_relin` step, as the median over the window's
steps. The interval includes any time the device idles inside the stage,
waiting for the host. With relin_ms, one of the two stages the route rule
chooses between."""

from fhebench.metrics._spans import stage_ms


def read(w, name):
    return stage_ms("mul_relin", "mul_relin.tensor")
