"""The device milliseconds of make_mul_relin's `mul_relin.relin` stage:
the relinearization tail after the down-scale (K4 on the fused route; the
decomposition rows of c2, one K1 forward of the stacked rows and
ks_accumulate where kernels.tail_fits is false). Its device interval (CUDA
events on the kernels' stream at the stage's ends) in each `mul_relin`
step, as the median over the window's steps. The interval includes any
time the device idles inside the stage, waiting for the host. With
tensor_ms, one of the two stages the route rule chooses between."""

from fhebench.metrics._spans import stage_ms


def read(w, name):
    return stage_ms("mul_relin", "mul_relin.relin")
