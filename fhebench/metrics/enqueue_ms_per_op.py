"""Host milliseconds the program spends enqueueing an operation's device
work: the host time inside its top-level spans that issue the work and do
not wait on the device (inner products: ct_mul_pt and inner_sum; MulPIR:
expand, pir_response and switch_to_level), summed over the window and
divided by the operations. Set beside the device's busy time per
operation, it says whether the host sets the pace."""

from fhebench.metrics._spans import recording, top_ms

SPANS = {"ip": ("ct_mul_pt", "inner_sum"),
         "q16": ("expand", "pir_response", "switch_to_level")}


def read(w, name):
    rec = recording()
    names = SPANS.get(name.partition(".")[2])
    if rec is None or names is None or not w.ops:
        return None
    return top_ms(rec, names) / w.ops or None
