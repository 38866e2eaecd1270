"""K1 (`ntt`, fhebench/roofline/ntt.py) against its roofline alone: the
least time of its launches in the window over their measured device time,
from the same per-kernel sums of the trace as kernels_roofline (each
launch's bytes over the memory peak or int32 multiplies over the multiply
rate, whichever is larger). Read only where the trace's K1 launches were
recorded with their shapes (TraceSummary.bound_of_traced)."""


def read(w, name):
    t = w.trace
    if t is None or not t.port_ns.get("ntt") or t.bound_of_traced() is None:
        return None
    traced = t.port_count["ntt"]
    bound = t.bound_s["ntt"] * traced / t.call_count["ntt"]
    return 100.0 * bound / (t.port_ns["ntt"] / 1e9)
