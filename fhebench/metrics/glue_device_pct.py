"""The share of the device's busy time spent in operations that are not
the port's own kernels (torch's elementwise kernels, gathers and copies),
from the profiler's device trace of the window."""


def read(w, name):
    t = w.trace
    if t is None or not t.dev_ns:
        return None
    return 100.0 * t.other_ns / t.dev_ns
