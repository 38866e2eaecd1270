"""The port's kernels against their roofline: the sum of the least times
of their launches in the window (fhebench/roofline/, each launch's bytes
over the memory peak or int32 multiplies over the multiply rate,
whichever is larger) over the sum of their measured device times. Read
only where the launches in the trace were recorded with their shapes
(TraceSummary.bound_of_traced)."""

import sys


def read(w, name):
    t = w.trace
    bound = None if t is None else t.bound_of_traced()
    measured = 0 if bound is None else sum(t.port_ns.values()) / 1e9
    if not measured:
        return None
    for kernel in sorted(t.bound_s):
        by = "/".join(sorted(t.bound_by[kernel]))
        print(f"{name}: {kernel} {t.call_count[kernel]} launches, bound "
              f"{t.bound_s[kernel]!r} s by {by}, measured "
              f"{t.port_ns[kernel] / 1e9!r} s", file=sys.stderr)
    return 100.0 * bound / measured
