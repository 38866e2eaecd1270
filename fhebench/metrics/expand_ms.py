"""The median per call of the benchmark's span around make_expand's
step, ending on a synchronize (host clock)."""

from fhebench.metrics._stats import median


def read(w, name):
    return median(w.spans.get("expand", []))
